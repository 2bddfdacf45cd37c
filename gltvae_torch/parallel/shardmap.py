"""Explicit data parallelism with per-rank noise (counterpart of
gltvae/parallel/shardmap.py).

``parallel.dp`` keeps the one-device step's draws: every rank draws the
global batch's noise and keeps its rows. This variant is the classic
per-replica RNG scheme: each rank draws noise for its own rows only, from
the step's generator seed folded with the rank, and the gradients, loss
and metrics are averaged over the ranks (the ``pmean`` of
gltvae's shard_map). Both are valid DP samplings; this one differs from
the one-device run at the same global batch by its draws, so it is held
to that run statistically (tests/test_torch_dp.py: loss within 5%, params
within 2·lr), not bit for bit. Like gltvae's jitted shard_map step, the
steps are captured where ``make_train_steps``' are: the host part draws
this rank's raw variates into the graph's static buffers, and the graph
turns the gate uniforms into Gumbels.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from gltvae_torch.parallel.dp import DataParallel
from gltvae_torch.parallel.mesh import Mesh
from gltvae_torch.train.state import TrainState, step_seed
from gltvae_torch.train.steps import draw_noise, make_train_steps


class _RankNoise(DataParallel):
    """DataParallel whose noise is drawn per rank."""

    def draws(self, state: TrainState, b: int, supervised: bool, k: int,
              noise: Optional[dict] = None, out: Optional[dict] = None,
              **kw) -> dict:
        """`noise` when given (this rank's own), else this rank's draws
        from the step's seed folded with the rank (into `out` when given;
        ``draw_noise``, which takes `kw`)."""
        if noise is not None:
            return noise
        gen = torch.Generator(device=state.device)
        gen.manual_seed(step_seed(step_seed(state.seed, state.step),
                                  self.mesh.rank))
        return draw_noise(state.model, b, supervised, k, gen, out=out, **kw)

    def rows_of(self, noise: dict) -> dict:
        """The draws are this rank's own already."""
        return noise


def make_shardmap_train_steps(model, train_cfg, mesh: Mesh,
                              jit: Optional[bool] = None
                              ) -> Tuple[Callable, Callable]:
    """(sup_step, unsup_step) with per-rank noise and explicitly averaged
    gradients; the signatures of ``make_train_steps`` (x, y this rank's
    rows), captured by its rule (``steps.resolve_jit``: by default on an
    NCCL mesh of any size and on the CPU, never on gloo over CUDA)."""
    return make_train_steps(model, train_cfg, dp=_RankNoise(mesh), jit=jit)
