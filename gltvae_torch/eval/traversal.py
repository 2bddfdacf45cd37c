"""Batched latent traversal (counterpart of gltvae/eval/traversal.py).

A sweep over D latent dimensions and S values is one decoder call: the
(D·S, z) grid, whose row (d, s) is ``z_base`` with dimension ``dims[d]``
set to the s-th sweep value, is built by broadcasting and a one-hot and
decoded as one batch (45·8 = 360 images for the CelebA-64 model). It runs
under ``torch.no_grad()`` on the model's device.

Like gltvae's ``@jax.jit def traverse``, the decode is captured by
default (``train/steps.py::resolve_jit``): on a CUDA device the grid and
the decode are one CUDA graph (``CapturedTraversal``), captured at the
first call over a static (z,) ``z_base`` and replayed at each; the one-hot
of ``dims`` and the sweep values are device constants made before the
capture. On the CPU the same static-buffer path runs eagerly, and
``jit=False`` gives the eager decode.

The sweep values come from ``torch.linspace`` on the CPU, so they are the
same on every device; they may differ from ``jnp.linspace``'s in the last
ulp, which moves no image by more than the 1e-5 the tests hold.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from gltvae_torch.train.graphs import Captured, graph_pool
from gltvae_torch.train.steps import resolve_jit


def _grid(z_base: torch.Tensor, onehot: torch.Tensor,
          values: torch.Tensor) -> torch.Tensor:
    """[D·S, z] traversal grid from the (D, z) one-hot of the dims."""
    D, S, z_dim = onehot.shape[0], values.shape[0], z_base.shape[-1]
    z = z_base.expand(D, S, z_dim)
    onehot = onehot[:, None, :]
    z = z * (1.0 - onehot) + values[None, :, None] * onehot
    return z.reshape(D * S, z_dim)


def _build_grid(z_base: torch.Tensor, dims: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """[D·S, z] traversal grid. z_base: (z,) anchor; dims: (D,) integer;
    values: (S,) sweep values. Row d·S + s is z_base with z[dims[d]] :=
    values[s]."""
    return _grid(z_base, F.one_hot(dims.long(), z_base.shape[-1])
                 .to(z_base.dtype), values)


class CapturedTraversal(Captured):
    """A traversal's grid and decode as one program: ``decode(model,
    z_base) -> images`` on the static (z,) ``z_base``. Bound to its model,
    as an eval pass is: the graph reads the parameters in place, another
    model raises, and the images come back as a new tensor."""

    owner_kind = 'model'

    def __init__(self, decode: Callable, z_dim: int, device: torch.device):
        super().__init__(device, graph_pool(device))
        self.decode = decode
        self.z_base = self.buffer((z_dim,), torch.float32)

    def batches(self) -> List[torch.Tensor]:
        return []

    def _run(self, model) -> Dict[str, torch.Tensor]:
        return {'images': self.decode(model, self.z_base)}


def make_traversal_fn(model, n_steps: int = 8, lo: float = -3.0,
                      hi: float = 3.0, dims: Optional[Sequence[int]] = None,
                      jit: Optional[bool] = None):
    """Returns traverse(z_base) -> (D, S, H, W, C) images, one batched
    decode of the D·S grid with `model`'s parameters on its device. `dims`
    defaults to every latent dimension. With `jit` (the default) the grid
    and decode are a ``CapturedTraversal`` bound to `model`; ``jit=False``
    decodes eagerly."""
    device = model.mu.device
    dims_t = torch.as_tensor(
        list(dims) if dims is not None else range(model.cfg.z_dim),
        dtype=torch.int64, device=device)
    values = torch.linspace(lo, hi, n_steps, dtype=torch.float32).to(device)
    onehot = F.one_hot(dims_t, model.cfg.z_dim).to(torch.float32)

    def decode(m, z_base: torch.Tensor) -> torch.Tensor:
        imgs = m.decode(_grid(z_base, onehot, values))
        return imgs.reshape(dims_t.shape[0], n_steps, *imgs.shape[1:])

    if not resolve_jit(jit, None):
        @torch.no_grad()
        def traverse(z_base: torch.Tensor) -> torch.Tensor:
            return decode(model, z_base.to(device, torch.float32))
        return traverse

    program = CapturedTraversal(decode, model.cfg.z_dim, device)

    @torch.no_grad()
    def traverse(z_base: torch.Tensor) -> torch.Tensor:
        program.z_base.copy_(z_base)
        return program(model)['images']
    return traverse


@torch.no_grad()
def latent_traversal(model, x: Optional[torch.Tensor] = None,
                     z_base: Optional[torch.Tensor] = None,
                     n_steps: int = 8, lo: float = -3.0, hi: float = 3.0,
                     dims: Optional[Sequence[int]] = None,
                     jit: Optional[bool] = None) -> torch.Tensor:
    """Render the sweep grid anchored on `z_base`, else on the posterior
    mean of the first image of `x` (NHWC float in [0, 1]), else on z = 0
    (``make_traversal_fn``'s `jit`: captured by default)."""
    device = model.mu.device
    if z_base is None:
        if x is not None:
            locs, _ = model.encode(x.to(device))
            z_base = locs[0]
        else:
            z_base = torch.zeros(model.cfg.z_dim, device=device)
    return make_traversal_fn(model, n_steps=n_steps, lo=lo, hi=hi,
                             dims=dims, jit=jit)(z_base)
