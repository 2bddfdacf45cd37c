"""Data-parallel train and eval steps over a mesh of ranks (counterpart of
gltvae/parallel/dp.py).

The DP step equals one device at the same global batch B: the state is
replicated, rank r owns the global rows [r·B/D, (r+1)·B/D), and every rank
draws the global batch's noise from the one per-step generator
(``TrainState.next_generator``) and keeps its own rows (``eps_z``, ``u_y``
on axis 0, ``eps_k`` on axis 1; the gate Gumbels ``g1``, ``g2`` whole).
The loss, ``mean(-elbo) + gating_reg·mean(|μ|)``, mixes no rows (the
k-sample logsumexp is per example), so the mean over ranks of the local
gradients is the global batch's gradient: one ``all_reduce`` SUM of one
flat buffer of the gradients and the metrics, then ÷ D (gloo has no AVG);
``c_nan`` is reduced as a MAX. At D = 1 every value passes through
unchanged, so a mesh of one equals no mesh bit for bit.

``DataParallel(mesh)`` carries that: every step maker of train/steps.py
takes it as ``dp``, so gltvae's ``make_parallel_train_steps`` is
``make_train_steps(model, cfg, dp=DataParallel(mesh))``, and so on for the
chunk, resident, eval and ELBO makers. With it
- eval draws the global batch's eval noise and keeps its rows; accuracy is
  the mean of the all-gathered per-label matches, the global batch's value
  bit for bit wherever a row's arithmetic does not depend on the rows run
  with it (the CPU here; on a card cuDNN may round a call of B/D rows
  otherwise than one of B: at bf16 on H100s, 9 of 448 inference rows of
  2 ranks sat a 4th decimal from one process's at B = 256, and equal to
  its rows at B = 128); the ELBO is the mean over ranks of the local
  means;
- a resident split lives as this rank's ⌈N/D⌉ rows (``place_resident_
  split``, padded with zero rows) and each dispatch exchanges only the rows
  its batches need (``gather_rows``: one all_reduce of a buffer where each
  rank writes the rows it holds), so the bytes equal the host-shipped
  batches'.

The makers capture these steps as they do one device's (gltvae jits its
parallel makers; ``steps.resolve_jit``'s rule): over NCCL, at every
world size, each rank's dispatch is one CUDA graph with its collectives
inside (``train/graphs.py``). For that the host part
(``draws``; an eval or ELBO pass's ``steps.draw_eval_noise`` and
``draw_noise`` with ``out=``) draws the global batch's raw variates into
global-size static buffers (the gates' uniforms, not their Gumbels), and
the device part turns the two gate uniforms into Gumbels in full (every
rank reads all of μ's Gumbels: ``steps.gate_gumbels``) and reads this
rank's rows of the rest as views (``rows_of``); ``average``,
``mean``, ``mean_rows`` and ``gather_rows`` read nothing back to the
host, so they run inside the graph as they are.

Batches arrive by one of two conventions (``shard_batch``,
``shard_stacked_batch``): ``local=False``, every rank gets the global batch
and keeps its rows; ``local=True``, a host-sharded loader
(``BatchLoader(shard=(rank, world))``) yields only this rank's rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gltvae_torch.parallel.mesh import Mesh
from gltvae_torch.train.state import TrainState
from gltvae_torch.train import steps as _steps


def slice_noise(noise: dict, rows: slice) -> dict:
    """This rank's rows of a global batch's draws (batch on axis 0, on axis
    1 for eps_k; the gate Gumbels whole)."""
    out = {}
    for k, v in noise.items():
        if k in ('g1', 'g2'):
            out[k] = v
        elif k == 'eps_k':
            out[k] = v[:, rows]
        else:
            out[k] = v[rows]
    return out


class DataParallel:
    """What a data-parallel step does that a one-device step does not (the
    ``dp`` argument of train/steps.py's makers)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def draws(self, state: TrainState, b: int, supervised: bool, k: int,
              noise: Optional[dict] = None, out: Optional[dict] = None,
              **kw) -> dict:
        """What a step's host part draws: the global batch's draws for `b`
        rows a rank, `noise` when given, else drawn from the step's
        generator (into `out`, buffers of the global shapes, when given;
        ``steps.draw_noise``, which takes `kw`)."""
        if noise is None:
            noise = _steps.draw_noise(state.model, b * self.mesh.world,
                                      supervised, k, state.next_generator(),
                                      out=out, **kw)
        return noise

    def rows_of(self, noise: dict) -> dict:
        """This rank's rows of `draws`' result, as views (what the device
        part reads)."""
        n = noise['eps_z'].shape[0]
        return slice_noise(noise, self.mesh.rows(n))

    def average(self, grads: Dict[str, torch.Tensor],
                metrics: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Gradients and metrics averaged over the ranks, ``c_nan`` any
        rank's: one all_reduce of one flat buffer."""
        keys = [k for k in metrics if k != 'c_nan']
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [metrics[k].reshape(1).to(torch.float32)
                            for k in keys]
                         + [metrics['c_nan'].reshape(1).to(torch.float32)])
        self.mesh.all_reduce_(flat)
        n = flat.numel() - len(keys) - 1
        mean = flat[:-1] / self.mesh.world
        out, at = {}, 0
        for name, g in grads.items():
            out[name] = mean[at:at + g.numel()].view_as(g)
            at += g.numel()
        met = {k: mean[n + i].to(metrics[k].dtype)
               for i, k in enumerate(keys)}
        met['c_nan'] = flat[-1] > 0
        return out, met

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """A 0-d local mean averaged over the ranks."""
        return self.mesh.all_reduce_(value.reshape(1).clone())[0] \
            / self.mesh.world

    def mean_rows(self, values: torch.Tensor) -> torch.Tensor:
        """The mean of the global batch's rows: this rank's gathered with
        the others' in rank order."""
        return torch.mean(self.mesh.all_gather(values))

    def resident_batches(self, rows: torch.Tensor,
                         labels: Optional[torch.Tensor],
                         idxs: torch.Tensor) -> List[tuple]:
        """This rank's (x, y) of each global index row of `idxs` [n, B],
        from its resident rows (``place_resident_split``) and the
        replicated labels (y None without labels)."""
        xs = gather_rows(self.mesh, rows, idxs)
        if labels is None:
            return [(x, None) for x in xs]
        mine = idxs[:, self.mesh.rows(idxs.shape[1])]
        return [(x, labels.index_select(0, i)) for x, i in zip(xs, mine)]

    def step_batches(self, sources, idxs) -> List[tuple]:
        """This rank's (x, y) of each step j, rows idxs[j] of the resident
        split sources[j] = (rows, labels): one exchange a split
        (``resident_batches``), in the order of the splits' first steps
        (the row gather of a resident program, ``graphs.index_rows`` on
        one device)."""
        groups = {}
        for j, src in enumerate(sources):
            groups.setdefault(id(src[0]), []).append(j)
        out = [None] * len(sources)
        for js in groups.values():
            images, labels = sources[js[0]]
            got = self.resident_batches(
                images, labels, torch.stack([idxs[j] for j in js]))
            for j, batch in zip(js, got):
                out[j] = batch
        return out


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's parameters and Adam moments on every rank, in place (one
    broadcast). The step, count and seed are the same on every rank by
    construction: the ranks build the state from one seed."""
    tensors = _state_tensors(state)
    flat = mesh.broadcast_(torch.cat([t.detach().reshape(-1)
                                      for t in tensors]))
    with torch.no_grad():
        at = 0
        for t in tensors:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
    return state


def replicas_agree(state: TrainState, mesh: Mesh) -> bool:
    """Whether every rank holds rank 0's state bit for bit (a collective)."""
    flat = torch.cat([t.detach().reshape(-1) for t in _state_tensors(state)])
    same = torch.equal(flat, mesh.broadcast_(flat.clone()))
    meta = torch.tensor([state.step, state.adam_count, state.seed],
                        dtype=torch.float64, device=mesh.device)
    same = same and torch.equal(meta, mesh.broadcast_(meta.clone()))
    bad = torch.tensor([0.0 if same else 1.0], device=mesh.device)
    return not bool(mesh.all_reduce_(bad, 'max')[0])


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    return (list(state.model.state_dict().values())
            + list(state.adam_m.values()) + list(state.adam_v.values()))


def _host_rows(a, mesh: Mesh, axis: int, local: bool):
    if local:
        return a
    idx = [slice(None)] * a.ndim
    idx[axis] = mesh.rows(a.shape[axis])
    return a[tuple(idx)]


def shard_batch(batch, mesh: Mesh, local: bool = False):
    """This rank's rows of a host batch (an array or a tuple of arrays,
    batch on the leading dim). ``local=True``: `batch` holds only this
    rank's rows already (a host-sharded loader's output)."""
    if isinstance(batch, tuple):
        return tuple(_host_rows(a, mesh, 0, local) for a in batch)
    return _host_rows(batch, mesh, 0, local)


def shard_stacked_batch(batch, mesh: Mesh, local: bool = False):
    """``shard_batch`` for stacked [n, B, ...] chunks: the chunk axis stays
    whole, B splits over the ranks."""
    if isinstance(batch, tuple):
        return tuple(_host_rows(a, mesh, 1, local) for a in batch)
    return _host_rows(batch, mesh, 1, local)


def place_resident_split(images: np.ndarray, labels: np.ndarray,
                         mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """A resident split on this rank: its ⌈N/D⌉ rows of `images` (the split
    padded to D·⌈N/D⌉ with zero rows, which no index names) and all the
    labels (small; each batch takes its rows of them)."""
    m = math.ceil(len(images) / mesh.world)
    mine = np.asarray(images[mesh.rank * m:(mesh.rank + 1) * m])
    if len(mine) < m:
        mine = np.concatenate([mine, np.zeros((m - len(mine),)
                                              + images.shape[1:],
                                              images.dtype)])
    x = torch.from_numpy(np.ascontiguousarray(mine)).to(mesh.device)
    y = torch.from_numpy(np.asarray(labels, np.float32)).to(mesh.device)
    return x, y


def gather_rows(mesh: Mesh, rows: torch.Tensor,
                idxs: torch.Tensor) -> torch.Tensor:
    """[n, B/D, ...]: this rank's rows of each global index row of `idxs`
    [n, B], from the ranks' resident rows (rank r holds global rows
    [r·M, (r+1)·M)). Each rank writes the rows it holds into an [n·B, ...]
    buffer of zeros and one all_reduce SUM completes it (one writer per
    row, so the bytes are exact)."""
    n, B = idxs.shape
    flat = idxs.reshape(-1)
    if mesh.group is None:
        got = rows.index_select(0, flat)
    else:
        m = rows.shape[0]
        local = flat - mesh.rank * m
        mine = (local >= 0) & (local < m)
        got = rows.index_select(0, local.clamp(0, m - 1))
        got = torch.where(mine.view((-1,) + (1,) * (rows.dim() - 1)), got,
                          torch.zeros((), dtype=rows.dtype,
                                      device=rows.device))
        mesh.all_reduce_(got)
    return got.view((n, B) + rows.shape[1:])[:, mesh.rows(B)]

