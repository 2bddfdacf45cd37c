"""Ranks of tests/test_torch_noise_graph.py's mesh case.

Torch only, so the spawned interpreters never import JAX. ``launch``
spawns `world` gloo ranks on the CPU (a file:// store under tmp), each
running ``raw_draws`` on its rank of the mesh and saving what it returns
to ``<out>/rank<r>.pt``; ``raw_draws(None, ...)`` in the test's own
process is the one-process reference."""

from __future__ import annotations

import os
from typing import Optional

import torch

from tests.torch_dp_workers import _rows, _state, configs


def launch(world: int, tmp, timeout_s: float = 120.0, **kw) -> list:
    """``raw_draws`` on `world` gloo ranks, each on this process's torch
    thread count (the CPU kernels' sums follow it); each rank's result in
    rank order."""
    from gltvae_torch.parallel.mesh import spawn
    out = os.path.join(str(tmp), f'noise_{world}')
    os.makedirs(out, exist_ok=True)
    spawn(_rank, world, (os.path.join(out, 'store'), out,
                         torch.get_num_threads(), kw), timeout_s)
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


def _rank(rank: int, world: int, store: str, out: str, threads: int,
          kw: dict) -> None:
    from gltvae_torch.parallel import mesh as pmesh
    torch.set_num_threads(threads)
    try:
        pmesh.initialize_multihost(f'file://{store}', world, rank,
                                   device='cpu')
        mesh = pmesh.create_mesh('cpu')
        assert (mesh.rank, mesh.world, mesh.backend) == (rank, world, 'gloo')
        torch.save(raw_draws(mesh, **kw), os.path.join(out, f'rank{rank}.pt'))
    finally:
        pmesh.shutdown()


def raw_draws(mesh, params: dict, batches: list, kinds: list,
              evals: Optional[list] = None) -> dict:
    """The default (captured: on the CPU the static-buffer path) makers on
    `mesh` (None: one process) from `params`: from one eval generator a
    chunked eval and ELBO pass over `evals` (default `batches`) and a
    stochastic ``infer.make_predict`` over its first batch; then one train
    step of each of `kinds` (True: sup) on the global (x, y) numpy
    `batches`, keeping the static noise each step's host part filled.
    Returns the static noise and noise forms, the metrics, the state, the
    values and the eval generator's state after."""
    from gltvae_torch import infer
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train import steps as tsteps
    from gltvae_torch.train.state import create_train_state
    model_cfg, train_cfg = configs()
    model = CCVAE(model_cfg, mu_init=params['mu'].numpy())
    model.load_state_dict(params)
    state = create_train_state(model, train_cfg)
    dp = None
    if mesh is not None:
        shard_state(state, mesh)
        dp = DataParallel(mesh)
    evals = evals or batches
    xs = torch.stack([torch.from_numpy(_rows(mesh, x)) for x, _ in evals])
    ys = torch.stack([torch.from_numpy(_rows(mesh, y)) for _, y in evals])
    gen = torch.Generator().manual_seed(3)
    acc = tsteps.make_scan_eval_step(model, train_cfg, dp)(model, xs, ys,
                                                           gen, 0.7)
    elbo = tsteps.make_scan_elbo_step(model, train_cfg, dp)(model, xs, gen,
                                                            0.7)
    probs = infer.make_predict(model, True, 0.3, dp)(xs[0], gen)
    sup, unsup = tsteps.make_train_steps(model, train_cfg, dp)
    noise, metrics = [], []
    for (x, y), kind in zip(batches, kinds):
        step = sup if kind else unsup
        state, m = step(state, torch.from_numpy(_rows(mesh, x)),
                        torch.from_numpy(_rows(mesh, y)), 1.0)
        metrics.append({k: v.clone() for k, v in m.items()})
        cs, = step.steps.values()
        noise.append({k: v.clone() for k, v in cs.noise.items()})
    forms = sorted({key[2] for s in (sup, unsup) for key in s.steps})
    return {'noise': noise, 'forms': forms, 'metrics': metrics,
            'state': _state(state), 'acc': acc, 'elbo': elbo,
            'probs': probs, 'gen': gen.get_state()}
