"""What the program derives from the benchmark's inputs and seed, worked
out again for the reference: the gating init, the per-step and eval
draws, the batch index streams and the sup/unsup schedule.

The semantics are the published reference's (gated_ccvae.py's Learner
and utils_data.py's loader): a seeded permutation with a wrap-around last
batch and a reshuffle at each wrap, a supervised batch every
floor(total / sup_batches) steps, μ from the label co-occurrence. The
generators are seeded as the program documents: the step's draws from
``step_seed(seed, step)``, the eval draws from one generator seeded
``step_seed(seed + 1, 0)`` and advanced batch by batch.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """splitmix64's finalizer over (seed, step), 63 bits."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def cooccurrence(labels: np.ndarray) -> np.ndarray:
    """μ[i, j] = #(labels i and j both on) / #(rows with a label on),
    unit diagonal."""
    lab = np.asarray(labels, np.float64)
    n_pos = int((lab.sum(1) > 0).sum())
    mu = lab.T @ lab
    np.fill_diagonal(mu, 0.0)
    mu = mu / float(max(n_pos, 1))
    np.fill_diagonal(mu, 1.0)
    return mu.astype(np.float32)


def batches(n: int, bs: int, seed: int) -> Iterator[np.ndarray]:
    """The row indices of every batch of a split of `n` rows, forever."""
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    s = 0
    while True:
        if s + bs < n:
            out = idx[s:s + bs].copy()
            s += bs
        else:
            out = np.concatenate([idx[s:], idx[:bs - (n - s)]])
            s = (s + bs) % n
            rng.shuffle(idx)
        yield out


def schedule(n_sup: int, n_unsup: int, bs: int, sup: float) -> List[bool]:
    """One epoch's steps, True where supervised."""
    if sup == 1.0:
        return [True] * math.ceil(n_sup / bs)
    if sup == 0.0:
        return [False] * math.ceil(n_unsup / bs)
    sb, ub = math.ceil(n_sup / bs), math.ceil(n_unsup / bs)
    period = int((sb + ub) / sb)
    flags, ctr = [], 0
    for i in range(sb + ub):
        f = i % period == 0 and ctr < sb
        ctr += int(f)
        flags.append(f)
    return flags


def train_noise(seed: int, step: int, b: int, model: dict, k: int,
                supervised: bool, device) -> Dict[str, torch.Tensor]:
    """The draws of train step `step` for `b` rows: z's normals, the two
    gate uniforms, then the k-sample normals or the label uniforms."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, step))
    z, y = model['z_dim'], model['y_dim']
    out = {'eps_z': torch.randn((b, z), generator=g, device=device),
           'u1': torch.rand((y, y), generator=g, device=device),
           'u2': torch.rand((y, y), generator=g, device=device)}
    if supervised:
        out['eps_k'] = torch.randn((k, b, z), generator=g, device=device)
    else:
        out['u_y'] = torch.rand((b, y), generator=g, device=device)
    return out


def eval_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed + 1, 0))
    return g


def eval_noise(g: torch.Generator, b: int, model: dict,
               device) -> Dict[str, torch.Tensor]:
    """One eval batch's draws from the eval generator `g`."""
    z, y = model['z_dim'], model['y_dim']
    return {'eps_z': torch.randn((b, z), generator=g, device=device),
            'u1': torch.rand((y, y), generator=g, device=device),
            'u2': torch.rand((y, y), generator=g, device=device)}
