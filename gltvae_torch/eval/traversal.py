"""Batched latent traversal (counterpart of gltvae/eval/traversal.py).

A sweep over D latent dimensions and S values is one decoder call: the
(D·S, z) grid, whose row (d, s) is ``z_base`` with dimension ``dims[d]``
set to the s-th sweep value, is built by broadcasting and a one-hot and
decoded as one batch (45·8 = 360 images for the CelebA-64 model). It runs
under ``torch.no_grad()`` on the model's device.

The sweep values come from ``torch.linspace`` on the CPU, so they are the
same on every device; they may differ from ``jnp.linspace``'s in the last
ulp, which moves no image by more than the 1e-5 the tests hold.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _build_grid(z_base: torch.Tensor, dims: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """[D·S, z] traversal grid. z_base: (z,) anchor; dims: (D,) integer;
    values: (S,) sweep values. Row d·S + s is z_base with z[dims[d]] :=
    values[s]."""
    D, S, z_dim = dims.shape[0], values.shape[0], z_base.shape[-1]
    z = z_base.expand(D, S, z_dim)
    onehot = F.one_hot(dims.long(), z_dim).to(z_base.dtype)[:, None, :]
    z = z * (1.0 - onehot) + values[None, :, None] * onehot
    return z.reshape(D * S, z_dim)


def make_traversal_fn(model, n_steps: int = 8, lo: float = -3.0,
                      hi: float = 3.0, dims: Optional[Sequence[int]] = None):
    """Returns traverse(z_base) -> (D, S, H, W, C) images, one batched
    decode of the D·S grid on the model's device. `dims` defaults to every
    latent dimension."""
    device = model.mu.device
    dims_t = torch.as_tensor(
        list(dims) if dims is not None else range(model.cfg.z_dim),
        dtype=torch.int64, device=device)
    values = torch.linspace(lo, hi, n_steps, dtype=torch.float32).to(device)

    @torch.no_grad()
    def traverse(z_base: torch.Tensor) -> torch.Tensor:
        grid = _build_grid(z_base.to(device, torch.float32), dims_t, values)
        imgs = model.decode(grid)
        return imgs.reshape(dims_t.shape[0], n_steps, *imgs.shape[1:])

    return traverse


@torch.no_grad()
def latent_traversal(model, x: Optional[torch.Tensor] = None,
                     z_base: Optional[torch.Tensor] = None,
                     n_steps: int = 8, lo: float = -3.0, hi: float = 3.0,
                     dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Render the sweep grid anchored on `z_base`, else on the posterior
    mean of the first image of `x` (NHWC float in [0, 1]), else on z = 0."""
    device = model.mu.device
    if z_base is None:
        if x is not None:
            locs, _ = model.encode(x.to(device))
            z_base = locs[0]
        else:
            z_base = torch.zeros(model.cfg.z_dim, device=device)
    return make_traversal_fn(model, n_steps=n_steps, lo=lo, hi=hi,
                             dims=dims)(z_base)
