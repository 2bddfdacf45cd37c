"""Device-side separable bilinear image resize (counterpart of
gltvae/ops/resize.py).

A full-resolution uint8 batch (CelebA's 218x178, DataConfig.device_resize)
is dequantized and then resized on the device to the model resolution by
two contractions, out = A_H · x · A_Wᵀ per channel. The weights use
half-pixel centers and a triangle filter whose support scales with the
downsampling ratio (antialiased): the resampling of PIL's BILINEAR and of
``jax.image.resize(antialias=True)``. ``_linear_weights`` is this
package's own copy of the JAX package's numpy function, so both packages
resample with the same matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _linear_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) resampling matrix: half-pixel centers, triangle filter
    with support scaled by the downsampling ratio (antialiased)."""
    ratio = src / dst
    scale = max(ratio, 1.0)
    out = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5) * ratio - 0.5
        lo = int(np.floor(center - scale))
        hi = int(np.ceil(center + scale))
        js = np.arange(lo, hi + 1)
        w = np.clip(1.0 - np.abs(js - center) / scale, 0.0, None)
        # out-of-range taps are dropped and the row renormalized (the PIL /
        # jax.image edge convention), not clamped onto edge pixels
        keep = (js >= 0) & (js < src)
        out[i, js[keep]] = w[keep]
    return out / out.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=32)
def _device_weights(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """``_linear_weights`` on `device`, copied there once: a captured train
    step (train/graphs.py) may not copy from the host."""
    return torch.from_numpy(_linear_weights(src, dst)).to(device)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B, out_h, out_w, C) by two contractions on
    ``x``'s device."""
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    a_h = _device_weights(h, out_h, x.device)
    a_w = _device_weights(w, out_w, x.device)
    x = torch.einsum('bhwc,Hh->bHwc', x, a_h)
    return torch.einsum('bHwc,Ww->bHWc', x, a_w)
