"""Reparameterized samplers (torch counterpart of gltvae/ops/sampling.py).

BinConcrete gates, as in the reference's gated_ccvae.py:102-111:

    c = μ^{1/T} / ( μ^{1/T} + (1-μ)^{1/T} · e^{(g₂-g₁)/T} + ε )

Every sampler takes either a ``torch.Generator`` or its noise injected
(``eps`` for normals, ``g1``/``g2`` for the Gumbels), so tests can drive it
with the JAX package's draws.
"""

from __future__ import annotations

import torch


def clip_passthrough(x, lo, hi):
    """clip with TF's gradient: d/dx = 1 for lo <= x <= hi (inclusive), 0
    outside. μ sits exactly at 1.0 on the diagonal, so the tie is common."""
    return torch.where(x < lo, lo, torch.where(x > hi, hi, x))


def sample_gumbel(shape, generator=None, eps=1e-20, dtype=torch.float32,
                  device=None):
    """g = -log(-log(U + ε) + ε), U ~ Uniform[0,1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u + eps) + eps)


def sample_normal(loc, scale, generator=None, eps=None):
    """z = loc + scale·ε, ε ~ N(0, I) (drawn unless injected)."""
    if eps is None:
        eps = torch.randn(scale.shape, generator=generator, dtype=loc.dtype,
                          device=loc.device)
    return loc + scale * eps


def sample_gating(mu, temperature, generator=None, g1=None, g2=None,
                  eps=1e-20):
    """BinConcrete relaxed Bernoulli gate sample, same shape as μ."""
    mu = clip_passthrough(mu, 0.0, 1.0)
    if g1 is None:
        g1 = sample_gumbel(mu.shape, generator, eps, mu.dtype, mu.device)
    if g2 is None:
        g2 = sample_gumbel(mu.shape, generator, eps, mu.dtype, mu.device)
    if not isinstance(temperature, torch.Tensor):
        # a device-side fill, not a host copy (which would wait for the
        # device); and a tensor divisor, since CUDA divides by a Python
        # scalar as a multiply by its reciprocal
        temperature = torch.full((), float(temperature), dtype=mu.dtype,
                                 device=mu.device)
    inv_t = 1.0 / temperature
    num = torch.exp((g2 - g1) / temperature)
    t1 = torch.pow(mu, inv_t)
    t2 = torch.pow(1.0 - mu, inv_t) * num
    # At μ=1 and low T, (1-μ)^{1/T}=0 while the Gumbel ratio can overflow to
    # inf, making t2 = 0·inf = NaN; the limit is t2=0 (gate surely on).
    t2 = torch.where(mu >= 1.0, 0.0, t2)
    return t1 / (t1 + t2 + eps)


def sample_gating_deterministic(mu, temperature=None):
    """The expected gate clip(μ, 0, 1), written as JAX's clip is."""
    del temperature
    return torch.minimum(torch.maximum(mu, torch.zeros_like(mu)),
                         torch.ones_like(mu))
