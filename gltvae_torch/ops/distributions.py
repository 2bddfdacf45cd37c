"""Closed-form distribution math for the gated CCVAE (torch counterpart of
gltvae/ops/distributions.py). All functions are elementwise tensor code;
images are compared in whatever layout both arguments share."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG2 = 0.6931471805599453


def gaussian_kl(loc_q, scale_q, loc_p=None, scale_p=None, dim=-1):
    """KL( N(loc_q, scale_q²) ‖ N(loc_p, scale_p²) ) summed over `dim`;
    p defaults to N(0, I)."""
    if loc_p is None:
        loc_p = torch.zeros_like(loc_q)
    if scale_p is None:
        scale_p = torch.ones_like(scale_q)
    log_ratio = torch.log(scale_p) - torch.log(scale_q)
    var_ratio = torch.square(scale_q) / torch.square(scale_p)
    mean_term = torch.square(loc_q - loc_p) / torch.square(scale_p)
    kl = log_ratio + 0.5 * (var_ratio + mean_term - 1.0)
    return torch.sum(kl, dim=dim)


def laplace_log_prob(loc, x, scale=1.0):
    """Elementwise log Laplace(loc, scale).log_prob(x)."""
    return -torch.abs(x - loc) / scale - math.log(2.0 * scale)


def img_log_likelihood(recon, x):
    """log p(x|z) under Laplace(recon, 1), summed over the last three axes
    (an image in NHWC or NCHW: the sum does not depend on the order)."""
    recon = recon.to(torch.float32)
    x = x.to(torch.float32)
    return torch.sum(-torch.abs(x - recon) - _LOG2, dim=(-3, -2, -1))


def bernoulli_log_prob(logits, y):
    """log Bernoulli(logits).log_prob(y) = -softplus((1-2y)·logits)."""
    return -F.softplus((1.0 - 2.0 * y) * logits)


def bernoulli_log_prob_probs(probs, y):
    """log Bernoulli(probs).log_prob(y); the label prior p(y)."""
    return y * torch.log(probs) + (1.0 - y) * torch.log1p(-probs)


def bernoulli_sample(logits, u=None, generator=None, dtype=torch.float32):
    """y ~ Bernoulli(sigmoid(logits)) as ``u < sigmoid(logits)``, u ~ U[0,1)
    — what jax.random.bernoulli computes, so an injected ``u`` reproduces
    the JAX draw."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=logits.dtype)
    return (u < torch.sigmoid(logits)).to(dtype)
