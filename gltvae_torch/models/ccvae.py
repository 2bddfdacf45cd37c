"""Gated CCVAE: the model and its supervised/unsupervised ELBOs (counterpart
of gltvae/models/ccvae.py).

The parameters live in one ``nn.Module``: four submodules plus the gating
means ``mu``. Whether μ trains is the optimizer's business
(train/state.py), as in the JAX package, so ``mu`` always has a gradient.

Every stochastic draw can be injected. A loss takes ``noise``, a dict of
tensors under the names ``tests/tf_twin.py::reconstruct_noise`` uses:

- ``eps_z`` (B, z_dim): the reparameterized z;
- ``g1``, ``g2`` (z_classify, y_dim): the BinConcrete Gumbels;
- ``eps_k`` (k, B, z_dim): the k-sample q(y|x) marginal (supervised);
- ``u_y`` (B, y_dim): the uniforms behind the sampled y (unsupervised).

A name missing from ``noise`` is drawn from ``generator``, in that order.
Images are NHWC float32 in [0, 1].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gltvae_torch.config import ModelConfig, check_supported
from gltvae_torch.models.networks import (ConditionalPrior, Decoder, Encoder,
                                          GatedClassifier)
from gltvae_torch.ops.distributions import (bernoulli_log_prob,
                                            bernoulli_log_prob_probs,
                                            bernoulli_sample, gaussian_kl,
                                            img_log_likelihood)
from gltvae_torch.ops.gating import identity_gating_matrix
from gltvae_torch.ops.sampling import (sample_gating,
                                       sample_gating_deterministic,
                                       sample_normal)


class LossAux(NamedTuple):
    """ELBO decomposition (batch means) and the sampled gates."""
    elbo: torch.Tensor
    log_pxz: torch.Tensor
    kl: torch.Tensor
    log_py: torch.Tensor
    log_qy_zc: torch.Tensor
    log_qy_x: torch.Tensor   # 0 for unsupervised batches
    gates: torch.Tensor


class Temps(NamedTuple):
    """Temperature scalars (float or 0-d tensor)."""
    gating: object


def _get(noise: Optional[dict], name: str):
    """The injected draw `name`, or None (the sampler then draws it)."""
    return None if noise is None else noise.get(name)


class CCVAE(nn.Module):
    """The gated CCVAE. ``mu_init`` is required for learnable and fixed
    'inferred' gating; fixed 'one-one' uses the identity."""

    def __init__(self, cfg: ModelConfig, mu_init: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        c = cfg
        self.encoder = Encoder(c.z_dim, c.enc_features, c.enc_hidden,
                               c.posterior_locs, c.channels, generator)
        self.decoder = Decoder(c.z_dim, c.dec_hidden or c.z_dim,
                               c.dec_features, c.channels, generator)
        self.classifier = GatedClassifier(c.y_dim, c.z_classify, generator)
        self.cond_prior = ConditionalPrior(c.z_classify, c.y_dim)
        if c.gate_type == 'fixed' and c.gate_subtype == 'one-one':
            mu = identity_gating_matrix(c.z_classify, c.y_dim)
        elif mu_init is None:
            raise ValueError(
                f'gate_type={c.gate_type}/{c.gate_subtype} requires '
                'mu_init (co-occurrence matrix)')
        else:
            mu = mu_init
        mu = torch.as_tensor(np.asarray(mu), dtype=torch.float32)
        if tuple(mu.shape) != (c.z_classify, c.y_dim):
            raise ValueError(f'mu shape {tuple(mu.shape)} != '
                             f'{(c.z_classify, c.y_dim)}')
        self.mu = nn.Parameter(mu.clone())

    # --------------------------- forward ops ---------------------------
    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def _recon_log_lik(self, z, x):
        """log p(x|z), compared in NCHW (the sum is layout-invariant)."""
        return img_log_likelihood(self.decoder.forward_nchw(z),
                                  x.permute(0, 3, 1, 2))

    def classify(self, z_classify, gates):
        return self.classifier(z_classify, gates)

    def prior_zc(self, y, gates):
        return self.cond_prior(y, gates)

    def split_z(self, z):
        """z -> (z_style, z_classify); classify dims are the LAST ones."""
        return z[..., :self.cfg.z_style], z[..., self.cfg.z_style:]

    def p_y_probs(self):
        return torch.full((self.cfg.y_dim,), self.cfg.label_prior,
                          dtype=torch.float32, device=self.mu.device)

    def _gates(self, temps: Temps, noise, generator):
        return sample_gating(self.mu, temps.gating, generator,
                             g1=_get(noise, 'g1'), g2=_get(noise, 'g2'))

    # ------------------- MC classifier marginal q(y|x) -------------------
    def log_qy_x(self, locs, scales, y, gates, k: int, eps=None,
                 generator=None):
        """log q(y|x) ≈ logsumexp_k log q(y|z_k, c) − log k, as one k·B batch
        (eps: (k, B, z_dim) standard normals, drawn unless given)."""
        if eps is None:
            eps = torch.randn((k,) + tuple(locs.shape), generator=generator,
                              dtype=torch.float32, device=locs.device)
        z = locs[None] + scales[None] * eps              # [k, B, z]
        _, zc = self.split_z(z)
        logits = self.classify(zc.reshape(-1, self.cfg.z_classify), gates)
        logits = logits.reshape(k, *y.shape)             # [k, B, y]
        log_qy = torch.sum(bernoulli_log_prob(logits, y[None]), dim=-1)
        return torch.logsumexp(log_qy, dim=0) - math.log(float(k))

    # ----------------------------- losses -----------------------------
    def _shared_forward(self, x, temps: Temps, noise, generator):
        cfg = self.cfg
        locs, scales = self.encode(x)
        z = sample_normal(locs, scales, generator, _get(noise, 'eps_z'))
        _, z_classify = self.split_z(z)
        c = self._gates(temps, noise, generator)
        logits_y_zc = self.classify(z_classify, c)

        def finish(y_obs):
            log_qy_zc = torch.sum(bernoulli_log_prob(logits_y_zc, y_obs),
                                  dim=-1)
            log_py = torch.sum(
                bernoulli_log_prob_probs(self.p_y_probs(), y_obs), dim=-1)
            prior_locs, prior_scales = self.prior_zc(y_obs, c)
            B = x.shape[0]
            prior_locs = torch.cat(
                [locs.new_zeros((B, cfg.z_style)), prior_locs], -1)
            prior_scales = torch.cat(
                [locs.new_ones((B, cfg.z_style)), prior_scales], -1)
            kl = gaussian_kl(locs, scales, prior_locs, prior_scales)
            log_pxz = self._recon_log_lik(z, x)
            return log_qy_zc, log_py, kl, log_pxz

        return locs, scales, z, z_classify, c, logits_y_zc, finish

    def _l1_mu(self, gating_reg: float):
        """L1 sparsity on the raw (unclipped) gate means."""
        if gating_reg == 0.0:
            return 0.0
        return gating_reg * torch.mean(torch.abs(self.mu))

    def unsup_loss(self, x, temps: Temps, gating_reg: float = 0.0,
                   noise: Optional[dict] = None, generator=None):
        """Unsupervised ELBO: y sampled from q(y|z,c);
        elbo = log p(x|z) + log p(y) − KL − log q(y|z,c)."""
        (_, _, _, _, c, logits_y_zc,
         finish) = self._shared_forward(x, temps, noise, generator)
        y = bernoulli_sample(logits_y_zc, _get(noise, 'u_y'), generator)
        log_qy_zc, log_py, kl, log_pxz = finish(y)
        elbo = log_pxz + log_py - kl - log_qy_zc
        loss = torch.mean(-elbo) + self._l1_mu(gating_reg)
        aux = LossAux(elbo=elbo.mean(), log_pxz=log_pxz.mean(),
                      kl=kl.mean(), log_py=log_py.mean(),
                      log_qy_zc=log_qy_zc.mean(),
                      log_qy_x=elbo.new_zeros(()), gates=c)
        return loss, aux

    def sup_loss(self, x, y, temps: Temps, gating_reg: float = 0.0,
                 k: int = 100, noise: Optional[dict] = None,
                 generator=None):
        """Supervised ELBO with the CCVAE importance weight
        w = exp(log q(y|ẑ_c,c) − log q(y|x)), z detached in the numerator:
            elbo = w·(log p(x|z) − KL − log q(y|z,c)) + log p(y) + log q(y|x)
        """
        (locs, scales, _, z_classify, c, logits_y_zc,
         finish) = self._shared_forward(x, temps, noise, generator)
        log_qy_zc, log_py, kl, log_pxz = finish(y)
        log_qy_x = self.log_qy_x(locs, scales, y, c, k,
                                 _get(noise, 'eps_k'), generator)
        logits_detached = self.classify(z_classify.detach(), c)
        log_qy_zc_det = torch.sum(bernoulli_log_prob(logits_detached, y), -1)
        w = torch.exp(log_qy_zc_det - log_qy_x)
        elbo = w * (log_pxz - kl - log_qy_zc) + log_py + log_qy_x
        loss = torch.mean(-elbo) + self._l1_mu(gating_reg)
        aux = LossAux(elbo=elbo.mean(), log_pxz=log_pxz.mean(),
                      kl=kl.mean(), log_py=log_py.mean(),
                      log_qy_zc=log_qy_zc.mean(),
                      log_qy_x=log_qy_x.mean(), gates=c)
        return loss, aux

    # --------------------------- generation ---------------------------
    def reconstruct(self, x, generator=None, eps=None):
        """x -> q(z|x) -> p(x|z): the posterior mean, or a sample when a
        generator or the noise ``eps`` is given."""
        locs, scales = self.encode(x)
        if generator is None and eps is None:
            return self.decode(locs)
        return self.decode(sample_normal(locs, scales, generator, eps))

    def sample_conditional(self, y, temps: Temps,
                           deterministic_gates: bool = False,
                           noise: Optional[dict] = None, generator=None):
        """z_classify ~ p(z_classify|y,c), z_style ~ N(0,I), x = decoder(z).
        Noise names: g1, g2, eps_zc (B, z_classify), eps_zs (B, z_style)."""
        if deterministic_gates:
            c = sample_gating_deterministic(self.mu)
        else:
            c = self._gates(temps, noise, generator)
        locs, scales = self.prior_zc(y.to(torch.float32), c)
        zc = sample_normal(locs, scales, generator, _get(noise, 'eps_zc'))
        zs = _get(noise, 'eps_zs')
        if zs is None:
            zs = torch.randn((y.shape[0], self.cfg.z_style),
                             generator=generator, device=locs.device)
        return self.decode(torch.cat([zs, zc], dim=-1))

    # ------------------------------ eval ------------------------------
    def predict_probs(self, x, temps: Temps, deterministic: bool = False,
                      noise: Optional[dict] = None, generator=None):
        """sigmoid(classifier(z, c)): sampled z and gates (the reference's
        stochastic eval), or posterior mean and expected gates when
        deterministic. Noise names: eps_z, g1, g2."""
        locs, scales = self.encode(x)
        if deterministic:
            z = locs
            c = sample_gating_deterministic(self.mu)
        else:
            z = sample_normal(locs, scales, generator, _get(noise, 'eps_z'))
            c = self._gates(temps, noise, generator)
        _, z_classify = self.split_z(z)
        return torch.sigmoid(self.classify(z_classify, c))

    def predict_labels(self, x, temps: Temps, deterministic: bool = False,
                       noise: Optional[dict] = None, generator=None):
        return torch.round(self.predict_probs(x, temps, deterministic, noise,
                                              generator))

    def classifier_accuracy(self, x, y, temps: Temps,
                            deterministic: bool = False,
                            noise: Optional[dict] = None, generator=None):
        """Mean elementwise label match."""
        y_hat = self.predict_labels(x, temps, deterministic, noise, generator)
        return torch.mean((y_hat == y.to(y_hat.dtype)).to(torch.float32))
