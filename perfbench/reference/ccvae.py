"""The plain reference of the gated CCVAE: forward, both ELBOs, the
BinConcrete gates, the k-sample classifier marginal, Keras Adam and the
stochastic eval accuracy, in plain PyTorch.

It follows the semi-supervised gated CCVAE (Joy et al., ICLR 2021, with
the learnable gating of jabhinav/Semi-Supervised-Gated-LT-VAE
``gated_ccvae.py``) and imports nothing of the program under test. The
parameters are a dict of tensors keyed by the names ``param_shapes``
gives; images are NHWC float32 in [0, 1]; every draw is an argument.

``precision`` picks the arithmetic of every convolution and product:
'f32' (TF32 off: the reference), or one of the lower precisions a control
runs in, 'tf32' (operands rounded to 10 mantissa bits) and 'fp8' (operands
scaled per tensor into float8, e4m3 forward and e5m2 for the gradients,
as fp8 training runs). The forward's operands are rounded, and so is the
gradient each product's backward takes, so that the backward's products
run on rounded operands too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

LOG2 = 0.6931471805599453
LABEL_PRIOR = 0.5
CLIP_LO, CLIP_HI = 1e-3, 1e3
GATE_EPS = 1e-20


# ------------------------------- shapes -------------------------------
def param_shapes(model: dict) -> Dict[str, tuple]:
    """Every parameter's name and shape for a configuration's ``model``
    block: 4x4 convs (out, in, 4, 4), transposed convs (in, out, 4, 4),
    dense layers (out, in). ``mu`` is the gating matrix."""
    z, y = model['z_dim'], model['y_dim']
    out = {}
    cin = model['channels']
    enc = list(model['enc_features'])
    for i, f in enumerate(enc + [model['enc_hidden']]):
        out[f'encoder.conv{i + 1}.weight'] = (f, cin, 4, 4)
        out[f'encoder.conv{i + 1}.bias'] = (f,)
        cin = f
    for head in ('locs', 'scale'):
        out[f'encoder.{head}.weight'] = (z, model['enc_hidden'])
        out[f'encoder.{head}.bias'] = (z,)
    hidden = model.get('dec_hidden') or z
    out['decoder.fc1.weight'] = (hidden, z)
    out['decoder.fc1.bias'] = (hidden,)
    dec = list(model['dec_features']) + [model['channels']]
    cin = hidden
    for i, f in enumerate(dec):
        out[f'decoder.conv{i + 1}t.weight'] = (cin, f, 4, 4)
        out[f'decoder.conv{i + 1}t.bias'] = (f,)
        cin = f
    out['classifier.kernel'] = (y, y)
    out['classifier.bias'] = (y,)
    for n in ('loc_true', 'loc_false', 'scale_true', 'scale_false'):
        out[f'cond_prior.{n}'] = (y, y)
    out['mu'] = (y, y)
    return out


# ----------------------------- precision -----------------------------
def _round_tf32(x):
    """Round-to-nearest-even onto TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _round_fp8(x, dtype=torch.float8_e4m3fn):
    """Per-tensor scaled float8 (amax onto the format's largest), back to
    f32."""
    amax = x.abs().max().clamp(min=1e-30)
    s = torch.finfo(dtype).max / amax
    return (x * s).to(dtype).to(torch.float32) / s


ROUNDING = {'tf32': (_round_tf32, _round_tf32),
            'fp8': (_round_fp8, lambda g: _round_fp8(g, torch.float8_e5m2))}


class _GradRound(torch.autograd.Function):
    """Identity forward; the gradient rounded on its way back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Ops:
    """Convolutions and products in one precision."""

    def __init__(self, precision: str = 'f32'):
        self.fwd, self.bwd = ROUNDING.get(precision, (None, None))

    def _run(self, f, a, b):
        if self.fwd is None:
            return f(a, b)
        q = self.fwd
        a = a + (q(a.detach()) - a).detach()
        b = b + (q(b.detach()) - b).detach()
        return _GradRound.apply(f(a, b), self.bwd)

    def conv(self, x, w, stride, padding):
        return self._run(lambda a, b: F.conv2d(a, b, None, stride, padding),
                         x, w)

    def conv_t(self, x, w, stride, padding):
        return self._run(lambda a, b: F.conv_transpose2d(a, b, None, stride,
                                                         padding), x, w)

    def linear(self, x, w):
        return self._run(lambda a, b: a @ b.T, x, w)

    def mm(self, a, b):
        return self._run(lambda a, b: a @ b, a, b)


# ------------------------------- pieces -------------------------------
def clip_pt(x, lo, hi):
    """clip whose gradient is 1 on [lo, hi], ends included."""
    return torch.where(x < lo, torch.full_like(x, lo),
                       torch.where(x > hi, torch.full_like(x, hi), x))


def gumbel(u):
    return -torch.log(-torch.log(u + GATE_EPS) + GATE_EPS)


def gates(mu, temp, u1, u2):
    """BinConcrete relaxed gates c = μ^{1/T} / (μ^{1/T} + (1-μ)^{1/T}
    e^{(g2-g1)/T} + ε), from the uniforms behind the Gumbels g1, g2."""
    m = clip_pt(mu, 0.0, 1.0)
    t = torch.full((), float(temp), device=mu.device)
    num = torch.exp((gumbel(u2) - gumbel(u1)) / t)
    t1 = torch.pow(m, 1.0 / t)
    t2 = torch.pow(1.0 - m, 1.0 / t) * num
    t2 = torch.where(m >= 1.0, torch.zeros_like(t2), t2)
    return t1 / (t1 + t2 + GATE_EPS)


def bern_logp(logits, y):
    return -F.softplus((1.0 - 2.0 * y) * logits)


def encode(p, x, model: dict, ops: Ops):
    h = x.permute(0, 3, 1, 2)
    n = len(model['enc_features'])
    for i in range(n + 1):
        stride, pad = (2, 1) if i < n else (1, 0)
        w = p[f'encoder.conv{i + 1}.weight']
        h = F.relu(ops.conv(h, w, stride, pad)
                   + p[f'encoder.conv{i + 1}.bias'][:, None, None])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    locs = ops.linear(h, p['encoder.locs.weight']) + p['encoder.locs.bias']
    if model.get('posterior_locs', 'relu') == 'relu':
        locs = F.relu(locs)
    scale = F.softplus(ops.linear(h, p['encoder.scale.weight'])
                       + p['encoder.scale.bias'])
    return locs, clip_pt(scale, CLIP_LO, CLIP_HI)


def decode_nchw(p, z, model: dict, ops: Ops):
    h = F.relu(ops.linear(z, p['decoder.fc1.weight']) + p['decoder.fc1.bias'])
    h = h.reshape(h.shape[0], -1, 1, 1)
    n = len(model['dec_features']) + 1
    for i in range(1, n + 1):
        stride, pad = (1, 0) if i == 1 else (2, 1)
        h = (ops.conv_t(h, p[f'decoder.conv{i}t.weight'], stride, pad)
             + p[f'decoder.conv{i}t.bias'][:, None, None])
        if i < n:
            h = F.relu(h)
    return torch.sigmoid(h)


def classify(p, zc, c, ops: Ops):
    return ops.mm(zc, c * p['classifier.kernel']) + p['classifier.bias']


def prior(p, y, c, ops: Ops):
    ct = c.T
    locs = (ops.mm(y, ct * p['cond_prior.loc_true'])
            + ops.mm(1.0 - y, ct * p['cond_prior.loc_false']))
    scale = (ops.mm(y, ct * p['cond_prior.scale_true'])
             + ops.mm(1.0 - y, ct * p['cond_prior.scale_false']))
    return locs, clip_pt(F.softplus(scale), CLIP_LO, CLIP_HI)


def gaussian_kl(lq, sq, lp, sp):
    kl = (torch.log(sp) - torch.log(sq)
          + 0.5 * (sq ** 2 / sp ** 2 + (lq - lp) ** 2 / sp ** 2 - 1.0))
    return kl.sum(-1)


# ------------------------------- losses -------------------------------
def loss(p, x, y, noise: dict, temp: float, model: dict, gating_reg: float,
         k: int, ops: Ops, supervised: bool):
    """The step's loss: mean(-ELBO) + gating_reg·mean|μ|. Supervised:
    the CCVAE importance-weighted ELBO with the k-sample q(y|x); else y
    drawn from q(y|z,c). `noise`: eps_z, u1, u2, and eps_k or u_y."""
    yd, zs = model['y_dim'], model['z_dim'] - model['y_dim']
    locs, scales = encode(p, x, model, ops)
    z = locs + scales * noise['eps_z']
    zc = z[:, zs:]
    c = gates(p['mu'], temp, noise['u1'], noise['u2'])
    logits = classify(p, zc, c, ops)
    if not supervised:
        y = (noise['u_y'] < torch.sigmoid(logits)).to(torch.float32)
    log_qy_zc = bern_logp(logits, y).sum(-1)
    log_py = (y * math.log(LABEL_PRIOR)
              + (1.0 - y) * math.log1p(-LABEL_PRIOR)).sum(-1)
    pl, ps = prior(p, y, c, ops)
    b = x.shape[0]
    pl = torch.cat([locs.new_zeros((b, zs)), pl], -1)
    ps = torch.cat([locs.new_ones((b, zs)), ps], -1)
    kl = gaussian_kl(locs, scales, pl, ps)
    recon = decode_nchw(p, z, model, ops)
    log_pxz = (-(x.permute(0, 3, 1, 2) - recon).abs() - LOG2).sum((1, 2, 3))
    if supervised:
        zk = locs[None] + scales[None] * noise['eps_k']
        lk = classify(p, zk[..., zs:].reshape(-1, yd), c, ops)
        lq = bern_logp(lk.reshape(k, b, yd), y[None]).sum(-1)
        log_qy_x = torch.logsumexp(lq, 0) - math.log(float(k))
        det = bern_logp(classify(p, zc.detach(), c, ops), y).sum(-1)
        w = torch.exp(det - log_qy_x)
        elbo = w * (log_pxz - kl - log_qy_zc) + log_py + log_qy_x
    else:
        elbo = log_pxz + log_py - kl - log_qy_zc
    return (-elbo).mean() + gating_reg * p['mu'].abs().mean()


def keras_alpha(count: int, lr: float, b1=0.9, b2=0.999) -> float:
    """lr·√(1-β₂ᵗ)/(1-β₁ᵗ) in float32."""
    import numpy as np
    f = np.float32
    t = f(count)
    return float(f(lr) * np.sqrt(f(1.0) - f(b2) ** t) / (f(1.0) - f(b1) ** t))


class Adam:
    """Keras Adam: ε on the uncorrected √v."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 eps: float, b1=0.9, b2=0.999):
        self.lr, self.eps, self.b1, self.b2 = lr, eps, b1, b2
        self.m = {n: torch.zeros_like(v) for n, v in params.items()}
        self.v = {n: torch.zeros_like(v) for n, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        a = torch.full((), keras_alpha(self.count, self.lr, self.b1,
                                       self.b2),
                       device=next(iter(params.values())).device)
        for n, g in grads.items():
            self.m[n] = self.b1 * self.m[n] + (1.0 - self.b1) * g
            self.v[n] = self.b2 * self.v[n] + (1.0 - self.b2) * g * g
            params[n] -= a * self.m[n] / (torch.sqrt(self.v[n]) + self.eps)


def train_steps(params: Dict[str, torch.Tensor], batches: Sequence,
                noises: Sequence[dict], flags: Sequence[bool], temp: float,
                model: dict, train: dict, first: int = 1,
                precision: str = 'f32', fault: Optional[str] = None,
                world: int = 1) -> dict:
    """Run len(batches) train steps from `params` (copied) in the
    reference's arithmetic. Returns each step's loss, Adam's first moments
    after the `first` steps by leaf, and the parameters after the last
    step.

    `fault` plants one of the faults the benchmark's comparison must
    catch: 'state_unchanged' (no update), 'half_batch' (the loss over the
    first half of the rows) or 'no_exchange' (the gradient of the first
    1/`world` of the rows alone: one rank's, never averaged)."""
    ops = Ops(precision)
    p = {n: v.detach().clone() for n, v in params.items()}
    reg = train['gating_reg'] if model['gate_type'] == 'learnable' else 0.0
    trainable = [n for n in p if n != 'mu' or model['gate_type'] ==
                 'learnable']
    opt = Adam({n: p[n] for n in trainable}, train['lr'], train['adam_eps'])
    losses, m_first = [], None
    for (x, y), noise, sup in zip(batches, noises, flags):
        keep = x.shape[0]
        if fault == 'half_batch':
            keep //= 2
        elif fault == 'no_exchange':
            keep //= world
        nz = {n: (v if n in ('u1', 'u2') else
                  (v[:, :keep] if n == 'eps_k' else v[:keep]))
              for n, v in noise.items()}
        leaves = {n: p[n].requires_grad_(True) for n in trainable}
        with torch.enable_grad():
            lv = loss(p, x[:keep], y[:keep], nz, temp, model, reg,
                      train['classifier_mc_samples'], ops, sup)
            gs = torch.autograd.grad(lv, [leaves[n] for n in trainable])
        for v in leaves.values():
            v.requires_grad_(False)
        grads = dict(zip(trainable, gs))
        losses.append(float(lv.detach()))
        if fault != 'state_unchanged':
            opt.step(p, grads)
        if len(losses) == first:
            m_first = {n: m.clone() for n, m in opt.m.items()}
    return {'losses': losses, 'm_first': m_first, 'params': p}


# -------------------------------- eval --------------------------------
@torch.no_grad()
def eval_pass(params: Dict[str, torch.Tensor], batches: Sequence,
              noises: Sequence[dict], temp: float, model: dict,
              precision: str = 'f32', fault: Optional[str] = None) -> float:
    """Mean over batches of the per-batch label accuracy of the stochastic
    classifier: z sampled from q(z|x), gates sampled, labels
    round(sigmoid(logits)). `fault` 'answer_altered' makes every label
    predicted for the first row of the first batch wrong."""
    ops = Ops(precision)
    zs = model['z_dim'] - model['y_dim']
    accs: List[torch.Tensor] = []
    for (x, y), nz in zip(batches, noises):
        locs, scales = encode(params, x, model, ops)
        z = locs + scales * nz['eps_z']
        c = gates(params['mu'], temp, nz['u1'], nz['u2'])
        y_hat = torch.round(torch.sigmoid(classify(params, z[:, zs:], c,
                                                   ops)))
        if fault == 'answer_altered' and not accs:
            y_hat[0] = 1.0 - y[0]
        accs.append((y_hat == y).to(torch.float32).mean())
    return float(torch.stack(accs).mean())
