"""Networks of the gated CCVAE as torch modules (counterpart of
gltvae/models/networks.py).

Public ``forward``s keep the JAX package's layouts: the encoder takes NHWC
images and the decoder returns NHWC images; both permute to NCHW inside.
Parameter names follow the Flax tree (``conv1`` .. ``conv5``, ``locs``,
``scale``, ``fc1``, ``conv1t`` ..), so ``gltvae_torch.bridge`` maps one onto
the other by name.

- A pad-1 4x4/s2 conv is ``Conv2d(padding=1)``.
- TF's Conv2DTranspose 4x4/s2 'SAME' pads one pixel on each side of the
  forward conv it transposes, which is ``ConvTranspose2d(padding=1)``; the
  1x1 -> 4x4 'VALID' one is ``ConvTranspose2d(padding=0)``.
- The scale heads stay float32 with softplus and a clip to [1e-3, 1e3]
  whose gradient passes at ties (``clip_passthrough``).
- The reference's tile-mask-reduce layers are the masked GEMMs
  ``z @ (c⊙W) + b`` and ``y @ (cᵀ⊙W_t) + (1-y) @ (cᵀ⊙W_f)``.

Initializers follow Keras: glorot-uniform kernels, zero biases, N(0, 0.05)
for the classifier and zeros/ones for the conditional prior. They draw from
an explicit ``torch.Generator``; parity with the JAX package goes through
the bridge, not through the initial draw.

**Compute dtype** (``dtype``, ModelConfig.compute_dtype), cast for cast as
the JAX package: parameters stay float32 and are cast to ``dtype`` where a
layer uses them. The encoder's input, convs and dense heads run in
``dtype``, with ``locs`` cast to f32 after its ReLU and ``scale`` cast to
f32 before the softplus and the clip. Every transposed conv and both s2d
forms add their bias in ``dtype``. The decoder's ``fc1`` runs in
``dtype`` and the sigmoid in f32. The classifier multiplies the
``dtype``-rounded operands with an f32 product (the JAX package's
``preferred_element_type=float32``; a bf16 ``torch.matmul`` would round
the product to bf16), then adds its bias in f32. The conditional prior is
f32 in every mode.

**Space-to-depth** (``input_s2d``, ``output_s2d``): exact regroupings of
the encoder's first conv and the decoder's last transposed conv, built at
each forward from the canonical parameters (``conv1.weight`` OIHW, the
last ``ConvTranspose2d.weight`` (in, out, kh, kw)), so names, shapes,
checkpoints and the bridge do not change. ``space_to_depth`` /
``depth_to_space`` work on NHWC with channel order (p, q, c); the s2d
decoder's NCHW channels come out in that order.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gltvae_torch.ops.sampling import clip_passthrough


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def _conv(cin: int, cout: int, stride: int, padding: int,
          generator) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 4, stride=stride, padding=padding)
    _glorot_(conv.weight, cin * 16, cout * 16, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _conv_t(cin: int, cout: int, stride: int, padding: int,
            generator) -> nn.ConvTranspose2d:
    conv = nn.ConvTranspose2d(cin, cout, 4, stride=stride, padding=padding)
    _glorot_(conv.weight, cin * 16, cout * 16, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _dense(cin: int, cout: int, generator) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    _glorot_(lin.weight, cin, cout, generator)
    nn.init.zeros_(lin.bias)
    return lin


def space_to_depth(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (p, q, c) with
    (p, q) the pixel within its 2x2 cell."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(y):
    """Inverse of space_to_depth: (B, h, w, 4C) -> (B, 2h, 2w, C)."""
    b, h, w, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, h, w, 2, 2, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


def s2d_conv1(x, weight, bias, dtype):
    """The encoder's pad-1 4x4/s2 conv in space-to-depth form, NCHW.

    Pad 1 px, regroup each 2x2 cell into channels (p, q, c), then a 2x2
    stride-1 VALID conv: output (i, j) of the strided conv reads padded
    rows 2i..2i+3, i.e. cells i and i+1. With ky = 2a + p, kx = 2b + q the
    OIHW kernel W[o, c, ky, kx] becomes W'[o, (p, q, c), a, b]."""
    xp = F.pad(x, (1, 1, 1, 1))
    b, c, h, w = xp.shape
    if h % 2 or w % 2:
        raise ValueError(f's2d input conv needs even H/W, got {x.shape}')
    xs = xp.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(b, 4 * c, h // 2, w // 2)
    o = weight.shape[0]
    k = weight.reshape(o, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4)
    k = k.reshape(o, 4 * c, 2, 2)
    return _plus_bias(F.conv2d(xs.to(dtype), k.to(dtype)), bias, dtype)


# S2D_TAPS[r, d] = ky: the 4x4/s2 transposed conv with padding 1 writes
# out[Y] = sum x[i] W[:, :, Y - 2i + 1]. Output row Y = 2u + r read through a
# 3-tap window i = u + d - 1 (d = 0, 1, 2) takes tap ky = r + 3 - 2d; ky = -1
# and ky = 4 fall outside the kernel and index the zero row 4 of the padded
# kernel.
_S2D_TAPS = ((3, 1, 4), (4, 2, 0))


@functools.lru_cache(maxsize=8)
def _s2d_taps(device: torch.device) -> torch.Tensor:
    """``_S2D_TAPS`` on `device`, copied there once: a captured train step
    (train/graphs.py) may not copy from the host."""
    return torch.tensor(_S2D_TAPS, device=device)


def s2d_conv_transpose_last(h, weight, bias, dtype):
    """The decoder's last 4x4/s2 'SAME' transposed conv in space-to-depth
    form: one 3x3 stride-1 conv (padding 1) over the input, NCHW, whose
    4*out channels are the (r, s, c) sub-pixels of the 2x-size image.

    ``weight`` is ConvTranspose2d's (in, out, kh, kw). Output channel
    (r, s, co) at input offset (d, e) takes weight[:, co, ky, kx] with ky =
    S2D_TAPS[r][d], kx = S2D_TAPS[s][e] (see ``_S2D_TAPS``)."""
    cin, cout = weight.shape[:2]
    taps = _s2d_taps(weight.device)
    wp = F.pad(weight, (0, 1, 0, 1))                    # zero row/col 4
    g = wp[:, :, taps[:, :, None, None], taps[None, None]]   # ci co r d s e
    k3 = g.permute(2, 4, 1, 0, 3, 5).reshape(4 * cout, cin, 3, 3)
    return _plus_bias(F.conv2d(h.to(dtype), k3.to(dtype), padding=1),
                      bias.repeat(4), dtype)


def _linear(lin: nn.Linear, h, dtype):
    """A Flax Dense in ``dtype``: the product rounded to ``dtype``, then
    the bias added in ``dtype`` (two roundings, as in the JAX package; a
    fused ``F.linear`` bias would round once)."""
    return F.linear(h, lin.weight.to(dtype)) + lin.bias.to(dtype)


def _plus_bias(y, bias, dtype):
    """NCHW ``y`` + the per-channel ``bias`` in ``dtype``."""
    return y + bias.to(dtype)[:, None, None]


class Encoder(nn.Module):
    """q(z|x): NHWC image -> (locs, scale), each (B, z_dim) float32."""

    def __init__(self, z_dim: int, features: Sequence[int] = (32, 32, 64, 128),
                 hidden: int = 256, locs_act: str = 'relu', channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 input_s2d: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.locs_act = locs_act
        self.input_s2d = input_s2d
        self.dtype = dtype
        self.n_strided = len(features)
        cin = channels
        for i, f in enumerate(features):
            self.add_module(f'conv{i + 1}', _conv(cin, f, 2, 1, generator))
            cin = f
        self.add_module(f'conv{len(features) + 1}',
                        _conv(cin, hidden, 1, 0, generator))
        self.locs = _dense(hidden, z_dim, generator)
        self.scale = _dense(hidden, z_dim, generator)

    def forward(self, x):
        dt = self.dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        for i in range(self.n_strided + 1):
            conv = getattr(self, f'conv{i + 1}')
            if i == 0 and self.input_s2d:
                h = s2d_conv1(h, conv.weight, conv.bias, dt)
            else:
                h = _plus_bias(F.conv2d(h, conv.weight.to(dt), None,
                                        conv.stride, conv.padding),
                               conv.bias, dt)
            h = F.relu(h)
        # flatten in NHWC order, as the Flax Dense sees it
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        locs = _linear(self.locs, h, dt)
        if self.locs_act == 'relu':
            locs = F.relu(locs)
        scale = F.softplus(_linear(self.scale, h, dt).to(torch.float32))
        return locs.to(torch.float32), clip_passthrough(scale, 1e-3, 1e3)


class Decoder(nn.Module):
    """p(x|z): (B, z_dim) -> NHWC image in (0, 1); with ``output_s2d`` the
    image comes in space-to-depth form (B, S/2, S/2, 4C)."""

    def __init__(self, z_dim: int, hidden: int,
                 features: Sequence[int] = (128, 64, 32, 32),
                 out_channels: int = 3,
                 generator: Optional[torch.Generator] = None,
                 output_s2d: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.output_s2d = output_s2d
        self.dtype = dtype
        self.n_layers = len(features) + 1
        self.fc1 = _dense(z_dim, hidden, generator)
        self.conv1t = _conv_t(hidden, features[0], 1, 0, generator)
        cin = features[0]
        for i, f in enumerate(list(features[1:]) + [out_channels]):
            self.add_module(f'conv{i + 2}t', _conv_t(cin, f, 2, 1, generator))
            cin = f

    def forward_nchw(self, z):
        """NCHW output; channels (r, s, c) of the s2d form with
        ``output_s2d``."""
        dt = self.dtype
        h = F.relu(_linear(self.fc1, z.to(dt), dt))
        h = h.reshape(h.shape[0], self.hidden, 1, 1)
        for i in range(1, self.n_layers + 1):
            conv = getattr(self, f'conv{i}t')
            if i == self.n_layers and self.output_s2d:
                h = s2d_conv_transpose_last(h, conv.weight, conv.bias, dt)
            else:
                h = _plus_bias(F.conv_transpose2d(h, conv.weight.to(dt),
                                                  None, conv.stride,
                                                  conv.padding),
                               conv.bias, dt)
            if i < self.n_layers:
                h = F.relu(h)
        return torch.sigmoid(h.to(torch.float32))

    def forward(self, z):
        return self.forward_nchw(z).permute(0, 2, 3, 1)


class GatedClassifier(nn.Module):
    """q(y|z,c): logits = z_classify @ (c ⊙ W) + b, the product of the
    ``dtype``-rounded operands taken in f32."""

    def __init__(self, y_dim: int, z_classify: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(z_classify, y_dim))
        self.bias = nn.Parameter(torch.empty(y_dim))
        with torch.no_grad():
            self.kernel.normal_(0.0, 0.05, generator=generator)
            self.bias.normal_(0.0, 0.05, generator=generator)

    def forward(self, z_classify, gates):
        f32, dt = torch.float32, self.dtype
        z = z_classify.to(dt).to(f32)
        w = (gates * self.kernel).to(dt).to(f32)
        return z @ w + self.bias


class ConditionalPrior(nn.Module):
    """p(z_classify | y, c): gated linear maps for true/false label states,
    scale through softplus and the [1e-3, 1e3] clip."""

    def __init__(self, z_classify: int, y_dim: int):
        super().__init__()
        shape = (y_dim, z_classify)
        self.loc_true = nn.Parameter(torch.zeros(shape))
        self.loc_false = nn.Parameter(torch.zeros(shape))
        self.scale_true = nn.Parameter(torch.ones(shape))
        self.scale_false = nn.Parameter(torch.ones(shape))

    def forward(self, y, gates):
        ct = gates.T
        y = y.to(torch.float32)
        locs = y @ (ct * self.loc_true) + (1.0 - y) @ (ct * self.loc_false)
        scale = (y @ (ct * self.scale_true)
                 + (1.0 - y) @ (ct * self.scale_false))
        return locs, clip_passthrough(F.softplus(scale), 1e-3, 1e3)
