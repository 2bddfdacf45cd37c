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
"""

from __future__ import annotations

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


class Encoder(nn.Module):
    """q(z|x): NHWC image -> (locs, scale), each (B, z_dim) float32."""

    def __init__(self, z_dim: int, features: Sequence[int] = (32, 32, 64, 128),
                 hidden: int = 256, locs_act: str = 'relu', channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.locs_act = locs_act
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
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for i in range(self.n_strided + 1):
            h = F.relu(getattr(self, f'conv{i + 1}')(h))
        # flatten in NHWC order, as the Flax Dense sees it
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        locs = self.locs(h)
        if self.locs_act == 'relu':
            locs = F.relu(locs)
        scale = F.softplus(self.scale(h).to(torch.float32))
        return locs, clip_passthrough(scale, 1e-3, 1e3)


class Decoder(nn.Module):
    """p(x|z): (B, z_dim) -> NHWC image in (0, 1)."""

    def __init__(self, z_dim: int, hidden: int,
                 features: Sequence[int] = (128, 64, 32, 32),
                 out_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.n_layers = len(features) + 1
        self.fc1 = _dense(z_dim, hidden, generator)
        self.conv1t = _conv_t(hidden, features[0], 1, 0, generator)
        cin = features[0]
        for i, f in enumerate(list(features[1:]) + [out_channels]):
            self.add_module(f'conv{i + 2}t', _conv_t(cin, f, 2, 1, generator))
            cin = f

    def forward_nchw(self, z):
        h = F.relu(self.fc1(z.to(torch.float32)))
        h = h.reshape(h.shape[0], self.hidden, 1, 1)
        for i in range(1, self.n_layers):
            h = F.relu(getattr(self, f'conv{i}t')(h))
        x = getattr(self, f'conv{self.n_layers}t')(h)
        return torch.sigmoid(x.to(torch.float32))

    def forward(self, z):
        return self.forward_nchw(z).permute(0, 2, 3, 1)


class GatedClassifier(nn.Module):
    """q(y|z,c): logits = z_classify @ (c ⊙ W) + b."""

    def __init__(self, y_dim: int, z_classify: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(z_classify, y_dim))
        self.bias = nn.Parameter(torch.empty(y_dim))
        with torch.no_grad():
            self.kernel.normal_(0.0, 0.05, generator=generator)
            self.bias.normal_(0.0, 0.05, generator=generator)

    def forward(self, z_classify, gates):
        return (z_classify.to(torch.float32) @ (gates * self.kernel)
                + self.bias)


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
