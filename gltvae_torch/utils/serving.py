"""Serving artifacts through ``torch.export`` (counterpart of
gltvae/utils/serving.py).

Each artifact is one exported program with the weights baked in: uint8
[b, S, S, 3] in, any batch size b (a dynamic dimension), dequantized inside
the program. ``torch.export.save`` writes it; a server loads it with
``load_serving`` and calls it, with no model code, checkpoint or config of
this package.

Deterministic protocol only (posterior-mean z, expected gates), so an
endpoint is reproducible; the reference's stochastic eval stays available
live through ``python -m gltvae_torch.infer --stochastic``.

The dequant inside the program is the divide form, ``x / 255`` as the
JAX package's, with the divisor a registered 0-d tensor buffer: torch on
CUDA divides by a Python scalar as a multiply by its reciprocal, which
differs on 126 of the 256 byte values. The dequant kernel is not called
there: ``torch.export`` cannot trace a ctypes launch.

``jax.export``'s ``platforms=`` has no counterpart here: an exported torch
program carries its weights on the device they were exported from, so
export on the device the artifact will serve on (``device=``).
"""

from __future__ import annotations

import copy
import io
from typing import Optional

import torch
from torch import nn

from gltvae_torch.config import apply_precision
from gltvae_torch.models.ccvae import Temps


class _Serve(nn.Module):
    """uint8 NHWC -> the model's deterministic output, divide-form
    dequant by a 0-d tensor buffer."""

    def __init__(self, model: nn.Module, what: str):
        super().__init__()
        self.model = model
        self.what = what
        self.register_buffer('divisor', torch.tensor(255.0))

    def forward(self, u8: torch.Tensor) -> torch.Tensor:
        x = u8.to(torch.float32) / self.divisor
        if self.what == 'reconstruct':
            return self.model.reconstruct(x)
        return self.model.predict_probs(x, Temps(gating=1.0),
                                        deterministic=True)


def _export(model, what: str, device: Optional[torch.device]) -> bytes:
    if device is not None and torch.device(device) != model.mu.device:
        model = copy.deepcopy(model).to(device)
    apply_precision(model.cfg)          # TF32 off while tracing, as in use
    serve = _Serve(model, what).to(model.mu.device).eval()
    s = model.cfg.image_size
    example = torch.zeros((2, s, s, 3), dtype=torch.uint8,
                          device=model.mu.device)
    with torch.no_grad():
        prog = torch.export.export(
            serve, (example,),
            dynamic_shapes={'u8': {0: torch.export.Dim('b', min=1)}})
    buf = io.BytesIO()
    torch.export.save(prog, buf)
    return buf.getvalue()


def export_predict(model, device=None) -> bytes:
    """The serialized program uint8 [b, S, S, 3] -> attribute
    probabilities f32 [b, y_dim]: ``predict_probs(x / 255,
    deterministic=True)``. Its weights live on `device` (default: the
    model's)."""
    return _export(model, 'predict', device)


def export_reconstruct(model, device=None) -> bytes:
    """The serialized program uint8 [b, S, S, 3] -> reconstruction f32
    [b, S, S, 3] in [0, 1] (posterior-mean z through the decoder)."""
    return _export(model, 'reconstruct', device)


def load_serving(path_or_bytes):
    """Load an artifact (a path or its bytes); returns a callable u8 ->
    output on the device it was exported from. TF32 is turned off for the
    process first, as the port's training and inference run, since a
    loaded program runs under the process's flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:           # read whole: torch.export.load wants a .pt2 suffix
        with open(path_or_bytes, 'rb') as f:
            blob = f.read()
    module = torch.export.load(io.BytesIO(blob)).module()
    module.requires_grad_(False)        # an inference program
    return module
