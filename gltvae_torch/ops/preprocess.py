"""On-device image dequant: uint8 (B, H, W, C) -> float32, same shape.

The hand-written CUDA kernel ``csrc/dequant.cu`` replaces the TPU kernel
``gltvae/ops/pallas/preprocess.py::_normalize_2d`` and, in its divide form,
the XLA dequant of ``gltvae/train/steps.py::_as_f32_image`` that every train
and eval step of the main path runs. It is bound by bytes moved (1 read + 4
written per element: 15,728,640 B for a bs-256 64x64x3 batch), so it is a
plain vectorised stream; see the source for the design.

Two forms, both exactly rounded, so kernel and plain version agree bit for
bit:
- ``mode='div'``: ``v / 255.0``, the main-path form (``_as_f32_image``);
- ``mode='mul'``: ``v * scale``, what ``normalize_images`` computes.
They differ in the last ulp for 126 of the 256 byte values.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version ``dequant_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from gltvae_torch.ops import _build

#: Launches of the dequant kernel in this process (plain int; callers reset
#: it to 0 to count the launches of one run).
launches = 0

_MODES = {'div': 0, 'mul': 1}


def dequant_reference(u8: torch.Tensor, mode: str = 'div',
                      scale: float = 1.0 / 255.0) -> torch.Tensor:
    """Plain torch version of the kernel, on any device.

    The divisor is a tensor on ``u8``'s device on purpose: torch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    is the 'mul' form, not the correctly rounded divide. It is made by a
    device-side fill, which does not wait for the device as a host copy
    would."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'div' or 'mul', got {mode!r}")
    x = u8.to(torch.float32)
    c = torch.full((), 255.0 if mode == 'div' else scale,
                   dtype=torch.float32, device=u8.device)
    return x / c if mode == 'div' else x * c


_fn = None


def _kernel():
    """The kernel's C entry point (built and loaded on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load('dequant').gltvae_dequant_u8_f32
        fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def dequant(u8: torch.Tensor, mode: str = 'div',
            scale: float = 1.0 / 255.0) -> torch.Tensor:
    """uint8 -> float32 of the same shape: ``v / 255`` (mode='div') or
    ``v * scale`` (mode='mul'). CUDA tensors go through the kernel."""
    global launches
    if mode not in _MODES:
        raise ValueError(f"mode must be 'div' or 'mul', got {mode!r}")
    if u8.dtype != torch.uint8:
        raise TypeError(f'dequant expects uint8, got {u8.dtype}')
    if u8.device.type == 'cpu':
        return dequant_reference(u8, mode, scale)
    if u8.device.type != 'cuda':
        raise ValueError(f'dequant runs on cuda or cpu, not {u8.device}')
    if not u8.is_contiguous():
        raise ValueError('dequant expects a contiguous tensor')
    out = torch.empty(u8.shape, dtype=torch.float32, device=u8.device)
    if u8.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(u8.device):
        err = fn(u8.data_ptr(), out.data_ptr(), u8.numel(), _MODES[mode],
                 scale, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'dequant kernel launch failed: CUDA error {err}')
    launches += 1
    return out
