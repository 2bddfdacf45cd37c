"""On-device image preprocessing: the port's two hand-written CUDA kernels.

**Dequant**, uint8 (B, H, W, C) -> float32, same shape. ``csrc/dequant.cu``
replaces the TPU kernel ``gltvae/ops/pallas/preprocess.py::_normalize_2d``
and, in its divide form, the XLA dequant of
``gltvae/train/steps.py::_as_f32_image`` that every unaugmented train step
and every eval step runs. Two forms, both exactly rounded:
- ``mode='div'``: ``v / 255.0``, the main-path form (``_as_f32_image``);
- ``mode='mul'``: ``v * scale``, what ``normalize_images`` computes.
They differ in the last ulp for 126 of the 256 byte values.
``preprocess_batch`` runs the multiply form, then an optional per-channel
standardization and horizontal flip, as the JAX package's function of that
name.

**Augment**, uint8 (..., H, W, C) + per-image (dy, dx, flip) -> float32
(..., S, S, C): the S x S crop at (dy, dx), columns mirrored where flip > 0,
times ``scale`` (the multiply form). ``csrc/augment.cu`` replaces the TPU
kernel ``gltvae/ops/pallas/preprocess.py::_fused_augment``, with the JAX
package's entry points: ``fused_augment_given`` and
``fused_augment_stacked_given`` take drawn offsets, ``fused_augment`` and
``fused_augment_stacked`` draw them (``draw_crop_flip``) from torch
generators first.

Both kernels are bound by bytes moved (1 read + 4 written per output
element: 15,728,640 B for a bs-256 64x64x3 batch); see the sources for the
designs. Each equals its plain version (``dequant_reference``,
``augment_reference``) bit for bit. A CUDA tensor launches the kernel or
raises; a CPU tensor takes the plain version.

What needs no card is planned here, on the host, and handed to the C
entry points: ``dequant_plan`` (the unaligned head, the whole 4 KB
tiles, the tail, the grid) and ``augment_plan`` (rows per block, shared
memory). tests/test_torch_kernel_plan.py sweeps both.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from gltvae_torch.ops import _build

#: Launches of the dequant kernel in this process (plain int; callers reset
#: it to 0 to count the launches of one run).
launches = 0
#: Launches of the augment kernel in this process (as ``launches``).
augment_launches = 0

_MODES = {'div': 0, 'mul': 1}

#: Threads per block of both kernels (``kThreads`` in the sources).
THREADS = 256
#: Source bytes per tile (one block each) of the dequant kernel (``kTile``).
DEQUANT_TILE = 4096
#: Most dynamic shared memory an augment block may take (``kMaxSmem``).
AUGMENT_MAX_SMEM = 232448 - 64
_SMEM_DEFAULT = 48 * 1024

_P, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
# C entry points: (library, function, argument types)
_ENTRIES = {
    'dequant': ('dequant', 'gltvae_dequant_u8_f32',
                (_P, _P, _I64, _I64, _I64, _INT, _INT, _INT, _INT, _F32,
                 _P)),
    'augment': ('augment', 'gltvae_augment_u8_f32',
                (_P, _I64, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT,
                 _INT, _INT, _INT, _F32, _P)),
}
_fns = {}


def _kernel(name: str):
    """A kernel's C entry point (its library built and loaded on first use)."""
    fn = _fns.get(name)
    if fn is None:
        lib, symbol, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        err = _kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------ dequant ------------------------------

class DequantPlan(NamedTuple):
    head: int       # scalar bytes before the first 16-byte aligned one
    tiles: int      # whole DEQUANT_TILE tiles from there, by word loads
    tail: int       # scalar bytes after the last whole tile
    grid: int       # blocks; block g < tiles converts tile g
    dst_vec: bool   # float4 stores: dst + head is 16-byte aligned


def dequant_plan(src_addr: int, dst_addr: int, n: int) -> DequantPlan:
    """How the dequant kernel covers n source bytes at src_addr: the tiles
    start at the first 16-byte aligned byte, so their word loads are
    aligned, and the bytes around them go scalar. One block per tile, and
    at least enough blocks for one thread per scalar byte."""
    head = min(-src_addr % 16, n)
    tiles = (n - head) // DEQUANT_TILE
    tail = n - head - tiles * DEQUANT_TILE
    grid = max(1, tiles, _cdiv(head + tail, THREADS))
    return DequantPlan(head, tiles, tail, grid,
                       (dst_addr + 4 * head) % 16 == 0)


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
    plan = dequant_plan(u8.data_ptr(), out.data_ptr(), u8.numel())
    _launch('dequant', u8.device, u8.data_ptr(), out.data_ptr(), plan.head,
            plan.tiles, plan.tail, DEQUANT_TILE, plan.grid,
            int(plan.dst_vec), _MODES[mode], scale)
    launches += 1
    return out


def preprocess_batch(u8: torch.Tensor, flip: bool = False,
                     flip_mask: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     mean: Optional[Sequence[float]] = None,
                     std: Optional[Sequence[float]] = None) -> torch.Tensor:
    """uint8 (B, H, W, C) -> float32: the dequant kernel's multiply form
    (as ``gltvae``'s Pallas kernel), then per channel (x - mean) / std
    (std defaults to ones), then with `flip` each image mirrored left to
    right where ``flip_mask`` (B,) bool is set. Without a mask the flips
    are fair coins drawn from `generator`; `flip` with neither raises.
    Counterpart of gltvae/ops/pallas/preprocess.py::preprocess_batch."""
    x = dequant(u8, 'mul')
    if mean is not None:
        # tensors, not Python scalars: CUDA would turn / std into a
        # multiply by its reciprocal
        m = torch.tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.tensor(std or (1.0,) * len(mean), dtype=torch.float32,
                         device=x.device)
        x = (x - m) / s
    if flip:
        if flip_mask is None:
            if generator is None:
                raise ValueError('flip=True requires a flip_mask or a '
                                 'generator')
            flip_mask = torch.rand(x.shape[0], generator=generator,
                                   device=generator.device) < 0.5
        x = torch.where(flip_mask.to(x.device)[:, None, None, None],
                        x.flip(2), x)
    return x


# ------------------------------ augment ------------------------------

def _check_crop(H: int, W: int, S: int) -> None:
    if H < S or W < S:
        raise ValueError(f'input {H}x{W} smaller than crop {S}')


class AugmentPlan(NamedTuple):
    rows: int       # output rows per block (the last group may have fewer)
    groups: int     # row groups per image: the grid is (images, groups)
    smem: int       # dynamic shared memory per block, bytes
    vec: bool       # float4 stores: S*C % 4 == 0 and out 16-byte aligned


def augment_plan(W: int, C: int, S: int, out_addr: int) -> AugmentPlan:
    """Rows per augment block (32, fewer where their source rows would not
    fit the default 48 KB of shared memory), and the shared memory for
    their source rows (rows * W * C bytes, plus 30 at most of 16-byte
    rounding)."""
    row_bytes = W * C
    rows = max(1, min(32, S, (_SMEM_DEFAULT - 32) // row_bytes))
    smem = _cdiv(rows * row_bytes + 32, 16) * 16
    if smem > AUGMENT_MAX_SMEM:
        raise ValueError(f'augment: an image row of {row_bytes} bytes does '
                         f'not fit one block\'s shared memory')
    return AugmentPlan(rows, _cdiv(S, rows), smem,
                       (S * C) % 4 == 0 and out_addr % 16 == 0)


def augment_reference(u8: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      fl: torch.Tensor, out_size: int,
                      scale: float = 1.0 / 255.0) -> torch.Tensor:
    """Plain torch version of the augment kernel, on any device: an index
    gather of each image's crop, then ``dequant_reference(..., 'mul',
    scale)``. u8 is (..., H, W, C); dy, dx, fl have its leading shape.
    Offsets are clamped to the image as the kernel clamps them."""
    *lead, H, W, C = u8.shape
    S = out_size
    x = u8.reshape(-1, H, W, C)
    ar = torch.arange(S, device=u8.device)
    rows = dy.reshape(-1, 1).long().clamp(0, H - S) + ar
    cols = dx.reshape(-1, 1).long().clamp(0, W - S) + torch.where(
        fl.reshape(-1, 1) > 0, S - 1 - ar, ar)
    img = torch.arange(x.shape[0], device=u8.device)[:, None, None]
    crop = x[img, rows[:, :, None], cols[:, None, :]]
    return dequant_reference(crop, 'mul', scale).reshape(*lead, S, S, C)


def _augment(u8: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
             fl: torch.Tensor, out_size: int, scale: float,
             ndim: int) -> torch.Tensor:
    """Check the inputs, then launch the kernel (CUDA) or take the plain
    version (CPU). Offsets are not range-checked here: that would wait for
    the device. Out-of-range offsets are outside every caller's contract;
    kernel and plain version clamp them alike."""
    global augment_launches
    if u8.dtype != torch.uint8:
        raise TypeError(f'augment expects uint8 images, got {u8.dtype}')
    if u8.dim() != ndim:
        raise ValueError(f'augment expects {ndim}-d NHWC images, got shape '
                         f'{tuple(u8.shape)}')
    *lead, H, W, C = u8.shape
    _check_crop(H, W, out_size)
    for name, v in (('dy', dy), ('dx', dx), ('fl', fl)):
        if v.dtype != torch.int32:
            raise TypeError(f'{name} must be int32, got {v.dtype}')
        if v.device != u8.device:
            raise ValueError(f'{name} is on {v.device}, images on '
                             f'{u8.device}')
        if list(v.shape) != lead:
            raise ValueError(f'{name} has shape {tuple(v.shape)}, expected '
                             f'{tuple(lead)}')
    if not all(t.is_contiguous() for t in (u8, dy, dx, fl)):
        raise ValueError('augment expects contiguous tensors')
    if u8.device.type == 'cpu':
        return augment_reference(u8, dy, dx, fl, out_size, scale)
    if u8.device.type != 'cuda':
        raise ValueError(f'augment runs on cuda or cpu, not {u8.device}')
    S = out_size
    out = torch.empty((*lead, S, S, C), dtype=torch.float32,
                      device=u8.device)
    if out.numel() == 0:
        return out
    plan = augment_plan(W, C, S, out.data_ptr())
    _launch('augment', u8.device, u8.data_ptr(), u8.numel(), dy.data_ptr(),
            dx.data_ptr(), fl.data_ptr(), out.data_ptr(), math.prod(lead), H,
            W, C, S, plan.rows, plan.smem, int(plan.vec), scale)
    augment_launches += 1
    return out


def fused_augment_given(u8: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                        fl: torch.Tensor, out_size: int,
                        scale: float = 1.0 / 255.0) -> torch.Tensor:
    """uint8 [B, H, W, C] + int32 (dy, dx, fl) [B] -> f32 [B, S, S, C]."""
    return _augment(u8, dy, dx, fl, out_size, scale, ndim=4)


def fused_augment_stacked_given(u8: torch.Tensor, dy: torch.Tensor,
                                dx: torch.Tensor, fl: torch.Tensor,
                                out_size: int,
                                scale: float = 1.0 / 255.0) -> torch.Tensor:
    """Stacked form: uint8 [n, B, H, W, C] + int32 (dy, dx, fl) [n, B] ->
    f32 [n, B, S, S, C], in one launch over n·B images."""
    return _augment(u8, dy, dx, fl, out_size, scale, ndim=5)


def draw_crop_flip(generator: torch.Generator, B: int, H: int, W: int,
                   S: int, flip: bool = True,
                   out: Optional[Tuple[torch.Tensor, ...]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy, dx, fl), int32 [B] each on the generator's device: offsets
    uniform in [0, H-S] and [0, W-S], fl a fair coin (0 without flip);
    drawn into the int32 tensors `out` when given. Every augment entry
    point draws here, so the stacked draw equals the per-step draws."""
    _check_crop(H, W, S)
    if out is None:
        out = tuple(torch.empty(B, dtype=torch.int32,
                                device=generator.device) for _ in range(3))
    dy, dx, fl = out
    dy.random_(0, H - S + 1, generator=generator)
    dx.random_(0, W - S + 1, generator=generator)
    if flip:
        fl.random_(0, 2, generator=generator)
    else:
        fl.zero_()
    return dy, dx, fl


def fused_augment(u8: torch.Tensor, generator: torch.Generator,
                  out_size: int, flip: bool = True,
                  scale: float = 1.0 / 255.0) -> torch.Tensor:
    """uint8 [B, H, W, C] -> f32 [B, S, S, C]: a random crop to S x S, a
    random horizontal flip and x * scale, drawn from `generator`."""
    B, H, W, _ = u8.shape
    dy, dx, fl = draw_crop_flip(generator, B, H, W, out_size, flip)
    return fused_augment_given(u8, dy, dx, fl, out_size, scale)


def fused_augment_stacked(u8: torch.Tensor,
                          generators: Sequence[torch.Generator],
                          out_size: int, flip: bool = True,
                          scale: float = 1.0 / 255.0) -> torch.Tensor:
    """uint8 [n, B, H, W, C] + one generator per inner step -> f32
    [n, B, S, S, C]: equal to n ``fused_augment(u8[i], generators[i])``
    calls, in one launch."""
    n, B, H, W, _ = u8.shape
    if len(generators) != n:
        raise ValueError(f'{len(generators)} generators for {n} inner steps')
    draws = [draw_crop_flip(g, B, H, W, out_size, flip) for g in generators]
    dy, dx, fl = (torch.stack(v) for v in zip(*draws))
    return fused_augment_stacked_given(u8, dy, dx, fl, out_size, scale)
