"""The kernels' host-side launch plans (gltvae_torch/ops/preprocess.py), on
the CPU: every element covered exactly once, and every 16-byte wide read
inside the source tensor.

The dequant kernel takes its plan as it is (head, tiles, tail, grid);
each tile is read as aligned 4-byte words. An augment block works out on
the card which of its source bytes one bulk copy may load and which it
loads one by one: ``augment_span`` below mirrors that rule of
csrc/augment.cu, so a change to either must be made in both. The
emulation below repeats what the kernel then does with shared memory,
index for index, and must equal the plain version bit for bit. Only
chip_smoke.py (phases 3 and 7) runs the kernels themselves.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gltvae_torch.ops.preprocess import (AUGMENT_MAX_SMEM, DEQUANT_TILE,
                                         THREADS, augment_plan,
                                         augment_reference, dequant_plan)

T = DEQUANT_TILE
BASE = 1 << 20          # a 16-byte aligned stand-in for a device address


# ------------------------------ dequant ------------------------------

def _check_dequant_plan(off, n):
    src, dst = BASE + off, 2 * BASE
    p = dequant_plan(src, dst, n)
    assert p.head + p.tiles * T + p.tail == n
    assert 0 <= p.head <= 15 and 0 <= p.tail < T
    # one block per tile, and a thread for each scalar byte
    assert p.grid == max(1, p.tiles, -(-(p.head + p.tail) // THREADS))
    assert p.dst_vec == (p.head % 4 == 0)
    covered = np.zeros(n, np.int8)
    covered[:p.head] += 1
    covered[p.head + p.tiles * T:] += 1
    if p.tiles:
        assert (src + p.head) % 16 == 0
    # block g < tiles converts tile g (csrc/dequant.cu): T bytes read as
    # words, 16-byte aligned and inside the source
    for k in range(min(p.grid, p.tiles)):
        lo = p.head + k * T
        assert (src + lo) % 16 == 0 and T % 16 == 0
        assert 0 <= lo and lo + T <= n
        covered[lo:lo + T] += 1
    assert (covered == 1).all()
    return p


@pytest.mark.parametrize('n', [1, 15, 16, 17, T - 1, T, T + 1, 2 * T - 1,
                               2 * T, 2 * T + 1, 3 * T + 17, 5 * 33 * 17 * 3,
                               256 * 64 * 64 * 3,
                               4753 * T + 1])           # several waves
def test_dequant_plan_covers_once_inside_the_source(n):
    for off in range(16):
        _check_dequant_plan(off, n)


def test_dequant_plan_at_the_main_shape_is_whole_tiles():
    p = _check_dequant_plan(0, 256 * 64 * 64 * 3)
    assert (p.head, p.tiles, p.tail, p.grid, p.dst_vec) == (0, 768, 0, 768,
                                                            True)


@pytest.mark.parametrize('off', [1, 7, 15])
def test_dequant_plan_head_only(off):
    """Fewer bytes than reach the first aligned address: all scalar."""
    p = _check_dequant_plan(off, 16 - off - 1)
    assert (p.head, p.tiles, p.tail, p.grid) == (16 - off - 1, 0, 0, 1)


@settings(max_examples=200, deadline=None)
@given(off=st.integers(0, 15), n=st.integers(1, 9 * T + 40))
def test_dequant_plan_sweep(off, n):
    _check_dequant_plan(off, n)


# ------------------------------ augment ------------------------------

def augment_span(base, nbytes, lo, hi):
    """How an augment block loads its source rows, bytes [lo, hi) of the
    tensor at [base, base + nbytes): a mirror of csrc/augment.cu's rule.

    Returns (a0, window, scalar): shared memory byte i holds address
    a0 + i; window = (a, z) is the one bulk copy, the span's 16-byte
    rounded window clamped inside the tensor (None when that is empty);
    scalar lists the byte ranges loaded one by one."""
    a0 = lo & ~15
    a = max(a0, (base + 15) & ~15)
    z = min((hi + 15) & ~15, (base + nbytes) & ~15)
    if a >= z:
        return a0, None, [(lo, hi)]
    return a0, (a, z), [(lo, max(a, lo)), (min(z, hi), hi)]


def _blocks(n_images, H, W, C, S, plan, y0s):
    """(image, y0, row0, rows, lo, hi) of each block, lo/hi relative to
    the tensor's first byte, as csrc/augment.cu computes them."""
    for b in range(n_images):
        for g in range(plan.groups):
            row0 = g * plan.rows
            rows = min(plan.rows, S - row0)
            lo = (b * H + y0s[b] + row0) * W * C
            yield b, y0s[b], row0, rows, lo, lo + rows * W * C


def _check_span(base, nbytes, lo, hi, smem):
    a0, window, scalar = augment_span(base, nbytes, base + lo, base + hi)
    covered = {}
    if window is not None:
        a, z = window
        assert a % 16 == 0 and z % 16 == 0 and a < z
        assert base <= a and z <= base + nbytes          # inside the tensor
        assert 0 <= a - a0 and z - a0 <= smem
        for p in range(max(a, base + lo), min(z, base + hi)):
            covered[p] = covered.get(p, 0) + 1
    for s, e in scalar:
        assert base + lo <= s <= e <= base + hi
        for p in range(s, e):
            covered[p] = covered.get(p, 0) + 1
    assert sorted(covered) == list(range(base + lo, base + hi))
    assert set(covered.values()) == {1}
    assert 0 <= base + lo - a0 and base + hi - a0 <= smem
    return a0, window, scalar


# (n_images, H, W, C, S): the main path's per-step shape, 128 px with one
# channel, odd and ragged shapes, a generic C and a last row group of one
SPAN_SHAPES = [(256, 72, 72, 3, 64), (2, 136, 136, 1, 128), (5, 21, 19, 3, 15),
               (4, 20, 20, 1, 16), (3, 12, 11, 5, 8), (2, 40, 36, 1, 33)]


@pytest.mark.parametrize('shape', SPAN_SHAPES)
def test_augment_spans_cover_once_inside_the_tensor(shape):
    n, H, W, C, S = shape
    plan = augment_plan(W, C, S, 0)
    assert plan.smem <= AUGMENT_MAX_SMEM and plan.smem % 16 == 0
    assert plan.groups * plan.rows >= S > (plan.groups - 1) * plan.rows
    nbytes = n * H * W * C
    images = sorted({0, 1, n - 2, n - 1} & set(range(n)))
    for off in range(16):
        for y0 in (0, (H - S) // 2, H - S):
            for b, _, _, _, lo, hi in _blocks(n, H, W, C, S, plan, [y0] * n):
                if b in images:
                    _check_span(BASE + off, nbytes, lo, hi, plan.smem)


def test_augment_last_image_far_corner_stays_inside():
    """The last image cropped at dy = H - S ends at the tensor's last byte;
    at an unaligned end its window stops short and the rest is scalar."""
    n, H, W, C, S = 3, 21, 19, 3, 15
    plan = augment_plan(W, C, S, 0)
    nbytes = n * H * W * C
    for off in range(16):
        base = BASE + off
        *_, lo, hi = list(_blocks(n, H, W, C, S, plan, [H - S] * n))[-1]
        assert hi == nbytes
        _, window, scalar = _check_span(base, nbytes, lo, hi, plan.smem)
        assert window[1] == (base + nbytes) & ~15
        assert scalar[-1] == ((base + nbytes) & ~15, base + nbytes)


def test_augment_plan_rows_and_smem():
    assert augment_plan(72, 3, 64, 0) == (32, 2, 32 * 216 + 32, True)
    assert augment_plan(19, 3, 15, 0).vec is False            # S*C = 45
    assert augment_plan(72, 3, 64, 4).vec is False            # unaligned out
    wide = augment_plan(4096, 3, 64, 0)                       # 12 KB rows
    assert wide.rows == 3 and wide.smem <= 48 * 1024
    huge = augment_plan(20000, 3, 64, 0)                      # > 48 KB a row
    assert huge.rows == 1 and 48 * 1024 < huge.smem <= AUGMENT_MAX_SMEM
    with pytest.raises(ValueError, match='shared memory'):
        augment_plan(100000, 3, 64, 0)


def _emulate_augment(u8, off, dy, dx, fl, S, scale=np.float32(1 / 255)):
    """csrc/augment.cu, block by block and thread by thread, on numpy:
    load each block's span into 'shared memory' by augment_span (bytes
    outside the tensor are a sentinel), then make the outputs with the
    kernel's index stepping."""
    n, H, W, C = u8.shape
    nbytes = u8.size
    base = BASE + off
    mem = np.full(base + nbytes + 64, 0xEE, np.uint8)
    mem[base:base + nbytes] = u8.reshape(-1)
    plan = augment_plan(W, C, S, 0)
    width = 4 if plan.vec else 1
    out = np.full(n * S * S * C, np.nan, np.float32)
    y0s = np.clip(dy, 0, H - S)
    for b, y0, row0, rows, lo, hi in _blocks(n, H, W, C, S, plan, y0s):
        a0, window, scalar = _check_span(base, nbytes, lo, hi, plan.smem)
        smem = np.full(plan.smem, 0xDD, np.uint8)
        for s, e in ([window] if window else []) + scalar:
            smem[s - a0:e - a0] = mem[s:e]
        x0 = int(np.clip(dx[b], 0, W - S))
        crop = base + lo - a0 + x0 * C
        o = (b * S + row0) * S * C
        per_row = S * C // width
        dr, dq = divmod(THREADS, per_row)
        for tid in range(THREADS):
            r, q = divmod(tid, per_row)
            for t in range(tid, rows * per_row, THREADS):
                j, c = divmod(q * width, C)
                for k in range(width):
                    js = S - 1 - j if fl[b] > 0 else j
                    out[o + t * width + k] = (
                        np.float32(smem[crop + r * W * C + js * C + c])
                        * scale)
                    c += 1
                    if c == C:
                        c, j = 0, j + 1
                q, r = q + dq, r + dr
                if q >= per_row:
                    q, r = q - per_row, r + 1
    return out.reshape(n, S, S, C)


@pytest.mark.parametrize('shape, how', [
    ((5, 21, 19, 3, 15), 'drawn'), ((3, 21, 19, 3, 15), 'far'),
    ((4, 20, 20, 1, 16), 'drawn'), ((3, 12, 11, 5, 8), 'drawn'),
    ((2, 40, 36, 1, 33), 'far'), ((2, 72, 72, 3, 64), 'drawn')])
def test_augment_emulation_bit_equal_to_plain(shape, how):
    n, H, W, C, S = shape
    rng = np.random.RandomState(sum(shape))
    u8 = rng.randint(0, 256, (n, H, W, C), dtype=np.uint8)
    dy = rng.randint(0, H - S + 1, n).astype(np.int32)
    dx = rng.randint(0, W - S + 1, n).astype(np.int32)
    fl = rng.randint(0, 2, n).astype(np.int32)
    if how == 'far':
        dy[:], dx[:] = H - S, W - S
    want = augment_reference(*(torch.from_numpy(v) for v in (u8, dy, dx, fl)),
                             S).numpy()
    for off in (0, 3) if n * H * W * C < 20000 else (0,):
        got = _emulate_augment(u8, off, dy, dx, fl, S)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------- timing helpers ---------------------------

def test_bounds_memory_rate_and_cycler():
    """The byte bounds that chip_smoke.py prints (from
    gltvae_torch.time_kernels), from the card's name."""
    from gltvae_torch.time_kernels import (augment_bound_ms, cycler,
                                           dequant_bound_ms, memory_rate)
    assert memory_rate('NVIDIA H100 80GB HBM3') == 3.35e12
    assert memory_rate('NVIDIA H100 PCIe') == 2.0e12
    assert memory_rate('NVIDIA H200') == 4.8e12
    n = 256 * 64 * 64 * 3
    assert dequant_bound_ms(n, 3.35e12) == pytest.approx(15728640 / 3.35e9)
    assert augment_bound_ms(256, 64, 3, 3.35e12) == pytest.approx(
        (15728640 + 256 * 12) / 3.35e9)
    nxt = cycler([1, 2, 3])
    assert [nxt() for _ in range(4)] == [2, 3, 1, 2]
