"""Helpers to time the port's CUDA kernels on one GPU and to state their
byte bounds (chip_smoke.py phases 4 and 8 use them).

``cuda_ms`` takes device ms per call with CUDA events while a sleep kernel
holds the stream; ``cycler`` hands out distinct inputs in turn, so that
L2 holds none between calls; the bounds count each input byte read once
and each output float written once at the card's memory rate.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

# Peak device-memory rate by card (NVIDIA data sheets), bytes/s.
MEM_RATE = (('H100 PCIe', 2.0e12), ('H100 NVL', 3.9e12), ('H200', 4.8e12),
            ('H100', 3.35e12))


def memory_rate(kind: str) -> float:
    """The card's peak memory rate (bytes/s) from its name."""
    return next((r for name, r in MEM_RATE if name in kind), 3.35e12)


def cuda_ms(fn: Callable, reps: int, warmup: int = 10):
    """(device ms, host ms) per call of fn() on the current stream.

    The device time is taken with CUDA events while a sleep kernel holds
    the stream, so the host enqueues all `reps` calls before the first
    runs: the events then see the calls back to back, without the host's
    launch overhead between them. The host time is the wall time per call
    of the enqueue loop (what a caller that waits on nothing pays). The
    queue holds about 1,000 launches, so reps x (kernels per call) stays
    below that, or the host waits for the sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device time
    ev[1].record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError('the sleep kernel ended before the host enqueued '
                           'every call')
    return ev[1].elapsed_time(ev[2]) / reps, host_ms / reps


def cycler(items: List):
    """A function that returns the next of `items` on each call, round."""
    state = {'i': 0}

    def nxt():
        state['i'] = (state['i'] + 1) % len(items)
        return items[state['i']]
    return nxt


def dequant_bound_ms(n: int, rate: float) -> float:
    """Each byte read once, each float written once."""
    return n * (1 + 4) / rate * 1e3


def augment_bound_ms(images: int, S: int, C: int, rate: float) -> float:
    """Each cropped byte read once, each float written once, 12 B of
    offsets per image."""
    return images * (S * S * C * (1 + 4) + 12) / rate * 1e3
