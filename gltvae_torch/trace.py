"""Spans and counters of the port's host loop.

A span is a named stretch of the host's time, ``with span(name,
**attrs):``. It records its name, its start and end (``time.time_ns()``,
the clock of ``torch.profiler``'s events), the index of the span it
nests in (-1 at the top), the id of the request that caused it and the
rank of this process. A span given ``request=`` sets the id for the spans
inside it: the Trainer gives a train dispatch its first global step and
an eval or ELBO pass the pass's number, so every span of one dispatch
carries the same id. Spans go into one bounded buffer per process; once
it holds ``CAPACITY`` spans, later ones are dropped and counted.

The tracer is in one of two modes (``set_mode``):

- ``'auto'``, the default: spans are recorded while a ``torch.profiler``
  runs and not otherwise, so any profile of the program carries its spans
  and an unprofiled run pays only for the check;
- ``'on'``: every span is recorded (``cli.py --trace-out``).

Where nothing is recorded, ``span`` returns the one shared ``NULL``
context: it allocates nothing and reads no clock. While a profiler runs,
each recorded span is also a range of the profile (a ``cpu_op`` event,
``torch._C._profiler._RecordFunctionFast``), so the device trace names the
program's spans on its own clock.

``setup_span`` is a span of a one-time set-up cost (a graph's capture, a
resident split's copy). It is always recorded, profiler or not, so that
the set-up can be read after it has passed.

The spans recorded while a profiler runs, or between ``set_mode('on')``
and another mode, form one recording interval (``intervals``). Each
interval keeps the counters (``snapshot``) at its start and at its end;
in 'auto' the end is seen at the first span called after the profiler
stopped.

Counters: ``noise_bytes``, the bytes of the variates the host parts draw
(``count_noise``, called by ``train.steps.draw_noise`` and
``draw_eval_noise`` on the captured and the eager paths alike),
``index_uploads``, the host-to-device copies of resident index rows (the
Trainer's ``_upload_rows``: one a resident train epoch, one a resident
eval or ELBO pass), and ``h2d_bytes``, the bytes of the host batches the
Trainer's ``_place`` ships (images and labels: each streamed dispatch and
eval chunk, and a resident split's copy at set-up). ``snapshot`` reads
them beside the counters that already live elsewhere:
the dequant and augment launches (``ops.preprocess``) and the
collectives (``parallel.mesh``). Replays, captures and waits are counted
by their spans.

``write(path)`` writes the buffer as a Chrome trace (JSON, one process a
rank, the counters at each interval's ends), which Perfetto opens. The
spans of one process come from its host loop's thread.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

#: Spans the buffer holds; later ones are dropped and counted.
CAPACITY = 1 << 18

MODES = ('auto', 'on')

_profiling = torch._C._autograd._profiler_enabled

_mode = 'auto'
#: [name, start_ns, end_ns (0 while open), parent, request, rank, attrs]
_spans: List[list] = []
#: indices of the recorded spans that are open, innermost last
_stack: List[int] = []
_intervals: List[dict] = []
_recording = False
_dropped = 0
#: this process's rank in its group (0 until it joins one)
_rank = 0
_rank_known = False

#: Bytes of variates drawn by the host parts in this process.
noise_bytes = 0
#: Host-to-device copies of resident index rows in this process.
index_uploads = 0
#: Bytes of the host batches the Trainer shipped in this process.
h2d_bytes = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


#: The context of every span that records nothing.
NULL = _Null()


def _find_rank() -> None:
    """Learn this process's rank once it has joined a group."""
    global _rank, _rank_known
    if dist.is_available() and dist.is_initialized():
        _rank, _rank_known = dist.get_rank(), True


def _start() -> None:
    global _recording
    _recording = True
    if not _rank_known:
        _find_rank()
    _intervals.append({'start_ns': time.time_ns(), 'start': snapshot(),
                       'stop_ns': None, 'stop': None, 'rank': _rank})


def _stop() -> None:
    global _recording
    _recording = False
    _intervals[-1].update(stop_ns=time.time_ns(), stop=snapshot())


#: The profiler's range of a span: a ``cpu_op`` event, as an op's. A
#: ``record_function`` range would also lay a ``gpu_user_annotation`` event
#: over its kernels on the device's timeline, which a trace's reader takes
#: for device time.
_Mirror = getattr(torch._C._profiler, '_RecordFunctionFast', None)


class _Span:
    __slots__ = ('name', 'request', 'attrs', 'setup', 'index', 'mirror')

    def __init__(self, name: str, request: Optional[int], attrs: dict,
                 setup: bool):
        self.name, self.request, self.setup = name, request, setup
        self.attrs = attrs or None

    def __enter__(self):
        global _dropped
        if not _rank_known:
            _find_rank()
        if not self.setup and not _recording:
            _start()
        self.mirror = None
        if _Mirror is not None and _profiling():
            self.mirror = _Mirror(self.name)
            self.mirror.__enter__()
        parent = _stack[-1] if _stack else -1
        request = self.request
        if request is None:
            request = _spans[parent][4] if parent >= 0 else -1
        if len(_spans) >= CAPACITY:
            _dropped += 1
            self.index = -1
            return self
        self.index = len(_spans)
        _spans.append([self.name, time.time_ns(), 0, parent, request, _rank,
                       self.attrs])
        _stack.append(self.index)
        return self

    def __exit__(self, kind, value, tb):
        if self.index >= 0:
            _spans[self.index][2] = time.time_ns()
            _stack.pop()
        if self.mirror is not None:
            self.mirror.__exit__(kind, value, tb)
        return False


def span(name: str, request: Optional[int] = None, **attrs):
    """A span of the host loop (see the module docstring): recorded in
    the mode 'on', and in 'auto' while a profiler runs; else ``NULL``.
    `request` sets the request id of it and the spans inside it (by
    default the enclosing span's)."""
    if _mode == 'on' or (_mode == 'auto' and _profiling()):
        return _Span(name, request, attrs, False)
    if _recording:
        _stop()
    return NULL


def setup_span(name: str, **attrs):
    """A span of a one-time set-up cost: always recorded."""
    return _Span(name, None, attrs, True)


def set_mode(mode: str) -> None:
    """'auto' or 'on'. Turning 'on' starts a recording interval; leaving
    'on' ends it, unless a profiler runs."""
    global _mode
    if mode not in MODES:
        raise ValueError(f'trace mode {mode!r} is none of {MODES}')
    if _recording and not (mode == 'auto' and _profiling()):
        _stop()
    _mode = mode
    if mode == 'on':
        _start()


def mode() -> str:
    return _mode


def count_noise(noise: Dict[str, torch.Tensor]) -> None:
    """Add the bytes of a host part's draws to ``noise_bytes``."""
    global noise_bytes
    noise_bytes += sum(v.nbytes for v in noise.values())


def snapshot() -> Dict[str, int]:
    """The counters: ``noise_bytes``, ``index_uploads``, ``h2d_bytes``,
    the dequant and augment kernels' launches and the mesh's collectives,
    read where each lives."""
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh
    return {'noise_bytes': noise_bytes, 'index_uploads': index_uploads,
            'h2d_bytes': h2d_bytes,
            'dequant_launches': preprocess.launches,
            'augment_launches': preprocess.augment_launches,
            'collectives': mesh.collectives}


def records() -> List[dict]:
    """The recorded spans, in the order they started; ``end_ns`` is 0 for
    a span still open."""
    keys = ('name', 'start_ns', 'end_ns', 'parent', 'request', 'rank',
            'attrs')
    return [dict(zip(keys, s[:6]), attrs=s[6] or {}) for s in _spans]


def intervals() -> List[dict]:
    """The recording intervals: ``start_ns``, ``stop_ns`` (None while
    open), the counters at each end (``start``, ``stop``) and the rank."""
    return [dict(iv) for iv in _intervals]


def dropped() -> int:
    """Spans left out because the buffer was full."""
    return _dropped


def reset() -> None:
    """Empty the buffer and forget the intervals (the counters stay);
    called with no span open."""
    global _recording, _dropped, _rank, _rank_known
    _rank, _rank_known = 0, False
    _spans.clear()
    _stack.clear()
    _intervals.clear()
    _recording = False
    _dropped = 0


def _chrome(rank: Optional[int]) -> dict:
    """The buffer as a Chrome trace: a complete event a span (µs; a span
    still open ends now), the counters at each interval's ends, and this
    process named by its rank."""
    rank = _rank if rank is None else rank
    now = time.time_ns()
    events = [{'name': 'process_name', 'ph': 'M', 'pid': rank, 'tid': 0,
               'args': {'name': f'rank {rank}'}}]
    for i, (name, a, b, parent, request, _, attrs) in enumerate(_spans):
        events.append({'name': name, 'ph': 'X', 'ts': a / 1e3,
                       'dur': ((b or now) - a) / 1e3, 'pid': rank, 'tid': 0,
                       'args': dict(attrs or {}, index=i, parent=parent,
                                    request=request)})
    for iv in _intervals:
        for at, counters in ((iv['start_ns'], iv['start']),
                             (iv['stop_ns'], iv['stop'])):
            if at is not None:
                events.append({'name': 'counters', 'ph': 'C', 'ts': at / 1e3,
                               'pid': rank, 'tid': 0, 'args': counters})
    return {'traceEvents': events, 'displayTimeUnit': 'ms',
            'otherData': {'rank': rank, 'dropped': _dropped,
                          'counters': snapshot()}}


def write(path: str, rank: Optional[int] = None) -> None:
    """Write the buffer to `path` as a Chrome trace (JSON) of process
    `rank` (by default the rank the spans recorded)."""
    with open(path, 'w') as f:
        json.dump(_chrome(rank), f)
