"""Nanoseconds a span of ``gltvae_torch.trace`` costs on this host: in
the default mode with no profiler (the null context), on, and under a
profiler (a recorded span and its profiler range):

    python studies/tracing/span_cost.py
"""
import sys
import timeit

sys.path.insert(0, '.')
import torch  # noqa: E402
from gltvae_torch import trace  # noqa: E402


def plain():
    with trace.span('train.dispatch'):
        pass


def with_request():
    with trace.span('train.dispatch', request=5):
        pass


def nothing():
    pass


print('cpu:', open('/proc/cpuinfo').read().split('model name')[1].split('\n')[0])
n = 1_000_000
print('empty call ns', min(timeit.repeat(nothing, number=n, repeat=5)) * 1e9 / n)
for mode in ('auto',):
    trace.set_mode(mode)
    for f in (plain, with_request):
        t = min(timeit.repeat(f, number=n, repeat=5)) * 1e9 / n
        print(f'mode {mode} {f.__name__}: {t:.1f} ns a span')
n = 100_000
trace.set_mode('on')
for f in (plain, with_request):
    trace.reset()
    trace.set_mode('on')
    t = min(timeit.repeat(f, number=n, repeat=3)) * 1e9 / n
    print(f'mode on {f.__name__}: {t:.1f} ns a span')
trace.reset()
trace.set_mode('auto')
from torch.profiler import ProfilerActivity, profile  # noqa: E402
acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                 if torch.cuda.is_available() else [])
n = 20_000
with profile(activities=acts):
    t = min(timeit.repeat(plain, number=n, repeat=3)) * 1e9 / n
print(f'mode auto under the profiler (cpu_op range): {t:.1f} ns a span')
trace.reset()
