"""The readers of the program's spans and counters (``spans.py`` and the
``metrics/`` files that use it): their arithmetic on a made-up buffer,
a value from each in a CPU rehearsal of its cell, and nothing where the
program has no tracer or the run traced no segment."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness as H  # noqa: E402
import spans  # noqa: E402
from test_perfbench_rehearsal import rehearse  # noqa: E402

from gltvae_torch import trace  # noqa: E402

READERS = {'c64.train': ['host_wait_ms_per_step.train',
                         'draw_ms_per_step.train', 'noise_mb_per_step.train',
                         'capture_s'],
           'c64.test': ['draw_ms_per_pass.eval', 'capture_s']}
NEW = sorted({n for v in READERS.values() for n in v})


def _reader(name):
    return H.load_module(os.path.join(HERE, 'metrics', f'{name}.py'),
                         'spans_' + name.replace('.', '_'))


def _span(name, a, b, parent=-1, rank=0):
    return {'name': name, 'start_ns': a, 'end_ns': b, 'parent': parent,
            'request': 0, 'rank': rank, 'attrs': {}}


def _counters(noise):
    return {'noise_bytes': noise, 'dequant_launches': 0,
            'augment_launches': 0, 'collectives': 0}


@pytest.fixture
def made_up(monkeypatch):
    """A buffer of two captures in the set-up and a segment from 1,000 ns
    that lasts 2,000 ns (the trace's window): two train dispatches, the
    second still running when the segment ends, a wait with a wait inside
    it, an index copy's wait inside its h2d, and an eval pass."""
    recs = [
        _span('graph.capture', 100, 300),               # 0: set-up
        _span('graph.capture', 400, 900),               # 1: set-up
        _span('train.epoch', 950, 5000),                # 2
        _span('train.dispatch', 1000, 1800, 2),         # 3
        _span('host.draw', 1100, 1200, 3),              # 4
        _span('graph.replay', 1200, 1600, 3),           # 5
        _span('wait.nan_check', 1600, 1700, 3),         # 6
        _span('wait.flush', 1650, 1690, 6),             # 7: inside a wait
        _span('train.dispatch', 1800, 3500, 2),         # 8: past the end
        _span('wait.h2d', 2900, 3400, 8),               # 9: clipped to 100
        _span('wait.barrier', 1900, 1950, 2),           # 10: outside a
        _span('eval.pass', 2000, 2500, 2),              # 11   dispatch
        _span('host.draw', 2100, 2300, 11),             # 12
        _span('graph.capture', 2600, 2700, 8),          # 13: in the segment
    ]
    ivs = [{'start_ns': 1000, 'stop_ns': 4000, 'start': _counters(10),
            'stop': _counters(10 + 2 * 10**6), 'rank': 0}]
    monkeypatch.setattr(trace, 'records', lambda: recs)
    monkeypatch.setattr(trace, 'intervals', lambda: ivs)
    return {'kind': 'train', 'traces': [{'window_ns': 2000, 'steps': 2}]}


def test_the_reduction_clips_to_the_segment_and_counts_each_wait_once(
        made_up):
    p = spans.program(made_up)
    assert p is made_up['program']                   # made once a record
    r = p['ranks'][0]
    # the flush is inside the check; the index copy's wait is clipped
    assert r['wait'] == 100 + 100 + 50
    assert (r['train_draw'], r['eval_draw']) == (100, 200)
    assert p['noise_bytes'] == 2 * 10**6
    assert p['capture_s'] == pytest.approx((200 + 500) / 1e9)


def test_the_train_readers_on_the_made_up_buffer(made_up):
    def read(name):
        return _reader(name).read(made_up)
    assert read('host_wait_ms_per_step.train') == pytest.approx(250 / 1e6 / 2)
    assert read('draw_ms_per_step.train') == pytest.approx(100 / 1e6 / 2)
    assert read('noise_mb_per_step.train') == pytest.approx(1.0)
    assert read('capture_s') == pytest.approx(7e-7)
    assert read('draw_ms_per_pass.eval') is None     # a train record


def test_the_eval_readers_on_the_made_up_buffer(made_up):
    made_up.update(kind='eval', traces=[{'window_ns': 2000, 'passes': 4}])
    assert _reader('draw_ms_per_pass.eval').read(made_up) == \
        pytest.approx(200 / 1e6 / 4)
    assert _reader('host_wait_ms_per_step.train').read(made_up) is None


def test_the_largest_rank_is_read(made_up):
    recs = trace.records()
    recs.append(_span('wait.barrier', 1000, 1240, rank=1))
    assert _reader('host_wait_ms_per_step.train').read(made_up) == \
        pytest.approx(250 / 1e6 / 2)
    recs[-1]['end_ns'] = 1300
    del made_up['program']
    assert _reader('host_wait_ms_per_step.train').read(made_up) == \
        pytest.approx(300 / 1e6 / 2)


@pytest.mark.parametrize('name', NEW)
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    import gltvae_torch
    monkeypatch.delattr(gltvae_torch, 'trace')
    monkeypatch.setitem(sys.modules, 'gltvae_torch.trace', None)
    for kind in ('train', 'eval'):
        rec = {'kind': kind, 'traces': [{'window_ns': 10, 'steps': 1,
                                         'passes': 1}]}
        assert _reader(name).read(rec) is None


@pytest.mark.parametrize('name', NEW)
def test_a_run_without_a_traced_segment_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(trace, 'intervals', lambda: [])
    assert _reader(name).read({'kind': 'train', 'traces': []}) is None
    assert _reader(name).read({'kind': 'eval', 'traces': [
        {'window_ns': 10, 'passes': 1}]}) is None


@pytest.fixture(scope='module')
def rehearsed():
    return {c: rehearse(c, trace=1) for c in READERS}


@pytest.mark.parametrize('cell,name', [(c, n) for c, v in READERS.items()
                                       for n in v])
def test_each_reader_reads_a_cpu_rehearsal(rehearsed, cell, name):
    r = rehearsed[cell]
    assert r['correct']
    got = r['rehearsal']['per_layer'][name]
    assert isinstance(got['value'], float) and got['value'] >= 0.0
    if name in ('host_wait_ms_per_step.train', 'draw_ms_per_step.train',
                'noise_mb_per_step.train', 'draw_ms_per_pass.eval'):
        assert got['value'] > 0.0


def test_every_new_metric_lists_the_cells_that_read_it():
    b = H.benchmark()
    listed = {m['name']: m['workloads'] for m in b['per_layer']}
    for name in NEW:
        assert listed[name] == [c for c in READERS if name in READERS[c]]
