"""``gltvae_torch.trace``: the host loop's spans and counters.

- The tracer alone: nesting and parents, one request id across a
  dispatch's spans, the one shared null context where nothing is recorded
  (the default mode with no profiler), set-up spans, the bounded buffer
  and its drop count, the recording intervals and their counters, and the
  Chrome trace it writes.
- Under ``torch.profiler`` on the CPU: 'auto' records, each span is a
  range of the profile (a ``cpu_op``, no annotation of the device's
  timeline), and a span's ends bound the
  profiler's events of the ops inside it (one clock).
- A tiny CPU Trainer with the tracer on: one ``train.dispatch`` a
  dispatch with ``host.draw`` and ``train.log`` inside, one ``eval.pass``
  a validation, each index rows' copy a ``wait.h2d`` inside its
  ``train.h2d`` (one an epoch, before its dispatches, and one a pass), no ``graph.capture`` on the CPU, ``noise_bytes`` as the
  draws' shapes give it, and parameters and metrics.csv bit-equal to a run
  with the tracer off.
- ``cli.py --trace-out``: one Chrome trace on one device, one a rank on a
  two-rank gloo mesh; ``profile_step`` records the spans of its profiled
  run.
"""

import csv
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gltvae_torch import trace
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer
from tests import torch_dp_workers as W
from tests.test_torch_dp_cli import _cli_argv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh():
    """An empty buffer in the default mode before and after each test."""
    trace.reset()
    trace.set_mode('auto')
    yield
    trace.set_mode('auto')
    trace.reset()


def _names(records):
    return [r['name'] for r in records]


# ------------------------------ the tracer ------------------------------
def test_spans_nest_and_name_their_parents():
    trace.set_mode('on')
    with trace.span('a'):
        with trace.span('b', k=1):
            with trace.span('c'):
                pass
        with trace.span('d'):
            pass
    with trace.span('e'):
        pass
    got = trace.records()
    assert _names(got) == ['a', 'b', 'c', 'd', 'e']
    assert [r['parent'] for r in got] == [-1, 0, 1, 0, -1]
    assert got[1]['attrs'] == {'k': 1}
    for r in got:
        assert 0 < r['start_ns'] <= r['end_ns']
        assert r['rank'] == 0
    a, b, c = got[:3]
    assert a['start_ns'] <= b['start_ns'] <= c['start_ns']
    assert c['end_ns'] <= b['end_ns'] <= a['end_ns']


def test_a_request_id_covers_the_spans_inside_it():
    trace.set_mode('on')
    for step in (7, 8):
        with trace.span('train.dispatch', request=step):
            with trace.span('host.draw'):
                pass
            with trace.span('graph.replay'):
                with trace.span('inner'):
                    pass
    with trace.span('outside'):
        pass
    got = trace.records()
    assert [r['request'] for r in got] == [7] * 4 + [8] * 4 + [-1]
    assert 'request' not in got[0]['attrs']


def test_with_no_profiler_span_is_the_one_null_context():
    assert trace.mode() == 'auto'
    assert trace.span('x') is trace.NULL
    assert trace.span('y', request=3, k='v') is trace.NULL
    with trace.span('x') as s:
        assert s is trace.NULL
        with trace.span('y'):
            pass
    assert trace.records() == [] and trace.intervals() == []
    assert trace.dropped() == 0


def test_set_up_spans_are_kept_with_no_profiler():
    with trace.setup_span('graph.capture', kind='k'):
        with trace.span('inside'):
            pass
    (got,) = trace.records()
    assert (got['name'], got['attrs']) == ('graph.capture', {'kind': 'k'})
    assert trace.intervals() == []           # no interval opened


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, 'CAPACITY', 3)
    trace.set_mode('on')
    with trace.span('a'):
        for _ in range(4):
            with trace.span('b'):
                pass
    assert _names(trace.records()) == ['a', 'b', 'b']
    assert trace.dropped() == 2
    assert all(r['end_ns'] for r in trace.records())
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_an_unknown_mode_raises():
    with pytest.raises(ValueError, match='none of'):
        trace.set_mode('verbose')


def test_an_interval_keeps_the_counters_at_its_ends():
    n0 = trace.snapshot()['noise_bytes']
    trace.set_mode('on')
    trace.count_noise({'a': torch.zeros(3, 5),
                       'b': torch.zeros(2, dtype=torch.int64)})
    trace.set_mode('auto')
    (iv,) = trace.intervals()
    assert iv['start']['noise_bytes'] == n0
    assert iv['stop']['noise_bytes'] == n0 + 3 * 5 * 4 + 2 * 8
    assert iv['start_ns'] <= iv['stop_ns']
    assert set(iv['start']) == {'noise_bytes', 'index_uploads',
                                'h2d_bytes', 'dequant_launches',
                                'augment_launches', 'collectives'}


def test_the_snapshot_reads_the_counters_where_they_live(monkeypatch):
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh
    monkeypatch.setattr(preprocess, 'launches', 11)
    monkeypatch.setattr(preprocess, 'augment_launches', 5)
    monkeypatch.setattr(mesh, 'collectives', 3)
    monkeypatch.setattr(trace, 'noise_bytes', 40)
    monkeypatch.setattr(trace, 'index_uploads', 7)
    monkeypatch.setattr(trace, 'h2d_bytes', 9)
    assert trace.snapshot() == {'noise_bytes': 40, 'index_uploads': 7,
                                'h2d_bytes': 9,
                                'dequant_launches': 11,
                                'augment_launches': 5, 'collectives': 3}


def _chrome_spans(doc):
    return [e for e in doc['traceEvents'] if e['ph'] == 'X']


def test_the_chrome_trace(tmp_path):
    trace.set_mode('on')
    with trace.span('train.dispatch', request=4):
        with trace.span('host.draw'):
            pass
    trace.set_mode('auto')
    path = tmp_path / 't.json'
    trace.write(str(path), rank=2)
    doc = json.loads(path.read_text())
    assert doc['displayTimeUnit'] == 'ms'
    assert doc['otherData']['rank'] == 2 and doc['otherData']['dropped'] == 0
    meta = [e for e in doc['traceEvents'] if e['ph'] == 'M']
    assert meta == [{'name': 'process_name', 'ph': 'M', 'pid': 2, 'tid': 0,
                     'args': {'name': 'rank 2'}}]
    spans = _chrome_spans(doc)
    assert [e['name'] for e in spans] == ['train.dispatch', 'host.draw']
    rec = trace.records()
    for e, r in zip(spans, rec):
        assert e['pid'] == 2 and e['tid'] == 0
        assert e['ts'] == pytest.approx(r['start_ns'] / 1e3)
        assert e['dur'] == pytest.approx((r['end_ns'] - r['start_ns']) / 1e3)
        assert e['args']['request'] == 4
    assert spans[1]['args']['parent'] == 0
    counters = [e for e in doc['traceEvents'] if e['ph'] == 'C']
    assert len(counters) == 2
    assert all('noise_bytes' in e['args'] for e in counters)


# ----------------------------- the profiler -----------------------------
def _ops(prof):
    """(name, start, end) of the profile's events, Unix ns."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_auto_records_under_a_profiler_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('outer', request=1):
            x = torch.randn(256, 256)
            with trace.span('inner'):
                y = x @ x
            z = y.sum()
    assert float(z) == float(z)
    outer, inner = trace.records()
    assert (outer['name'], inner['name']) == ('outer', 'inner')
    ops = _ops(prof)
    names = [n for n, _, _ in ops]
    assert 'outer' in names and 'inner' in names   # the spans' ranges
    slack = 100_000
    for span, op in ((outer, 'aten::randn'), (outer, 'aten::sum'),
                     (inner, 'aten::mm')):
        a, b = next((a, b) for n, a, b in ops if n == op)
        assert span['start_ns'] - slack <= a and b <= span['end_ns'] + slack
    mirror = next((a, b) for n, a, b in ops if n == 'inner')
    assert abs(mirror[0] - inner['start_ns']) < slack
    assert abs(mirror[1] - inner['end_ns']) < slack


def test_a_span_is_a_cpu_op_of_the_profile_not_an_annotation(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('train.dispatch', request=3):
            torch.ones(4).sum()
    path = tmp_path / 'p.json'
    prof.export_chrome_trace(str(path))
    cats = {e.get('cat') for e in json.loads(path.read_text())['traceEvents']
            if e.get('name') == 'train.dispatch'}
    assert cats == {'cpu_op'}      # a user_annotation would lay a range
    # over the device's timeline (gpu_user_annotation) on a card


def test_auto_closes_its_interval_after_the_profiler_stops():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span('a'):
            pass
        trace.count_noise({'e': torch.zeros(4)})
    assert trace.intervals()[0]['stop'] is None
    assert trace.span('after') is trace.NULL
    (iv,) = trace.intervals()
    assert iv['stop']['noise_bytes'] - iv['start']['noise_bytes'] == 16
    assert _names(trace.records()) == ['a']


# ------------------------------- Trainer -------------------------------
def _trainer(tmp_path, name):
    model_cfg, train_cfg = W.configs(perc_supervision=0.5)
    splits = synthetic_splits(n_train=64, n_valid=32, n_test=16,
                              sup_frac=0.5, image_size=16, y_dim=4, seed=0)
    loaders = {k: BatchLoader(v, W.B, seed=0) for k, v in splits.items()}
    t = Trainer(model_cfg, train_cfg,
                mu_init=cooccurrence_gating_matrix(splits['sup'].labels),
                metrics_path=str(tmp_path / name / 'metrics.csv'),
                device='cpu')
    return t, loaders


def _run(tmp_path, name, mode, epochs=2):
    t, loaders = _trainer(tmp_path, name)
    trace.set_mode(mode)
    n0 = trace.noise_bytes
    t.train(loaders, epochs=epochs, log_every=1)
    trace.set_mode('auto')
    return t, loaders, trace.noise_bytes - n0


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """Two epochs of the tiny Trainer with the tracer on and in its
    default mode with no profiler (off): (trainer, loaders, noise bytes,
    records) of each."""
    tmp = tmp_path_factory.mktemp('trace_trainer')
    trace.reset()
    on = _run(tmp, 'on', 'on') + (trace.records(),)
    trace.reset()
    off = _run(tmp, 'off', 'auto') + (trace.records(),)
    trace.reset()
    return on, off


def test_each_dispatch_is_one_span_with_its_draws_and_log(traced):
    (t, loaders, _, rec), _ = traced
    total, _, _ = t.epoch_schedule(loaders)
    dispatches = [i for i, r in enumerate(rec)
                  if r['name'] == 'train.dispatch']
    assert len(dispatches) == 2 * total
    epochs = [i for i, r in enumerate(rec) if r['name'] == 'train.epoch']
    assert len(epochs) == 2
    for i in dispatches:
        inside = [r['name'] for r in rec if r['parent'] == i]
        assert inside.count('host.draw') == 1, inside
        assert inside.count('train.log') == 1, inside
        assert {r['request'] for r in rec if r['parent'] == i} == \
            {rec[i]['request']}
        assert rec[rec[i]['parent']]['name'] == 'train.epoch'
    assert [rec[i]['request'] for i in dispatches] == list(range(2 * total))


def test_each_validation_is_one_pass(traced):
    (_, _, _, rec), _ = traced
    passes = [i for i, r in enumerate(rec) if r['name'] == 'eval.pass']
    assert len(passes) == 2
    assert [rec[i]['request'] for i in passes] == [1, 2]
    for i in passes:
        assert rec[rec[i]['parent']]['name'] == 'train.epoch'
        assert rec[i]['attrs'] == {'kind': 'accuracy', 'resident': True}
        inside = [r['name'] for r in rec if r['parent'] == i]
        assert inside.count('host.draw') == 1
        assert inside[-1] == 'wait.result'


def test_the_cpu_captures_nothing(traced):
    (_, _, _, rec), _ = traced
    names = set(_names(rec))
    assert 'graph.capture' not in names and 'graph.replay' not in names
    assert {'train.batch', 'train.h2d', 'host.fill', 'wait.nan_check',
            'wait.flush', 'resident.copy'} <= names


def test_each_index_copy_is_a_wait_inside_its_h2d(traced):
    """A resident train epoch copies its index rows once, before its
    first dispatch, and each resident pass its own; no dispatch waits.
    Each resident split's one copy at set-up (``resident.copy``: sup,
    unsup, then valid at the first pass) is a wait too."""
    (_, _, _, rec), _ = traced
    waits = [r for r in rec if r['name'] == 'wait.h2d']
    assert all(rec[r['parent']]['name'] == 'train.h2d' for r in waits)
    where = [rec[rec[r['parent']]['parent']]['name'] for r in waits]
    assert [w for w in where if w == 'resident.copy'] == ['resident.copy'] * 3
    waits = [w for w, at in zip(waits, where) if at != 'resident.copy']
    assert [w for w in where if w != 'resident.copy'] == \
        ['train.epoch', 'eval.pass'] * 2
    dispatches = {i for i, r in enumerate(rec)
                  if r['name'] == 'train.dispatch'}
    assert not any(r['parent'] in dispatches for r in rec
                   if r['name'] in ('train.h2d', 'train.batch'))
    for i, r in enumerate(rec):
        if r['name'] == 'train.epoch':
            first = min(j for j in dispatches if rec[j]['parent'] == i)
            copy = next(w for w in waits if rec[w['parent']]['parent'] == i)
            assert copy['end_ns'] <= rec[first]['start_ns']


def test_noise_bytes_are_the_draws_shapes(traced):
    (t, loaders, got, _), (_, _, got_off, _) = traced
    m = t.model.cfg
    b, k, gates = W.B, W.K, 2 * t.model.mu.numel()
    total, _, sup = t.epoch_schedule(loaders)
    per_sup = b * m.z_dim + gates + k * b * m.z_dim
    per_unsup = b * m.z_dim + gates + b * m.y_dim
    per_eval = b * m.z_dim + gates
    valid = loaders['valid'].epoch_batches
    want = 4 * 2 * (sup * per_sup + (total - sup) * per_unsup
                    + valid * per_eval)
    assert got == want
    assert got_off == want          # counted with the tracer off too


def _csv_without_time(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        del r['time']
    return rows


def test_tracing_changes_no_number(traced, tmp_path_factory):
    (on, _, _, _), (off, _, _, _) = traced
    for part in ('model', 'adam_m', 'adam_v'):
        a, b = (getattr(t.state, part) for t in (on, off))
        a, b = ((x.state_dict() if part == 'model' else x) for x in (a, b))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    assert on.state.step == off.state.step == 8
    assert on.state.adam_count == off.state.adam_count == 8
    assert _csv_without_time(on.metrics.path) == \
        _csv_without_time(off.metrics.path)
    assert len(_csv_without_time(on.metrics.path)) > 0


# --------------------------------- CLI ---------------------------------
def test_trace_out_writes_one_chrome_trace(tmp_path):
    from gltvae_torch import cli
    path = tmp_path / 'run.trace.json'
    cli.main(_cli_argv(tmp_path / 'run') + ['--trace-out', str(path)])
    doc = json.loads(path.read_text())
    names = {e['name'] for e in _chrome_spans(doc)}
    assert {'train.epoch', 'train.dispatch', 'host.draw', 'eval.pass',
            'wait.result'} <= names
    assert doc['otherData']['rank'] == 0
    assert trace.mode() == 'auto'            # the run's mode is put back


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('trace_cli')
    path = tmp / 'run.trace.json'
    W.launch('cli', 2, tmp / 'ranks', join=False,
             argv=_cli_argv(tmp / 'run') + ['--trace-out', str(path)])
    return path


@pytest.mark.parametrize('rank', [0, 1])
def test_trace_out_writes_one_file_a_rank(two_ranks, rank):
    path = two_ranks
    assert not path.exists()
    doc = json.loads(path.with_name(f'{path.name}.rank{rank}').read_text())
    assert doc['otherData']['rank'] == rank
    spans = _chrome_spans(doc)
    assert {e['pid'] for e in spans} == {rank}
    names = [e['name'] for e in spans]
    assert names.count('train.epoch') == 1
    assert 'wait.barrier' in names and 'train.h2d' in names
    assert doc['otherData']['counters']['collectives'] > 0


def test_profile_step_records_the_spans_of_its_profiled_run(tmp_path):
    from gltvae_torch import profile_step as P
    rec = P.main(['--device', 'cpu', '--batch-size', '4', '--steps', '2',
                  '--eval-images', '8', '--top', '3', '--mode',
                  'train-step', '--out', str(tmp_path)])
    assert set(rec['spans']) >= {'host.draw', 'host.fill'}
    assert all(v > 0 for v in rec['spans'].values())
    assert not {k['name'] for k in rec['top_kernels']} & set(rec['spans'])
    doc = json.loads(open(rec['spans_trace']).read())
    assert {e['name'] for e in _chrome_spans(doc)} >= {'host.draw'}
    assert trace.mode() == 'auto'
