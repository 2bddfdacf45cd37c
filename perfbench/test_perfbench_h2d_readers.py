"""The readers of the streamed train path (``metrics/h2d_roofline.train``
and ``metrics/batch_ms_per_step.train``): their arithmetic on made-up
records for one rank and for two, nothing where the program lacks the
counter or nothing was copied or gathered, and a value from each on a
tiny streamed Trainer traced on the CPU."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness as H  # noqa: E402

from gltvae_torch import trace  # noqa: E402

PEAK = 64e9


def _reader(name):
    return H.load_module(os.path.join(HERE, 'metrics', f'{name}.py'),
                         'h2d_' + name.replace('.', '_'))


def _iv(rank, start, stop):
    return {'start_ns': 1000, 'stop_ns': None if stop is None else 4000,
            'start': {'noise_bytes': 0, 'h2d_bytes': start},
            'stop': None if stop is None else {'noise_bytes': 0,
                                               'h2d_bytes': stop},
            'rank': rank}


def _rec(*h2d_ns, window_ns=2000, steps=2):
    return {'kind': 'train',
            'traces': [{'window_ns': window_ns, 'steps': steps, 'h2d_ns': n}
                       for n in h2d_ns]}


# --------------------------- h2d_roofline.train ---------------------------
def test_the_roofline_of_one_rank(monkeypatch):
    """128 MB shipped in the segment take 2 ms at 64 GB/s; the trace's
    copies took 20 ms: 10%."""
    monkeypatch.setattr(trace, 'intervals',
                        lambda: [_iv(0, 5, 5), _iv(0, 10, 10 + 128 * 10**6)])
    got = _reader('h2d_roofline.train').read(_rec(20 * 10**6))
    assert got == pytest.approx(100 * 128e6 / PEAK / 0.020)
    assert got == pytest.approx(10.0)


def test_the_roofline_reads_an_open_interval_at_the_snapshot(monkeypatch):
    monkeypatch.setattr(trace, 'intervals', lambda: [_iv(0, 10, None)])
    monkeypatch.setattr(trace, 'h2d_bytes', 10 + 64 * 10**6)
    assert _reader('h2d_roofline.train').read(_rec(10**7)) == \
        pytest.approx(10.0)


def test_the_roofline_takes_the_largest_rank(monkeypatch):
    """Each rank's last interval against its own trace."""
    ivs = [_iv(0, 0, 64 * 10**6), _iv(1, 0, 64 * 10**6)]
    monkeypatch.setattr(trace, 'intervals', lambda: ivs)
    read = _reader('h2d_roofline.train').read
    assert read(_rec(10**7, 4 * 10**6)) == pytest.approx(25.0)
    assert read(_rec(4 * 10**6, 10**7)) == pytest.approx(25.0)
    ivs[1] = _iv(1, 0, 16 * 10**6)
    assert read(_rec(10**7, 4 * 10**6)) == pytest.approx(10.0)


@pytest.mark.parametrize('case', ['no counter', 'nothing shipped',
                                  'no copy traced', 'no interval',
                                  'eval record'])
def test_the_roofline_reads_nothing(case, monkeypatch):
    iv = _iv(0, 10, 10 + 64 * 10**6)
    rec = _rec(10**7)
    if case == 'no counter':                 # a program before the counter
        for k in ('start', 'stop'):
            del iv[k]['h2d_bytes']
    elif case == 'nothing shipped':
        iv['stop']['h2d_bytes'] = 10
    elif case == 'no copy traced':
        rec = _rec(0)
    elif case == 'eval record':
        rec['kind'] = 'eval'
    monkeypatch.setattr(trace, 'intervals',
                        lambda: [] if case == 'no interval' else [iv])
    assert _reader('h2d_roofline.train').read(rec) is None


# ------------------------- batch_ms_per_step.train -------------------------
def _span(name, a, b, parent=-1, rank=0):
    return {'name': name, 'start_ns': a, 'end_ns': b, 'parent': parent,
            'request': 0, 'rank': rank, 'attrs': {}}


@pytest.fixture
def made_up(monkeypatch):
    """A segment from 1,000 ns that lasts 2,000 ns: a resident epoch's
    rows drawn before its dispatches (not a dispatch's), two streamed
    dispatches, the first gathering from before the segment, the second
    still gathering when it ends, and a gather of another rank."""
    recs = [
        _span('train.epoch', 500, 5000),                # 0
        _span('train.batch', 600, 1400, 0),             # 1: the epoch's
        _span('train.dispatch', 900, 1800, 0),          # 2
        _span('train.batch', 900, 1100, 2),             # 3: clipped to 100
        _span('train.h2d', 1100, 1500, 2),              # 4
        _span('train.dispatch', 1800, 0, 0),            # 5: still open
        _span('train.batch', 2900, 0, 5),               # 6: clipped to 100
        _span('train.dispatch', 1000, 2000, rank=1),    # 7
        _span('train.batch', 1200, 1350, 7, rank=1),    # 8: 150
    ]
    monkeypatch.setattr(trace, 'records', lambda: recs)
    monkeypatch.setattr(trace, 'intervals', lambda: [_iv(0, 0, 0)])
    return recs


def test_the_gathers_of_one_rank(made_up):
    del made_up[7:]
    got = _reader('batch_ms_per_step.train').read(_rec(0))
    assert got == pytest.approx((100 + 100) / 1e6 / 2)


def test_the_gathers_take_the_largest_rank(made_up):
    read = _reader('batch_ms_per_step.train').read
    assert read(_rec(0)) == pytest.approx(200 / 1e6 / 2)
    made_up[8]['end_ns'] = 1450
    assert read(_rec(0)) == pytest.approx(250 / 1e6 / 2)


def test_gathers_outside_a_dispatch_are_not_counted(made_up):
    """A resident run's only gather is its epoch's rows."""
    del made_up[2:]
    assert _reader('batch_ms_per_step.train').read(_rec(0)) is None


def test_the_gathers_read_nothing_without_a_segment(made_up, monkeypatch):
    read = _reader('batch_ms_per_step.train').read
    assert read({'kind': 'train', 'traces': []}) is None
    assert read(dict(_rec(0), kind='eval')) is None
    monkeypatch.setattr(trace, 'intervals', lambda: [])
    assert read(_rec(0)) is None


@pytest.mark.parametrize('name', ['h2d_roofline.train',
                                  'batch_ms_per_step.train'])
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    import gltvae_torch
    monkeypatch.delattr(gltvae_torch, 'trace')
    monkeypatch.setitem(sys.modules, 'gltvae_torch.trace', None)
    assert _reader(name).read(_rec(10**7)) is None


# ------------------------- a streamed CPU Trainer -------------------------
def test_both_readers_read_a_streamed_trainer_under_the_profiler():
    """A tiny Trainer that streams its splits, one epoch under the CPU
    profiler: the gathers read above 0, and the roofline reads the
    counter's bytes over the copy time given."""
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gltvae_torch.config import ModelConfig, TrainConfig
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    rng = np.random.RandomState(0)

    def split(n):
        return ArrayDataset(rng.randint(0, 256, (n, 16, 16, 3), np.uint8),
                            (rng.rand(n, 4) < 0.5).astype(np.float32))
    loaders = {k: BatchLoader(split(n), 8, seed=0)
               for k, n in (('sup', 16), ('unsup', 32), ('valid', 16))}
    t = Trainer(ModelConfig(image_size=16, z_dim=5, y_dim=4,
                            enc_features=(4, 8), enc_hidden=6,
                            dec_features=(8, 4)),
                TrainConfig(batch_size=8, perc_supervision=0.3,
                            classifier_mc_samples=3),
                mu_init=cooccurrence_gating_matrix(
                    loaders['sup'].dataset.labels), device='cpu', resident_train='off', resident_eval='off')
    trace.reset()
    torch.set_num_threads(1)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        t.train(loaders, epochs=1)
        window = time.time_ns() - t0
    t.train(loaders, epochs=1)                  # closes the interval
    (iv,) = trace.intervals()
    shipped = iv['stop']['h2d_bytes'] - iv['start']['h2d_bytes']
    steps = 6                                   # 2 sup + 4 unsup batches
    assert shipped == (steps + 2) * 8 * (16 * 16 * 3 + 4 * 4)
    rec = _rec(10**6, window_ns=window, steps=steps)
    assert _reader('batch_ms_per_step.train').read(rec) > 0.0
    assert _reader('h2d_roofline.train').read(rec) == \
        pytest.approx(100 * shipped / PEAK / 1e-3)
    trace.reset()
