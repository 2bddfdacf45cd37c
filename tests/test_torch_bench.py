"""The port's bench twin (python -m gltvae_torch.bench) against bench.py:
its corpus is byte-equal to tools/bench_data.make_corpus, its inputs are
bench.py's draws (captured from bench.py's own functions, stopped before
any model runs), every bench runs on the CPU at tiny sizes, and main()
prints one JSON line with bench.py's keys minus ``prng`` plus ``device``,
or without CUDA bench.py's error line and exit code 1."""

import ast
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench

from gltvae_torch import bench
from gltvae_torch.data.synthetic import make_bench_corpus

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def bench_py_keys():
    """The keys of the dict bench.py's main() prints."""
    tree = ast.parse((ROOT / 'bench.py').read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, 'id', None) == 'result'
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError('no result dict in bench.py')


def test_bench_corpus_byte_equal_to_tools_bench_data(tmp_path):
    import sys
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        import bench_data
    finally:
        sys.path.remove(str(ROOT / 'tools'))
    got = make_bench_corpus(str(tmp_path / 'port'), 6)
    want = bench_data.make_corpus(str(tmp_path / 'gltvae'), 6)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert (tmp_path / 'port' / 'list_attr_celeba.csv').read_bytes() == \
        (tmp_path / 'gltvae' / 'list_attr_celeba.csv').read_bytes()


class _Stop(Exception):
    pass


def _bench_py_draws(monkeypatch, fn, **kw):
    """(mu, [arrays]) bench.py's `fn` draws, in order: μ as it reaches
    create_train_state, each array of 2 or more dimensions as it reaches
    jnp.asarray. The step factories' products raise _Stop before
    any model runs."""
    import jax.numpy as jnp
    import gltvae.train.state as js
    import gltvae.train.steps as jst
    seen = {'arrays': []}
    real = jnp.asarray

    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray) and a.ndim >= 2:
            seen['arrays'].append(np.array(a))
        return real(a, *args, **kwargs)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(jnp, 'asarray', asarray)
    monkeypatch.setattr(js, 'create_train_state', lambda *a, mu_init, **k: (
        seen.__setitem__('mu', np.array(mu_init)),
        types.SimpleNamespace(params=None))[1])
    # unpacked, so the uint8 rows reach jnp.asarray
    monkeypatch.setattr(jst, 'pack_resident_images', lambda a: a)
    for name in ('make_train_steps', 'make_scan_train_steps',
                 'make_mixed_scan_train_step'):
        monkeypatch.setattr(jst, name, stop)
    for name in ('make_scan_eval_step', 'make_resident_eval_step'):
        monkeypatch.setattr(jst, name, lambda *a, **k: stop)
    with pytest.raises(_Stop):
        fn(**kw)
    return seen['mu'], seen['arrays']


@pytest.mark.parametrize('scan,period', [(0, 0), (3, 0), (4, 2)],
                         ids=['per_step', 'scan', 'semi_sup'])
def test_train_inputs_equal_bench_py_draws(monkeypatch, scan, period):
    mu, arrays = _bench_py_draws(
        monkeypatch, jbench.bench_train_step, batch_size=2, steps=1,
        warmup=1, compute_dtype='float32', scan=scan, semi_sup_period=period)
    ins = bench.train_inputs(np.random.RandomState(0), 2, 64, 18, scan)
    assert np.array_equal(ins.pop('mu'), mu)
    assert len(arrays) == len(ins)
    for got, want in zip(ins.values(), arrays):
        assert got.shape == want.shape and np.array_equal(got, want)


def test_eval_inputs_equal_bench_py_draws(monkeypatch):
    mu, arrays = _bench_py_draws(monkeypatch, jbench.bench_eval,
                                 batch_size=2, scan=3)
    ins = bench.eval_inputs(np.random.RandomState(0), 2, 3)
    assert np.array_equal(ins['mu'], mu)
    assert [a.shape for a in arrays] == [(3, 2, 64, 64, 3), (3, 2, 18)]
    assert np.array_equal(ins['xs'], arrays[0])
    assert np.array_equal(ins['ys'], arrays[1])
    mu, arrays = _bench_py_draws(monkeypatch, jbench.bench_eval_resident,
                                 batch_size=2, n_images=5,
                                 batches_per_dispatch=3)
    ins = bench.resident_eval_inputs(np.random.RandomState(0), 2, 5, 3)
    assert np.array_equal(ins['mu'], mu)
    for k, a in zip(('images', 'labels', 'idxs'), arrays):
        assert np.array_equal(ins[k], a), k


@pytest.mark.parametrize('name,kw', [
    ('bench_train_step', dict(batch_size=2, steps=2, warmup=1,
                              compute_dtype='float32')),
    ('bench_train_step', dict(batch_size=2, steps=1, warmup=1,
                              compute_dtype='bfloat16', scan=3,
                              semi_sup_period=2, input_s2d=True,
                              output_s2d=True)),
    ('bench_train_step', dict(batch_size=2, steps=1, warmup=1,
                              compute_dtype='bfloat16', scan=2,
                              image_size=128, remat='dots')),
    ('bench_eval', dict(batch_size=2, iters=2, scan=2)),
    ('bench_eval_resident', dict(batch_size=2, n_images=6, dispatches=2,
                                 batches_per_dispatch=2)),
    ('bench_trainer_eval', dict(batch_size=2, n_images=6, epochs=1)),
    ('bench_e2e', dict(batch_size=2, n_train=4)),
    ('bench_traversal', dict(n_steps=2, iters=2)),
], ids=['train_per_step_f32', 'train_semi_sup_bf16_s2d', 'train_128_dots',
        'eval', 'eval_resident', 'trainer_eval', 'e2e', 'traversal'])
def test_each_bench_runs_on_the_cpu(name, kw):
    out = getattr(bench, name)(device='cpu', **kw)
    flat = [v for v in (out if isinstance(out, tuple) else (out,))
            if not isinstance(v, dict)]
    assert all(math.isfinite(v) and v > 0 for v in flat), out
    roofs = [v for v in (out if isinstance(out, tuple) else ())
             if isinstance(v, dict)]
    for roof in roofs:
        assert set(roof) == {'step_gflops', 'step_mbytes_accessed',
                             'achieved_tflops_per_sec',
                             'achieved_hbm_gbytes_per_sec'}
        assert roof['step_gflops'] > 0
        assert roof['step_mbytes_accessed'] is None


def test_main_prints_one_json_line_with_bench_py_keys(capsys):
    assert bench.main(['--device', 'cpu', '--batch-size', '2', '--steps',
                       '1', '--warmup', '1', '--scan', '2', '--eval-images',
                       '4', '--e2e-train-images', '4']) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == (bench_py_keys() - {'prng'}) | {'device'}
    nulls = {k for k, v in out.items() if v is None}
    assert nulls == {'peak_hbm_mb', 'peak_hbm_source'}    # no card here
    assert out['backend'] == out['device'] == 'cpu'
    assert out['metric'] == ('ELBO train images/sec/chip (CelebA-64, sup '
                             'step, bs 2, bfloat16)')


def test_main_without_cuda_prints_the_error_line_and_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip('this checks a machine without a CUDA device')
    assert bench.main(['--skip-e2e']) == 1
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {'metric', 'value', 'unit', 'vs_baseline', 'error'}
    assert out['value'] is None and 'CUDA' in out['error']
