"""``gltvae_torch.repro_reference`` against tools/repro_reference.py: the
9 cells' arguments and their order, under each flag the JAX tool takes
(both sides' CLI ``main`` replaced by a recorder), and one real cell of
the matrix through the port's CLI on a tiny JPEG corpus on the CPU."""

import json
import sys

import pytest
import torch

import train as jax_train
from gltvae_torch import cli as tcli
from gltvae_torch import repro_reference as T
from tools import repro_reference as J

torch.set_num_threads(2)

FLAGS = [[], ['--mesh'], ['--parity'], ['--dtype', 'float32'],
         ['--epochs', '3', '--batch-size', '64', '--output-dir', 'runs'],
         ['--mesh', '--parity', '--dtype', 'float32']]


def _recorder(calls):
    def main(argv):
        calls.append(list(argv))
        sup = float(argv[argv.index('--sup') + 1])
        return {sup: 0.25 + len(calls) / 100}
    return main


@pytest.mark.parametrize('flags', FLAGS, ids=lambda f: ' '.join(f) or
                         'defaults')
def test_cell_argvs_and_order_equal_the_jax_tool(monkeypatch, capsys,
                                                 flags):
    argv = ['--data-dir', '/data/celeba'] + flags
    want, got = [], []
    monkeypatch.setattr(jax_train, 'main', _recorder(want))
    monkeypatch.setattr(sys, 'argv', ['repro_reference.py'] + argv)
    J.main()
    want_text = capsys.readouterr().out
    monkeypatch.setattr(tcli, 'main', _recorder(got))
    results = T.main(argv)
    assert capsys.readouterr().out == want_text
    assert got == want and len(got) == 9
    assert [a for *_, a in T.cell_argvs(T.parse_args(argv))] == want
    assert list(results) == [T.cell_key(g, s, sup) for g, s in
                             J.BASELINE_TABLE1 for sup in T.SUPS]


def test_baseline_table_equals_the_jax_tool():
    assert T.BASELINE_TABLE1 == J.BASELINE_TABLE1


def test_device_is_appended_only_off_the_default():
    args = T.parse_args(['--data-dir', 'd', '--device', 'cpu'])
    default = T.parse_args(['--data-dir', 'd'])
    for (*_, a), (*_, b) in zip(T.cell_argvs(args), T.cell_argvs(default)):
        assert a == b + ['--device', 'cpu']


def test_one_real_cell_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The first cell, fixed/one-one at sup 1.0, for 1 epoch on 32/16/16
    JPEGs (f32, the corpus's split file appended): the JSON record the
    tool prints."""
    from gltvae_torch.data.synthetic import write_celeba_corpus
    corpus = tmp_path / 'celeba'
    write_celeba_corpus(str(corpus), 32, 16, 16, seed=0)
    args = T.parse_args(['--data-dir', str(corpus), '--epochs', '1',
                         '--batch-size', '16', '--dtype', 'float32',
                         '--output-dir', str(tmp_path / 'models'),
                         '--device', 'cpu'])
    key = T.cell_key('fixed', 'one-one', 1.0)
    cells = T.cell_argvs
    monkeypatch.setattr(T, 'cell_argvs', lambda a: cells(a)[:1])
    results = T.run_matrix(args, ['--split-file', 'list_eval_partition.csv',
                                  '--num-workers', '0'])
    assert list(results) == [key]
    rec = results[key]
    assert sorted(rec) == ['reference', 'test_accuracy']
    assert rec['reference'] == 0.814
    assert 0.0 <= rec['test_accuracy'] <= 1.0
    assert json.loads(capsys.readouterr().out) == results
    with open(tmp_path / 'models' / 'params_1.0_fixed_one-one'
              / 'result.json') as f:
        assert json.load(f)['test_accuracy'] == rec['test_accuracy']
