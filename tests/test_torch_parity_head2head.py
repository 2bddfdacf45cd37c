"""``gltvae_torch.parity_head2head`` against tools/parity_head2head.py.

The port's harness names the leg under test ``port`` where the JAX tool
says ``gltvae`` (results key, compare keys, model dir, report title,
columns and throughput line; its leg's framework is ``gltvae_torch``),
runs ``python -m gltvae_torch.cli`` in place of train.py and ``--device``
in place of ``--platform``. Under that rename map its arguments, commands,
files and printed text equal the JAX tool's: both harnesses run here with
``subprocess.run`` replaced by a fake that writes what reference_runner.py
and the CLI would. Then one real port leg through the CLI in a subprocess
on the CPU."""

import json
import math
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from gltvae_torch import parity_head2head as T
from tools import parity_head2head as J


def _port_argv(argv):
    return ['--device' if a == '--platform' else a for a in argv]


def _renamed(text):
    """The JAX tool's text or file under the rename map."""
    return text.replace('gltvae', 'port').replace(
        '"framework": "port"', '"framework": "gltvae_torch"')


@pytest.mark.parametrize('argv', [
    ['--workdir', 'w'],
    ['--workdir', 'w', '--platform', 'cpu'],
    ['--workdir', 'w', '--epochs', '12', '--bs', '32', '--n', '2100',
     '--sups', '1.0', '0.5', '--modes', 'learnable/inferred',
     '--train-seed', '3', '--tol', '0.05', '--steps-per-dispatch', '4',
     '--report', 'r.md', '--skip-reference'],
    ['--workdir', 'w', '--modes', 'fixed/one-one', 'fixed/inferred',
     '--seed', '2', '--sups', '--platform', 'cuda:1']],
    ids=['defaults', 'platform_cpu', 'every_flag', 'empty_sups'])
def test_parse_args_equals_the_jax_tool(argv):
    j, t = vars(J.parse_args(argv)), vars(T.parse_args(_port_argv(argv)))
    platform, device = j.pop('platform'), t.pop('device')
    assert t == j
    assert device == (platform or 'cuda')       # the port's default device


def test_compare_missing_accuracy_is_na():
    """tests/test_cli.py::test_head2head_compare_missing_accuracy_is_na for
    the port: a leg with no test accuracy gives parity None, never a delta
    against 0.0."""
    ref = {'test_accuracy': None, 'val_accuracy': [0.5, 0.6]}
    port = {'test_accuracy': 0.72, 'val_accuracy': [0.5, 0.61]}
    c = T.compare(ref, port, tol=0.06)
    assert c['parity'] is None and c['test_delta'] is None
    both = T.compare({'test_accuracy': 0.70, 'val_accuracy': [0.6]},
                     port, tol=0.06)
    assert both['parity'] is True and abs(both['test_delta'] - 0.02) < 1e-9


def test_train_seed_plumbing():
    """tests/test_cli.py::test_head2head_train_seed_plumbing for the port:
    --train-seed overrides the training seed and leaves the corpus seed."""
    a = T.parse_args(['--workdir', 'w'])
    assert T.train_seed(a) == 0 and a.train_seed is None
    a = T.parse_args(['--workdir', 'w', '--train-seed', '3'])
    assert T.train_seed(a) == 3 and a.seed == 0


@pytest.mark.parametrize('n_ref,n_port,ref_na,port_na,tol', [
    (12, 12, False, False, 0.06), (30, 12, False, False, 0.06),
    (2, 5, False, False, 0.1), (1, 1, False, False, 0.0),
    (0, 3, False, False, 0.06), (3, 0, False, True, 0.06),
    (4, 4, True, False, 0.06), (0, 0, True, True, 0.5)])
def test_compare_equals_the_jax_tool(n_ref, n_port, ref_na, port_na, tol):
    """Drawn legs, tails of 0-30 val accuracies, missing test accuracies:
    the port's verdict is the JAX tool's with its keys renamed."""
    rng = np.random.RandomState(n_ref * 31 + n_port)
    ref = {'test_accuracy': None if ref_na else float(rng.rand()),
           'val_accuracy': rng.rand(n_ref).tolist()}
    port = {'test_accuracy': None if port_na else float(rng.rand()),
            'val_accuracy': rng.rand(n_port).tolist()}
    j, t = J.compare(ref, port, tol), T.compare(ref, port, tol)
    assert json.dumps(t) == _renamed(json.dumps(j))
    assert math.isnan(t['val_tail_delta']) == (min(n_ref, n_port) == 0)


def _fake_run(calls, na):
    """subprocess.run for both harnesses: records (command, env, cwd) and
    writes what reference_runner.py (its --out-json) or the training CLI
    (result.json) would, drawn from the command's config. With `na` the
    reference leg of a sup 0.5 cell has no test accuracy and the trained
    leg no img/s."""
    def run(cmd, check=True, env=None, cwd=None):
        calls.append((list(cmd), env, cwd))
        arg = lambda f: cmd[cmd.index(f) + 1]
        gate, sub, sup = arg('--gate-type'), arg('--gate-subtype'), \
            float(arg('--sup'))
        epochs, is_ref = int(arg('--epochs')), '--out-json' in cmd
        rng = np.random.RandomState(zlib.crc32(
            f'{gate}{sub}{sup}{arg("--seed")}{epochs}{is_ref}'.encode()))
        val = [round(float(v), 4) for v in rng.rand(epochs)]
        test, rate = round(float(rng.rand()), 4), float(rng.rand() * 100)
        if is_ref:
            leg = {'framework': 'reference-tf', 'gate_type': gate,
                   'gate_subtype': sub, 'sup': sup, 'epochs': epochs,
                   'val_accuracy': val,
                   'test_accuracy': None if na and sup == 0.5 else test,
                   'images_per_sec': rate}
            with open(arg('--out-json'), 'w') as f:
                json.dump(leg, f)
        else:
            name = (f'params_{sup}_{gate}' if gate == 'learnable'
                    else f'params_{sup}_{gate}_{sub}')
            d = os.path.join(arg('--output-dir'), name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, 'result.json'), 'w') as f:
                json.dump({'test_accuracy': test, 'device': 'cpu',
                           'history': [{'val_accuracy': v} for v in val],
                           'images_per_sec': None if na else rate}, f)
        return subprocess.CompletedProcess(cmd, 0)
    return run


@pytest.mark.parametrize('invocations,na,n_ref', [
    ([['--modes', 'learnable/inferred', '--sups', '0.2']], False, 1),
    ([['--sups', '1.0', '0.5'],
      ['--modes', 'fixed/one-one', '--sups', '0.2', '--epochs', '3']],
     False, 7),
    # seed 1's json is reused, seed 2 has none, the last runs unseeded
    ([['--modes', 'fixed/one-one', '--train-seed', '1'],
      ['--modes', 'fixed/one-one', '--train-seed', '1', '--skip-reference'],
      ['--modes', 'fixed/one-one', '--train-seed', '2', '--skip-reference'],
      ['--modes', 'fixed/one-one']], False, 3),
    ([['--modes', 'fixed/inferred', '--sups', '1.0', '0.5']], True, 2),
    ([['--modes', 'fixed/inferred', 'learnable/inferred', '--platform',
       'cpu', '--steps-per-dispatch', '2', '--tol', '0.2']], False, 2)],
    ids=['one_cell', 'merge_two_invocations', 'train_seeds_skip_reference',
         'na_formatting', 'platform_cpu'])
def test_harness_equals_the_jax_tool(monkeypatch, tmp_path, capsys,
                                     invocations, na, n_ref):
    """Both harnesses through the same invocations, each into its own
    workdir: equal reference commands and env, leg commands equal but for
    the entry point and --device, the same --skip-reference reuse and
    merging, and h2h_results.json, the printed text and the report equal
    under the rename map."""
    monkeypatch.setattr(sys, 'path', list(sys.path))   # the JAX tool's insert
    out = {}
    for side, mod in (('jax', J), ('port', T)):
        work = tmp_path / side
        calls = []
        monkeypatch.setattr(subprocess, 'run', _fake_run(calls, na))
        returned = None
        for extra in invocations:
            argv = ['--workdir', str(work), '--n', '14', '--epochs', '2',
                    '--report', str(work / 'report.md')] + extra
            returned = mod.main(_port_argv(argv) if side == 'port' else argv)
        text = capsys.readouterr().out.replace(str(work), 'W')
        out[side] = dict(
            calls=[([a.replace(str(work), 'W') for a in c], env, cwd)
                   for c, env, cwd in calls],
            results=(work / 'h2h_results.json').read_text(),
            report=(work / 'report.md').read_text(), text=text,
            returned=returned)
    jax, port = out['jax'], out['port']
    assert port['results'] == _renamed(jax['results'])
    assert json.loads(port['results']) == port['returned']
    assert port['report'] == _renamed(jax['report'])
    assert port['text'] == _renamed(jax['text'])
    assert 'parity: ' in port['text'] and '| config |' in port['report']
    if na:
        assert '| n/a |' in port['report'] and 'port n/a img/s' in \
            port['report'] and '1 n/a: missing test accuracy' in port['text']
    assert len(port['calls']) == len(jax['calls']) > 0
    refs = 0
    for (jc, jenv, jcwd), (tc, tenv, tcwd) in zip(jax['calls'],
                                                  port['calls']):
        if '--out-json' in jc:                  # the reference leg
            refs += 1
            assert tc == jc and tenv == jenv and tenv['JAX_PLATFORMS'] == \
                'cpu' and tcwd is jcwd is None
            continue
        assert jc[:2] == [sys.executable, os.path.join(J.REPO, 'train.py')]
        assert tc[:3] == [sys.executable, '-m', 'gltvae_torch.cli']
        assert tcwd == jcwd == J.REPO == T.REPO and tenv is jenv is None
        j, t = jc[2:], tc[3:]
        assert t[-2] == '--device'
        if j[-2] == '--platform':
            assert t[-1] == j[-1]
            j = j[:-2]
        else:
            assert t[-1] == 'cuda'
        assert t[:-2] == [a.replace('gltvae_models', 'port_models')
                          for a in j]
    assert refs == n_ref


def test_a_real_port_leg_on_the_cpu(tmp_path, capsys):
    """learnable/inferred sup 0.2, 1 epoch at bs 8 on a 35-image corpus
    (25/5/5), the reference leg reused from a written json: one
    ``python -m gltvae_torch.cli`` subprocess on the CPU."""
    work = tmp_path / 'h2h'
    work.mkdir()
    ref = {'framework': 'reference-tf', 'gate_type': 'learnable',
           'gate_subtype': 'inferred', 'sup': 0.2, 'epochs': 1,
           'val_accuracy': [0.55], 'test_accuracy': 0.56,
           'images_per_sec': 100.0}
    (work / 'ref_learnable_inferred_0.2.json').write_text(json.dumps(ref))
    report = work / 'HEAD2HEAD.md'
    results = T.main(['--workdir', str(work), '--modes',
                      'learnable/inferred', '--sups', '0.2', '--epochs', '1',
                      '--bs', '8', '--n', '35', '--skip-reference',
                      '--steps-per-dispatch', '2', '--device', 'cpu',
                      '--report', str(report)])
    tag = 'learnable/inferred/sup=0.2'
    assert list(results) == [tag] and results[tag]['reference'] == ref
    port = results[tag]['port']
    assert port['framework'] == 'gltvae_torch'
    assert len(port['val_accuracy']) == 1
    assert math.isfinite(port['test_accuracy'])
    with open(work / 'port_models' / 'params_0.2_learnable'
              / 'result.json') as f:
        r = json.load(f)
    assert r['device'] == 'cpu' and r['test_accuracy'] == \
        port['test_accuracy']
    text = report.read_text()
    assert f'| {tag} | 0.560 | {port["test_accuracy"]:.3f} |' in text
    assert 'parity: ' in capsys.readouterr().out
