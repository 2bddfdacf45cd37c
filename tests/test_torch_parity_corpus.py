"""``gltvae_torch.parity_corpus`` and ``gltvae_torch.seed_panel`` against
tools/parity_corpus.py and tools/seed_panel.py: the corpus byte for byte
(every JPEG and the CSV), the panel's run commands (equal but for the
entry point, ``python -m gltvae_torch.cli`` for train.py, and --device
for --platform), its seed_panel.json and printed table; then one real
1-epoch panel (both --posterior-locs) through the port's CLI in
subprocesses on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gltvae_torch import parity_corpus as T
from gltvae_torch import seed_panel as TP
from tools import parity_corpus as J
from tools import seed_panel as JP


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), 'rb').read()
            for d, _, fs in os.walk(root) for f in fs}


def test_generate_corpus_bytes_equal_the_jax_tool(tmp_path):
    out = {}
    for side, mod in (('jax', J), ('port', T)):
        ids, easy = mod.generate_corpus(str(tmp_path / side), n=64, seed=5)
        out[side] = (ids, easy, _files(tmp_path / side))
    assert out['port'][0] == out['jax'][0]
    assert np.array_equal(out['port'][1], out['jax'][1])
    assert out['port'][2] == out['jax'][2] and len(out['port'][2]) == 65


@pytest.mark.parametrize('seed', [0, 9])
def test_render_and_labels_equal_the_jax_tool(seed):
    a, b = (np.random.RandomState(seed) for _ in range(2))
    ea, fa = J.sample_labels(40, a)
    eb, fb = T.sample_labels(40, b)
    assert np.array_equal(ea, eb) and np.array_equal(fa, fb)
    for y in ea[:4]:
        assert np.array_equal(J.render_image(y, a), T.render_image(y, b))


def _fake_run(calls):
    """subprocess.run for the panel: records the command and writes the
    result.json the CLI would."""
    def run(cmd, check, cwd):
        calls.append(list(cmd))
        arg = lambda f: cmd[cmd.index(f) + 1]
        sup, gate = arg('--sup'), arg('--gate-type')
        name = (f'params_{float(sup)}_{gate}' if gate == 'learnable' else
                f'params_{float(sup)}_{gate}_{arg("--gate-subtype")}')
        d = os.path.join(arg('--output-dir'), name)
        os.makedirs(d, exist_ok=True)
        seed = int(arg('--seed'))
        with open(os.path.join(d, 'result.json'), 'w') as f:
            json.dump({'test_accuracy': 0.5 + seed / 100 + len(calls) / 1000,
                       'history': [{'val_accuracy': 0.5}]}, f)
        return subprocess.CompletedProcess(cmd, 0)
    return run


@pytest.mark.parametrize('flags', [
    [], ['--platform', 'cpu'],
    ['--gate-type', 'learnable', '--sup', '0.5', '--seeds', '3', '4'],
    ['--locs', 'linear', '--epochs', '2', '--bs', '8', '--n', '35',
     '--steps-per-dispatch', '2', '--corpus-seed', '1']],
    ids=['defaults', 'platform_cpu', 'learnable_sup0.5', 'linear_small'])
def test_panel_commands_equal_the_jax_tool(monkeypatch, tmp_path, capsys,
                                           flags):
    flags = ['--seeds', '0', '1'] + flags
    if '--n' not in flags:
        flags += ['--n', '21']
    out = {}
    for side, mod in (('jax', JP), ('port', TP)):
        calls = []
        monkeypatch.setattr(subprocess, 'run', _fake_run(calls))
        work = tmp_path / side
        argv = ['--workdir', str(work)] + [
            '--device' if f == '--platform' and side == 'port' else f
            for f in flags]
        mod.main(argv)
        mod.main(argv)                  # every tag cached the second time
        text = capsys.readouterr().out.replace(str(work), 'W')
        with open(work / 'seed_panel.json') as f:
            panel = json.load(f)
        out[side] = ([[a.replace(str(work), 'W') for a in c] for c in calls],
                     panel, text)
    (jc, jpanel, jtext), (tc, tpanel, ttext) = out['jax'], out['port']
    assert tpanel == jpanel and ttext == jtext and 'cached' in ttext
    assert len(tc) == len(jc) > 0
    for j, t in zip(jc, tc):
        assert j[:2] == [sys.executable, os.path.join(JP.REPO, 'train.py')]
        assert t[:3] == [sys.executable, '-m', 'gltvae_torch.cli']
        j, t = j[2:], t[3:]
        device = t[-2:]
        assert device[0] == '--device'
        if j[-2:-1] == ['--platform']:
            assert j[-1] == device[1]
            j = j[:-2]
        else:
            assert device[1] == 'cuda'       # the port's default device
        assert t[:-2] == j


def test_a_real_one_epoch_panel_on_the_cpu(tmp_path, capsys):
    """1 seed x both --posterior-locs, 1 epoch, 25/5/5 images: two CLI
    subprocesses on the CPU; each test accuracy lands in the json and the
    table."""
    work = tmp_path / 'panel'
    results = TP.main(['--workdir', str(work), '--seeds', '0', '--n', '35',
                       '--epochs', '1', '--bs', '8',
                       '--steps-per-dispatch', '2', '--device', 'cpu'])
    assert sorted(results) == ['locs=linear/seed=0', 'locs=relu/seed=0']
    for tag, r in results.items():
        assert 0.0 <= r['test_accuracy'] <= 1.0 and len(r['val_accuracy']) \
            == 1
        with open(work / f'models_{r["locs"]}_s0'
                  / 'params_1.0_fixed_one-one' / 'result.json') as f:
            assert json.load(f)['test_accuracy'] == r['test_accuracy']
    table = capsys.readouterr().out.split('| seed |')[1]
    assert f'{results["locs=relu/seed=0"]["test_accuracy"]:.3f}' in table
