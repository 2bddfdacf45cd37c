"""Every cell rehearsed on the CPU at a small size through its own
driver: the run's result, the module check, and ``correct`` coming out
false when the timed path is broken underneath (a state left unchanged,
half the batch left out, the exchange between ranks left out, an answer
altered where it is produced), and the control failing the limits.

A rehearsal writes no device metric. The four-rank cell runs four gloo
ranks; a fault reaches them through a ``sitecustomize`` module that the
test puts on their path.
"""

import json
import os
import sys
import textwrap

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import harness as H  # noqa: E402
import run  # noqa: E402
from checks import judge  # noqa: E402

CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, 'workloads')))
SEED = 2 ** 31 + 4242


def small(name):
    """Sizes a CPU run holds: a few batches of 16 an epoch; a test cell's
    split holds enough labels (512 rows of them) that a lower precision
    flips some."""
    if H.load_cell(name).workload['driver'] == 'test_passes':
        return {'n_train': 80, 'n_valid': 24, 'n_test': 512,
                'batch_size': 16, 'trace': {'count': 2}}
    return {'n_train': 80, 'n_valid': 24, 'n_test': 24, 'batch_size': 16,
            'trace': {'skip': 1, 'count': 2}}


def rehearse(name, trace=0):
    """A CPU run of the program at small sizes, in float32: the limits of
    a bf16 cell are set for its full batch on the card, where the mean
    over the batch holds bf16's rounding far under what it is over 16
    rows."""
    return run.execute(name, SEED, 0.5, trace, device='cpu',
                       sizes=dict(small(name), compute_dtype='float32'))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')


@pytest.mark.parametrize('name', CELLS)
def test_a_cell_rehearses_correct(name):
    r = rehearse(name, trace=1)
    assert r['correct'], r['_lines']
    assert r['metrics'] == {}
    assert set(r) >= {'correct', 'attempted', 'failed', 'metrics', 'device',
                      'checks'}
    assert list(r)[-2:] == ['checks', '_lines']
    assert r['attempted'] > 0 and r['failed'] == 0
    assert set(r['checks']) == set(H.load_cell(name).workload['limits'])
    assert not H.forbidden_modules()
    e2e = r['rehearsal']['e2e']
    assert e2e['setup_s'] > 0
    assert json.dumps(r)


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    assert 'gltvae_torch' in {m.split('.')[0] for m in sys.modules}
    assert not H.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'gltvae.config', object())
    assert H.forbidden_modules() == ['gltvae']


def _half_batch(monkeypatch):
    from gltvae_torch.models.ccvae import CCVAE
    sup, unsup = CCVAE.sup_loss, CCVAE.unsup_loss

    def cut(noise, b):
        return {k: (v if k in ('g1', 'g2', 'u1', 'u2') else
                    v[:, :b] if k == 'eps_k' else v[:b])
                for k, v in noise.items()}

    def half_sup(self, x, y, temps, gating_reg=0.0, k=100, noise=None,
                 generator=None):
        b = x.shape[0] // 2
        return sup(self, x[:b], y[:b], temps, gating_reg, k, cut(noise, b),
                   generator)

    def half_unsup(self, x, temps, gating_reg=0.0, noise=None,
                   generator=None):
        b = x.shape[0] // 2
        return unsup(self, x[:b], temps, gating_reg, cut(noise, b),
                     generator)
    monkeypatch.setattr(CCVAE, 'sup_loss', half_sup)
    monkeypatch.setattr(CCVAE, 'unsup_loss', half_unsup)


def _state_unchanged(monkeypatch):
    import gltvae_torch.train.steps as steps
    monkeypatch.setattr(steps, 'keras_adam_update', lambda *a, **k: None)


def _answer_altered(monkeypatch):
    from gltvae_torch.models.ccvae import CCVAE

    def altered(self, x, y, temps, deterministic=False, noise=None,
                generator=None):
        y_hat = self.predict_labels(x, temps, deterministic, noise,
                                    generator)
        y_hat[0] = 1.0 - y[0]
        return torch.mean((y_hat == y.to(y_hat.dtype)).to(torch.float32))
    monkeypatch.setattr(CCVAE, 'classifier_accuracy', altered)


FAULTS = {'state_unchanged': _state_unchanged, 'half_batch': _half_batch,
          'answer_altered': _answer_altered}

#: what each fault does, written into a mesh rank's sitecustomize
RANK_FAULTS = {
    'state_unchanged': '''
        import gltvae_torch.train.steps as steps
        steps.keras_adam_update = lambda *a, **k: None''',
    'half_batch': '''
        from gltvae_torch.models.ccvae import CCVAE
        sup, unsup = CCVAE.sup_loss, CCVAE.unsup_loss
        def cut(noise, b):
            return {k: (v if k in ('g1', 'g2', 'u1', 'u2') else
                        v[:, :b] if k == 'eps_k' else v[:b])
                    for k, v in noise.items()}
        def half_sup(self, x, y, temps, gating_reg=0.0, k=100, noise=None,
                     generator=None):
            b = x.shape[0] // 2
            return sup(self, x[:b], y[:b], temps, gating_reg, k,
                       cut(noise, b), generator)
        def half_unsup(self, x, temps, gating_reg=0.0, noise=None,
                       generator=None):
            b = x.shape[0] // 2
            return unsup(self, x[:b], temps, gating_reg, cut(noise, b),
                         generator)
        CCVAE.sup_loss, CCVAE.unsup_loss = half_sup, half_unsup''',
    'no_exchange': '''
        from gltvae_torch.parallel.dp import DataParallel
        def average(self, grads, metrics):
            return grads, metrics
        DataParallel.average = average''',
}


def cell_faults(name):
    cell = H.load_cell(name)
    if cell.workload['driver'] == 'test_passes':
        return ['answer_altered']
    return ['state_unchanged', 'half_batch'] + (
        ['no_exchange'] if cell.chips > 1 else [])


@pytest.mark.parametrize('name,fault', [(c, f) for c in CELLS
                                        for f in cell_faults(c)])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch,
                                            tmp_path):
    if H.load_cell(name).chips > 1:
        (tmp_path / 'sitecustomize.py').write_text(
            f'import sys\nsys.path.insert(0, {os.path.dirname(HERE)!r})\n'
            + textwrap.dedent(RANK_FAULTS[fault]) + '\n')
        monkeypatch.setenv('PYTHONPATH', str(tmp_path))
    else:
        FAULTS[fault](monkeypatch)
    r = rehearse(name)
    assert not r['correct'], r['_lines']


@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_and_so_does_each_fault(name):
    """The reference put in the program's place, in the next precision
    below the configuration's, and with each fault planted, fails the
    cell's limits at a small size on the CPU (on the chip: control.py at
    the cell's own size)."""
    import control
    limits = H.load_cell(name).workload['limits']
    for who, chk in control.readings(name, SEED, 'cpu', small(name),
                                     passes=20):
        assert not judge(chk, limits)[0], (who, chk)


def test_control_prints_the_comparisons_verdict(capsys, monkeypatch):
    import control
    name, real = 'c64.test', control.readings
    monkeypatch.setattr(control, 'readings', lambda n, s, d, passes: real(
        n, s, d, small(name), passes=passes))
    assert control.main(['--workload', name, '--seeds', str(SEED),
                         '--device', 'cpu', '--passes', '20']) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [d['in_place'] for d in lines] == ['control tf32',
                                              'fault answer_altered']
    assert all(d['correct'] is False for d in lines)


RECORDED = os.path.join(HERE, 'controls')


def recorded():
    """(cell, seed, stand-in, checks) of every reading kept in
    ``controls/``: control.py on the chip at the cell's own size."""
    out = []
    for f in sorted(os.listdir(RECORDED)):
        with open(os.path.join(RECORDED, f)) as fh:
            for line in fh:
                d = json.loads(line)
                out.append((d['cell'], d['seed'], d['in_place'],
                            {k: (v['value'], v['at'])
                             for k, v in d['checks'].items()}))
    return out


def test_every_cell_keeps_its_controls_readings():
    cells = [w['name'] for w in H.benchmark()['workloads']]
    kept = {c for c, _, _, _ in recorded()}
    assert set(cells) <= kept
    for c in cells:
        seeds = {s for n, s, w, _ in recorded()
                 if n == c and w.startswith('control')}
        assert len(seeds) >= 3, c


@pytest.mark.parametrize('name,seed,who,chk', recorded(),
                         ids=[f'{c}-{s}-{w}' for c, s, w, _ in recorded()])
def test_a_recorded_control_reading_is_not_correct(name, seed, who, chk):
    """The control and each fault, as read on the chip, come out not
    correct through the same comparison and limits as a run."""
    correct, _, lines = judge(chk, H.load_cell(name).workload['limits'])
    assert not correct, lines


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_at_the_cells_own_size(name, card):
    import control
    limits = H.load_cell(name).workload['limits']
    for seed in (11, 12, 13):
        for who, chk in control.readings(name, seed, 'cuda'):
            assert not judge(chk, limits)[0], (who, seed, chk)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
