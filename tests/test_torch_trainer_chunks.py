"""Multi-step dispatch and augmented training in the gltvae_torch Trainer
(small model, 16 px, bs 8, on the CPU).

A chunk is a loop over the same steps with the same draws, so params and
metrics.csv must be bit-identical for any steps_per_dispatch (gltvae's own
test allows rtol 1e-5 for its scan's float association; the port needs
none)."""

import csv

import numpy as np
import pytest
import torch

from tests.test_torch_config_bridge import small_configs

import gltvae_torch.config as tcfg
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train.loop import Trainer

torch.set_num_threads(2)

BS, PAD = 8, 2


def _run(tmp_path, sup, spd, pad=PAD, train_pad=PAD, epochs=1, n_train=64):
    _, tm = small_configs()
    splits = synthetic_splits(n_train=n_train, n_valid=16, n_test=16,
                              sup_frac=sup, image_size=16, y_dim=4,
                              learnable_signal=True, train_pad=train_pad)
    loaders = {k: BatchLoader(v, BS, seed=0) for k, v in splits.items()}
    mu = cooccurrence_gating_matrix(
        splits['sup' if 'sup' in splits else 'unsup'].labels)
    name = f'sup{sup}_spd{spd}_pad{pad}'
    t = Trainer(tm, tcfg.TrainConfig(batch_size=BS, perc_supervision=sup,
                                     n_epochs=epochs, augment_pad=pad,
                                     classifier_mc_samples=4),
                mu_init=mu, steps_per_dispatch=spd, device='cpu',
                metrics_path=str(tmp_path / name / 'metrics.csv'))
    augments = []
    real = t._augment
    t._augment = lambda u8: augments.append(tuple(u8.shape)) or real(u8)
    t.train(loaders, log_every=1)
    with open(tmp_path / name / 'metrics.csv') as f:
        rows = [{k: v for k, v in r.items() if k != 'time'}
                for r in csv.DictReader(f)]
    return t, rows, augments


@pytest.mark.parametrize('sup,pad', [(1.0, PAD), (0.5, PAD), (0.5, 0)])
def test_params_and_metrics_bit_identical_for_any_steps_per_dispatch(
        tmp_path, sup, pad):
    one, rows1, aug1 = _run(tmp_path, sup, 1, pad=pad, train_pad=pad)
    four, rows4, aug4 = _run(tmp_path, sup, 4, pad=pad, train_pad=pad)
    assert one.state.step == four.state.step == 8
    for (n, a), b in zip(one.model.state_dict().items(),
                         four.model.state_dict().values()):
        assert torch.equal(a, b), n
    for n in one.state.adam_m:
        assert torch.equal(one.state.adam_m[n], four.state.adam_m[n])
    assert len(rows1) == 8 and rows1 == rows4
    if pad:
        size = 16 + 2 * pad
        assert aug1 == [(BS, size, size, 3)] * 8
        assert aug4 == [(4, BS, size, size, 3)] * 2   # one launch a chunk
    else:
        assert aug1 == aug4 == []


@pytest.mark.parametrize('flags,spd,mixed,want', [
    ([True, False] * 4, 4, True, [4, 4]),
    ([True, False] * 4, 1, True, [1] * 8),
    ([True] * 5 + [False] * 4, 4, False, [4, 1, 4]),
    ([True] * 7, 3, False, [3, 3, 1]),
    ([True, False, False, False, False] * 2, 4, True, [4, 4, 2]),
    ([False] * 5, 8, False, [5]),
    ([True, True, False, True], 4, False, [2, 1, 1])])
def test_chunk_cuts_follow_gltvae_rule(flags, spd, mixed, want):
    """gltvae/train/loop.py:391-405: up to steps_per_dispatch steps; a
    uniform (not mixed) chunk stops at the first flip of kind."""
    assert Trainer._chunk_sizes(flags, spd, mixed) == want


def test_trainer_dispatches_mixed_chunks_only_for_period_over_1(tmp_path):
    """sup 1.0 has period 1: uniform chunks, cut at the epoch's end."""
    t, _, aug = _run(tmp_path, 1.0, 3)
    assert t.state.step == 8 and [s[0] for s in aug] == [3, 3, 2]


@pytest.mark.parametrize('spd', [1, 4])
def test_augment_pad_desync_raises_before_any_launch(tmp_path, spd):
    with pytest.raises(ValueError, match='augment_pad desync'):
        _run(tmp_path, 0.5, spd, pad=PAD, train_pad=0)


def test_cli_trains_augmented_chunks_on_cpu(tmp_path):
    import json
    from gltvae_torch import cli
    out = cli.main(['--synthetic', '--do-train', '--augment-pad', '2',
                    '--steps-per-dispatch', '4', '--device', 'cpu',
                    '--synthetic-n', '64', '-bs', '16', '--epochs', '1',
                    '--sup', '0.5', '--output-dir', str(tmp_path)])
    run = tmp_path / 'params_0.5_learnable'
    result = json.loads((run / 'result.json').read_text())
    assert result['test_accuracy'] == pytest.approx(out[0.5])
    assert 0.0 <= out[0.5] <= 1.0 and len(result['history']) == 1
    with open(run / 'metrics.csv') as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and np.isfinite(float(rows[0]['loss']))


@pytest.mark.parametrize('kind,flags', [
    ('mixed', [True, False, True]), ('mixed', [False, True, True]),
    ('scan', [True] * 3), ('scan', [False] * 3)])
def test_chunk_steps_equal_per_step_calls(kind, flags):
    """make_mixed_scan_train_step / make_scan_train_steps on a stacked
    batch == the per-step steps in a loop, params and metrics bit for bit."""
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import (make_mixed_scan_train_step,
                                          make_scan_train_steps,
                                          make_train_steps)
    _, tm = small_configs()
    cfg = tcfg.TrainConfig(batch_size=BS, classifier_mc_samples=4)
    rng = np.random.RandomState(3)
    xs = torch.from_numpy(rng.randint(0, 256, (3, BS, 16, 16, 3),
                                      dtype=np.uint8))
    ys = torch.from_numpy((rng.rand(3, BS, 4) > 0.5).astype(np.float32))

    def fresh():
        model = init_model(tm, cfg, np.eye(4, dtype=np.float32))
        return model, create_train_state(model, cfg)

    model, state = fresh()
    sup, unsup = make_train_steps(model, cfg)
    want = []
    for x, y, f in zip(xs, ys, flags):
        state, m = (sup if f else unsup)(state, x, y, 1.0)
        want.append(m)

    c_model, c_state = fresh()
    if kind == 'mixed':
        c_state, got = make_mixed_scan_train_step(c_model, cfg)(
            c_state, xs, ys, flags, 1.0)
    else:
        scan_sup, scan_unsup = make_scan_train_steps(c_model, cfg)
        c_state, got = (scan_sup if flags[0] else scan_unsup)(
            c_state, xs, ys, 1.0)
    assert c_state.step == 3
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    for (n, a), b in zip(model.state_dict().items(),
                         c_model.state_dict().values()):
        assert torch.equal(a, b), n
