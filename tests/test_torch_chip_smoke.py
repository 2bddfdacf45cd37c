"""chip_smoke.py's card-vs-CPU check (``card_vs_cpu``), on the CPU.

Both of its runs go to the CPU here, so they agree bit for bit. A fault
planted in the first ("card") run only must trip the check: a wrong
learning rate through the Adam-step limit, and gradients 5% off through
the Adam m and v limit (Adam's move barely changes when every gradient is
scaled, so a params limit alone would miss it). Phase 14's bf16 check
(bf16, both s2d flags, remat 'dots', the batch gathered from a resident
split) must catch a dropped bias within the tolerances measured on the
card."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import gltvae_torch.config as tcfg
import gltvae_torch.train.steps as tsteps
from gltvae_torch.ops import preprocess

torch.set_num_threads(2)

B, S, PAD = 8, 16, 2


def _card_vs_cpu(monkeypatch, lr_scale=1.0, grad_scale=1.0, bf16=None):
    monkeypatch.setattr(chip_smoke, 'BATCH', B)
    failed = []
    monkeypatch.setattr(chip_smoke, 'check',
                        lambda ok, msg: ok or failed.append(msg))
    models = []
    real_make, real_adam = tsteps.make_train_steps, tsteps.keras_adam_update

    def make_train_steps(model, train_cfg):
        models.append(model)
        if len(models) == 1:
            train_cfg = dataclasses.replace(train_cfg,
                                            lr=train_cfg.lr * lr_scale)
            if bf16 is not None:
                model.classifier.forward = bf16(model.classifier)
        return real_make(model, train_cfg)

    def keras_adam_update(state, grads, lr, **kw):
        if state.model is models[0]:
            grads = {k: g * grad_scale for k, g in grads.items()}
        real_adam(state, grads, lr, **kw)

    monkeypatch.setattr(tsteps, 'make_train_steps', make_train_steps)
    monkeypatch.setattr(tsteps, 'keras_adam_update', keras_adam_update)
    model_cfg = tcfg.ModelConfig(image_size=S, z_dim=8, y_dim=4,
                                 enc_features=(8, 8), enc_hidden=16,
                                 dec_features=(16, 8))
    train_cfg = tcfg.TrainConfig(batch_size=B, augment_pad=PAD)
    kw = dict(draws=_draws())
    y_dim, size = 4, S
    if bf16 is not None:        # phase 14's bf16 check, resident gather
        # CelebA-64's image size and labels at narrow widths: the recon
        # term, which the importance weight multiplies, at its real size
        y_dim, size = 18, 64
        model_cfg = tcfg.ModelConfig(
            image_size=size, z_dim=24, y_dim=y_dim, enc_features=(8,) * 4,
            enc_hidden=16, dec_features=(16, 8, 8, 8),
            compute_dtype='bfloat16', input_s2d=True, output_s2d=True)
        train_cfg = tcfg.TrainConfig(batch_size=B, remat='dots',
                                     classifier_mc_samples=8)
        kw = dict(resident=True, tol=chip_smoke.BF16_TOL)
    pad = 0 if bf16 is not None else PAD
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (B, size + 2 * pad, size + 2 * pad, 3))
                .astype(np.uint8), (rng.rand(B, y_dim) > 0.5)
                .astype(np.float32)) for _ in range(2)]
    mu = np.full((y_dim, y_dim), 0.5, np.float32)
    worst = chip_smoke.card_vs_cpu(0, 'test', model_cfg, train_cfg, mu,
                                   batches, torch.device('cpu'),
                                   lambda: None, **kw)
    return worst, failed


def _draws():
    g = torch.Generator().manual_seed(2)
    return [torch.stack(v) for v in zip(*(
        preprocess.draw_crop_flip(g, B, S + 2 * PAD, S + 2 * PAD, S)
        for _ in range(2)))]


def _bias_dropped(clf):
    real = clf.forward
    return lambda z, gates: real(z, gates) - clf.bias


def test_identical_runs_agree_bit_for_bit(monkeypatch):
    worst, failed = _card_vs_cpu(monkeypatch)
    assert failed == []
    assert worst == dict(metrics=0.0, adam_m=0.0, adam_v=0.0, adam_m_l2=0.0,
                         adam_v_l2=0.0, adam_step=0.0, params=0.0)


@pytest.mark.parametrize('fault,caught', [
    (dict(lr_scale=1.5), 'not the Adam step of its moments'),
    (dict(grad_scale=1.05), 'Adam moments disagree'),
])
def test_a_fault_in_the_card_run_fails_the_check(monkeypatch, fault, caught):
    worst, failed = _card_vs_cpu(monkeypatch, **fault)
    assert len(failed) == 1 and caught in failed[0], failed


def test_identical_bf16_runs_agree_bit_for_bit(monkeypatch):
    worst, failed = _card_vs_cpu(monkeypatch, bf16=lambda clf: clf.forward)
    assert failed == [] and not any(worst.values())


def test_the_bf16_check_catches_a_dropped_bias(monkeypatch):
    """Phase 14's bf16 tolerances (BF16_TOL, measured on the card) catch
    the classifier's bias dropped in the card run. A subtler fault, the
    classifier's product rounded to bf16, moves this model's metrics by
    2.7e-5 rel and its gradient by 2.9e-3 rel L2: inside the card's own
    bf16 noise, so tests/test_torch_bf16.py holds that product to gltvae's
    at rtol 1e-5 instead."""
    worst, failed = _card_vs_cpu(monkeypatch, bf16=_bias_dropped)
    assert failed and all('disagree' in f for f in failed), failed
    assert worst['metrics'] > chip_smoke.BF16_TOL['metrics']


def _rehearse(monkeypatch, tmp_path):
    """Set chip_smoke up to run on the CPU at a tiny corpus (64/16/16 JPEGs,
    batch 8: the same launch counts as 2,048/512/512 at 256), then run
    phases 16-22."""
    _on_the_cpu(monkeypatch, tmp_path)
    return chip_smoke.celeba_phases(torch.device('cpu'), 'cpu')


def _on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke at batch 8 under `tmp_path`. On the CPU the wrappers take
    the plain versions and count nothing, so each call where the card
    would launch is counted here."""
    import gltvae_torch.train.steps as ts
    monkeypatch.setattr(chip_smoke, 'BATCH', 8)
    monkeypatch.setattr(chip_smoke, 'CORPUS', (64, 16, 16))
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    dq, aug = preprocess.dequant, preprocess._augment

    def counted_dequant(u8, *a, **k):
        preprocess.launches += 1
        return dq(u8, *a, **k)

    def counted_augment(*a, **k):
        preprocess.augment_launches += 1
        return aug(*a, **k)
    monkeypatch.setattr(preprocess, 'dequant', counted_dequant)
    monkeypatch.setattr(ts, 'dequant', counted_dequant)
    monkeypatch.setattr(preprocess, '_augment', counted_augment)


def test_celeba_phases_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """Phases 16-22 end to end on the CPU at a tiny corpus."""
    out = _rehearse(monkeypatch, tmp_path)
    assert (out['celeba'], out['celeba_augment'], out['device_resize'],
            out['infer']) == ((22, 0), (6, 4), (12, 0), 2)
    assert {'pil 64px 1 thread', 'cv2 full 1 thread'} <= set(
        out['decode_rates'])


def test_serving_phases_rehearse_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phases 23-26 on the CPU from phase 18's tiny run: the .h5 inference,
    the warm start's test and preprocess_batch launch where the card
    would (2 test batches, 2 preprocess_batch calls), and each phase's
    check passes; the timing loops run one call each."""
    celeba = _rehearse(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, 'median_ms',
                        lambda fn, dev, warmup=3, calls=20: (fn(), 1.0)[1])
    out = chip_smoke.serving_phases(torch.device('cpu'), 'cpu', celeba)
    assert out == {'infer_h5': 2, 'warm_start': 2, 'preprocess_batch': 2}
    printed = capsys.readouterr().out
    for n in (23, 24, 25, 26):
        assert f'[phase {n}]' in printed
    assert 'slice_traversal:' in printed and 'slice_serving:' in printed
    assert 'skipped' not in printed.split('[phase 24]')[1].split('\n')[0]


def test_host_phases_rehearse_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phases 27-29 on the CPU from the tiny corpus: the synthetic CLI run
    launches where the card would with and without --tensorboard
    --debug-nans (16 steps + 24 eval batches at batch 8), its events equal
    metrics.csv, the NaN weight raises; the grain run launches 12 (8 steps
    + 4 eval batches) and each loader's first epoch is a permutation; the
    bench prints its line with every key set that the CPU can set."""
    celeba = _rehearse(monkeypatch, tmp_path)
    out = chip_smoke.host_phases(torch.device('cpu'), 'cpu', celeba)
    assert out['debug_nans'] == 40 and out['grain'] == 12
    assert out['bench'] > 0
    printed = capsys.readouterr().out
    for n in (27, 28, 29):
        assert f'[phase {n}]' in printed
    for line in ('slice_debug_nans:', 'slice_grain:', 'bench: {'):
        assert line in printed


def test_dp_phases_rehearse_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phases 30-31 on the CPU at batch 8 (64/16/16 rows: phase 5's 16
    steps and 6 eval batches): the mesh of one (gloo here, NCCL on the
    card) equals the plain run bit for bit with its 22 launches; two
    spawned gloo ranks (which count the plain calls themselves) launch 22
    a rank on the resident path and 4 augment + 6 dequant on the augmented
    one, crop their rows of the one-process crops, and hold phase 31's
    tolerances."""
    from gltvae_torch.data.synthetic import synthetic_splits
    _on_the_cpu(monkeypatch, tmp_path)
    cpu = torch.device('cpu')
    model_cfg = tcfg.ModelConfig(image_size=S, z_dim=8, y_dim=4,
                                 enc_features=(8, 8), enc_hidden=16,
                                 dec_features=(16, 8))
    kw = dict(perc_supervision=0.5, n_epochs=2, batch_size=B,
              classifier_mc_samples=4)
    train_cfg = tcfg.TrainConfig(**kw)
    train_a = tcfg.TrainConfig(augment_pad=4, **kw)
    splits, splits_a = (synthetic_splits(
        n_train=8 * B, n_valid=2 * B, n_test=2 * B, sup_frac=0.5,
        image_size=S, y_dim=4, train_pad=pad) for pad in (0, 4))
    run = chip_smoke.train_and_test('main path', model_cfg, train_cfg,
                                    splits, cpu, 'chip_smoke')
    ref5 = dict(state=run['trainer'].state.state_dict(), rows=run['rows'],
                launches=run['launches'], step_med=1.0)
    out = chip_smoke.dp_phases(cpu, 'cpu', ref5, model_cfg, train_cfg,
                               splits, model_cfg, train_a, splits_a)
    assert out == {'nccl_1': 22, 'gloo_2': 22, 'gloo_2_augment': (4, 6)}
    printed = capsys.readouterr().out
    assert '[phase 30]' in printed and printed.count('[phase 31]') == 4
    assert 'slice_mesh1:' in printed and 'slice_dp:' in printed


def test_experiment_phases_rehearse_on_the_cpu(monkeypatch, tmp_path,
                                               capsys):
    """Phases 32-34 on the CPU from the tiny corpus and phase 18's tiny
    run: the μ files bit-equal to ops/gating.py's, the 9 matrix cells
    launching where the card would (steps + 4 eval batches each: 111 at
    64/16/16 and batch 8, as at 2,048/512/512 and 256), and the seed
    panel's two CLI subprocesses."""
    celeba = _rehearse(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, 'PANEL_N', 35)
    monkeypatch.setattr(chip_smoke, 'PANEL_BS', 8)
    out = chip_smoke.experiment_phases(torch.device('cpu'), 'cpu', celeba)
    assert out == {'matrix': 111, 'seed_panel': None}
    printed = capsys.readouterr().out
    for n in (32, 33, 34):
        assert f'[phase {n}]' in printed
    assert 'matrix: {' in printed


def test_measure_phases_rehearse_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phases 35-36 on the CPU at batch 8: bench_data's rows and its
    ship+step launches (warm-up + 2 steps, twice), each profile mode's
    launches (12 dispatches of 1 step, 2 steps or 2 eval batches) and the
    summary with all four modes."""
    import functools
    from gltvae_torch import bench_data
    _on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, 'BENCH_DATA_N', 32)
    monkeypatch.setattr(chip_smoke, 'SHIP_ITERS', 2)
    monkeypatch.setattr(chip_smoke, 'PROFILE_EVAL_IMAGES', 16)
    monkeypatch.setattr(chip_smoke, 'PROFILE_SCAN', 2)
    monkeypatch.setattr(bench_data, 'bench_ship_and_step', functools.partial(
        bench_data.bench_ship_and_step, batch_size=8, iters=2))
    out = chip_smoke.measure_phases(torch.device('cpu'), 'cpu')
    assert out == {'bench_data': 6,
                   'profile': {'train-step': 12, 'train-scan': 24,
                               'eval-resident': 24, 'eval-chunked': 24}}
    printed = capsys.readouterr().out
    for n in (35, 36):
        assert f'[phase {n}]' in printed
    assert 'bench_data: {' in printed and 'profile eval-chunked:' in printed


@pytest.mark.parametrize('world', [None, 2], ids=['one_device', '2_gloo'])
def test_sweep_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys,
                                          world):
    """Phase 37 on the CPU at global batch 8 (the sweep's bf16 model at its
    widths): the one process's 6 launches at (8, 64, 64, 3); with one
    device it names the NCCL leg as not run and runs nothing in its place;
    with 2 gloo ranks (the rank code the card's NCCL ranks run) a 13-row
    eval split (7 resident rows a rank, one of them padding), resident
    equal to shipped, and both dtypes' steps held to the one process."""
    _on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, 'SWEEP_BATCH', 8)
    monkeypatch.setattr(chip_smoke, 'SWEEP_EVAL_ROWS', 13)
    out = chip_smoke.sweep_phase(torch.device('cpu'), 'cpu', world=world)
    assert out['one_process'] == 6
    printed = capsys.readouterr().out
    assert 'slice_sweep:' in printed
    if world is None:
        assert out['ranks'] is None
        assert 'NCCL across cards not run in this call' in printed
    else:
        assert out['ranks'] == {'world': 2, 'backend': 'gloo',
                                'launches_per_rank': 8}
        assert printed.count('[phase 37]') == 4
