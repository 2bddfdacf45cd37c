"""chip_smoke.py's card-vs-CPU check (``card_vs_cpu``), on the CPU.

Both of its runs go to the CPU here, so they agree bit for bit. A fault
planted in the first ("card") run only must trip the check: a wrong
learning rate through the Adam-step limit, and gradients 5% off through
the Adam m and v limit (Adam's move barely changes when every gradient is
scaled, so a params limit alone would miss it)."""

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


def _card_vs_cpu(monkeypatch, lr_scale=1.0, grad_scale=1.0):
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
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (B, S + 2 * PAD, S + 2 * PAD, 3))
                .astype(np.uint8), (rng.rand(B, 4) > 0.5).astype(np.float32))
               for _ in range(2)]
    g = torch.Generator().manual_seed(2)
    draws = [torch.stack(v) for v in zip(*(
        preprocess.draw_crop_flip(g, B, S + 2 * PAD, S + 2 * PAD, S)
        for _ in range(2)))]
    mu = np.full((4, 4), 0.5, np.float32)
    worst = chip_smoke.card_vs_cpu(0, 'test', model_cfg, train_cfg, mu,
                                   batches, torch.device('cpu'),
                                   lambda: None, draws=draws)
    return worst, failed


def test_identical_runs_agree_bit_for_bit(monkeypatch):
    worst, failed = _card_vs_cpu(monkeypatch)
    assert failed == []
    assert worst == dict(metrics=0.0, adam_m=0.0, adam_v=0.0, adam_step=0.0,
                         params=0.0)


@pytest.mark.parametrize('fault,caught', [
    (dict(lr_scale=1.5), 'not the Adam step of its moments'),
    (dict(grad_scale=1.05), 'Adam moments disagree'),
])
def test_a_fault_in_the_card_run_fails_the_check(monkeypatch, fault, caught):
    worst, failed = _card_vs_cpu(monkeypatch, **fault)
    assert len(failed) == 1 and caught in failed[0], failed
