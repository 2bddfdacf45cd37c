"""The best-checkpoint choice of the port's Trainer against gltvae's: both
Trainers run their own ``train`` loop over the same scripted validation
accuracies (their steps replaced by a counter, so no model trains) and
save through their own checkpoint managers (Orbax in gltvae); the step
each restores for the test is the same, ties and a final epoch that
equals the best included.
"""

import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.train.loop import Trainer as JTrainer

import gltvae_torch.config as tcfg
from gltvae_torch.train.loop import Trainer

BS = 4


class _Loader:
    """Two steps an epoch of zero images; evaluation is scripted."""
    n_s = 2 * BS

    def __iter__(self):
        while True:
            yield (np.zeros((BS, 64, 64, 3), np.uint8),
                   np.zeros((BS, 18), np.float32))


def _scripted(accs):
    it = iter(accs)
    return lambda self, *a, **kw: float(next(it))


def _port_best(tmp_path, accs):
    t = Trainer(tcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one'),
                tcfg.TrainConfig(batch_size=BS, n_epochs=len(accs)),
                checkpoint_dir=str(tmp_path / 'port'), device='cpu',
                resident_train='off', resident_eval='off')

    def step(state, x, y, temp):
        state.step += 1
        return state, {'loss': torch.zeros(()),
                       'c_nan': torch.zeros((), dtype=torch.bool)}
    t._sup_step = step
    Trainer.evaluate, evaluate = _scripted(accs), Trainer.evaluate
    try:
        t.train({'sup': _Loader(), 'valid': _Loader()})
    finally:
        Trainer.evaluate = evaluate
    return t.ckpt.best_step()


def _gltvae_best(tmp_path, accs):
    t = JTrainer(jcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one'),
                 jcfg.TrainConfig(batch_size=BS, n_epochs=len(accs)),
                 checkpoint_dir=str(tmp_path / 'gltvae'),
                 resident_train='off', resident_eval='off')

    def step(state, x, y, temp):
        return state.replace(step=state.step + 1), {
            'loss': np.float32(0), 'c_nan': np.bool_(False)}
    t._sup_step = step
    JTrainer.evaluate, evaluate = _scripted(accs), JTrainer.evaluate
    try:
        t.train({'sup': _Loader(), 'valid': _Loader()})
    finally:
        JTrainer.evaluate = evaluate
    best = t.ckpt.best_step()
    t.ckpt.close()
    return best


@pytest.mark.parametrize('accs', [
    (0.50, 0.55, 0.60, 0.65),          # the last epoch is the best
    (0.50, 0.62, 0.61, 0.60, 0.59),    # an early best, then worse
    (0.50, 0.60, 0.60, 0.55),          # a tie is not an improvement
    (0.50, 0.60, 0.55, 0.60),          # the final epoch ties the best
    (0.1, 0.2, 0.3, 0.4, 0.5, 0.45),   # more saves than max_to_keep
], ids=['rising', 'early_best', 'tie', 'final_tie', 'many_saves'])
def test_best_checkpoint_choice_equals_gltvae(tmp_path, accs):
    ours, theirs = _port_best(tmp_path, accs), _gltvae_best(tmp_path, accs)
    assert ours == theirs
    # 'best' is saved on a strict gain only, 'last' with its own accuracy,
    # and a tie goes to the later step; 2 steps an epoch
    best = max(accs)
    epoch = len(accs) - 1 if accs[-1] == best else accs.index(best)
    assert ours == 2 * (epoch + 1)
