"""The augment kernel inside the captured step and chunk
(gltvae_torch/train/graphs.py ``Crop``) on the CPU.

With ``TrainConfig.augment_pad`` P > 0 a captured step takes the padded
uint8 batch into its static input; its host part draws the crops'
(dy, dx, fl) from ``step_seed(seed + 2, step)`` into static int32
buffers, and its graph launches the augment kernel (one launch over n·B
images for a chunk) before the loss. Eagerly (``jit=False``) the Trainer
augments before the step, as before. Here the static-buffer path runs
eagerly (the augment wrapper takes its plain version, which
tests/test_torch_augment.py holds to gltvae's Pallas kernel bit for bit),
and tests/test_torch_graphs.py's ``fake_capture`` stands in for a graph.
Small widths (16 px padded to 20, z 8, y 4, batch 8).

Tolerances: captured against eager, bit for bit; the graph's input stage
against gltvae's ``fused_augment_given`` / ``fused_augment_stacked_given``
(interpret mode) on the same (dy, dx, fl), atol 0: both multiply the same
bytes by the same f32 1/255.
"""

import csv
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_graphs import (B, CPU, S, Y, _strip_rows, assert_same,
                                     configs, fake_capture, mu_init,
                                     snapshot)

import gltvae_torch.train.steps as tsteps
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops import preprocess
from gltvae_torch.train import graphs
from gltvae_torch.train.graphs import Crop
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(2)

PAD = 2
EDGE = S + 2 * PAD
KINDS = [True, False] * 4


@pytest.fixture
def counted_augment(monkeypatch):
    """The augment wrapper counting a launch on the CPU, where the card
    would launch."""
    aug = preprocess._augment

    def augment(*a, **k):
        preprocess.augment_launches += 1
        return aug(*a, **k)
    monkeypatch.setattr(preprocess, '_augment', augment)
    monkeypatch.setattr(preprocess, 'augment_launches', 0)


def aug_configs():
    model_cfg, train_cfg = configs()
    return model_cfg, dataclasses.replace(train_cfg, augment_pad=PAD)


def padded(n, seed=3):
    r = np.random.RandomState(seed)
    return [(torch.from_numpy(r.randint(0, 256, (B, EDGE, EDGE, 3))
                              .astype(np.uint8)),
             torch.from_numpy((r.rand(B, Y) > 0.5).astype(np.float32)))
            for _ in range(n)]


def run(monkeypatch, how, data, capture='fake graph', record=None):
    """The steps KINDS on the padded `data` from a fresh state: 'eager'
    (the Trainer's eager order: the augment kernel with the step's draws,
    then the plain step), 'steps' (captured steps cropping in their
    graphs) or 'chunks' (captured chunks of 4). `record` gets the f32
    batch each step's loss takes."""
    model_cfg, train_cfg = aug_configs()
    state = create_train_state(init_model(model_cfg, train_cfg, mu_init(),
                                          CPU), train_cfg)
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: (
        fake_capture(state) if capture == 'fake graph' else None))
    if record is not None:
        prep = tsteps._prep_image
        monkeypatch.setattr(tsteps, '_prep_image', lambda x, size: (
            record.append(x.clone()), prep(x, size))[1])
    preprocess.augment_launches = 0
    mets = []
    if how == 'chunks':
        chunk = tsteps.make_mixed_scan_train_step(state.model, train_cfg)
        for i in range(0, len(data), 4):
            part = data[i:i + 4]
            _, ms = chunk(state, torch.stack([x for x, _ in part]),
                          torch.stack([y for _, y in part]), KINDS[i:i + 4],
                          0.9)
            mets += [{k: v[j] for k, v in ms.items()} for j in range(4)]
    else:
        steps = tsteps.make_train_steps(state.model, train_cfg,
                                        jit=how == 'steps')
        crop = tsteps.train_crop(state.model, train_cfg)
        for (x, y), sup in zip(data, KINDS):
            if how == 'eager':
                x = preprocess.fused_augment_given(
                    x, *crop.draw(state.step, B, CPU), S)
            mets.append(steps[0 if sup else 1](state, x, y, 0.9)[1])
    return snapshot(state), mets, preprocess.augment_launches


@pytest.mark.parametrize('capture', ['static', 'fake graph'])
@pytest.mark.parametrize('how', ['steps', 'chunks'])
def test_augmented_step_and_chunk_equal_eager_augment_then_step(
        monkeypatch, counted_augment, capture, how):
    """8 steps of the interleave on padded batches: the captured steps and
    the chunks of 4, cropping inside their graphs from the static draws,
    equal the eager augment then step bit for bit (params, Adam m and v,
    step, count, every metric); augment launches one a step, eagerly and
    per step, one a chunk (over 4·B images) chunked, counted at the
    replays."""
    data = padded(8)
    eager = run(monkeypatch, 'eager', data)
    got = run(monkeypatch, how, data, capture)
    assert_same(got[0], eager[0])
    for a, b in zip(got[1], eager[1]):
        assert_same(a, b)
    assert eager[2] == 8 and got[2] == (8 if how == 'steps' else 2)


@pytest.mark.parametrize('how', ['steps', 'chunks'])
def test_graph_input_stage_matches_gltvae_fused_augment(monkeypatch, how):
    """The f32 batch the captured step's (or chunk's) loss takes, cropped
    in its graph from the (dy, dx, fl) of its global step, against
    gltvae's fused_augment_given (fused_augment_stacked_given for the
    chunk) in interpret mode on the same draws: atol 0."""
    from gltvae.ops.pallas.preprocess import (
        fused_augment_given as j_aug, fused_augment_stacked_given as j_stk)
    data = padded(4)
    seen = []
    run(monkeypatch, how, data, capture='static', record=seen)
    model_cfg, train_cfg = aug_configs()
    crop = Crop(S, PAD, train_cfg.seed)
    draws = [[v.numpy() for v in crop.draw(i, B, CPU)] for i in range(4)]
    u8 = np.stack([x.numpy() for x, _ in data])
    if how == 'steps':
        want = [np.asarray(j_aug(*(jnp.asarray(a) for a in (u8[i],
                                                            *draws[i])),
                                 S, interpret=True)) for i in range(4)]
    else:
        stacked = [np.stack(v) for v in zip(*draws)]
        want = list(np.asarray(j_stk(*(jnp.asarray(a) for a in (
            u8, *stacked)), S, interpret=True)))
    assert len(seen) == 4
    for got, w in zip(seen, want):
        assert got.dtype == torch.float32 and got.shape == (B, S, S, 3)
        assert np.array_equal(got.numpy().view(np.uint32),
                              w.view(np.uint32))


def test_augment_launches_counted_at_replays(monkeypatch, counted_augment):
    """A captured augmented step's capture records one augment launch and
    no dequant; its warm-up's launches and the recording are left out,
    and each replay adds one; a chunk's replay adds one for 4·B images."""
    model_cfg, train_cfg = aug_configs()
    state = create_train_state(init_model(model_cfg, train_cfg, mu_init(),
                                          CPU), train_cfg)
    monkeypatch.setattr(graphs, 'graph_capture',
                        lambda dev: fake_capture(state))
    monkeypatch.setattr(preprocess, 'launches', 0)
    sup, _ = tsteps.make_train_steps(state.model, train_cfg)
    data = padded(4)
    for i, (x, y) in enumerate(data[:3]):
        sup(state, x, y, 1.0)
        assert preprocess.augment_launches == i + 1
    cs, = sup.steps.values()
    assert cs.crop == Crop(S, PAD, train_cfg.seed)
    assert (cs.augment_launches, cs.dequant_launches) == (1, 0)
    assert cs.graph.replays == 3
    chunk = tsteps.make_mixed_scan_train_step(state.model, train_cfg)
    cstate = create_train_state(state.model, train_cfg)
    monkeypatch.setattr(graphs, 'graph_capture',
                        lambda dev: fake_capture(cstate))
    preprocess.augment_launches = 0
    for _ in range(2):
        chunk(cstate, torch.stack([x for x, _ in data]),
              torch.stack([y for _, y in data]), KINDS[:4], 1.0)
    c, = chunk.chunks.values()
    assert (c.augment_launches, c.dequant_launches) == (1, 0)
    assert preprocess.augment_launches == 2 and preprocess.launches == 0


def test_a_padded_batch_without_augment_pad_still_raises():
    """A captured step built without augment_pad does not crop a padded
    batch: the input stage's padded-loader check raises, as eagerly."""
    model_cfg, train_cfg = configs()
    state = create_train_state(init_model(model_cfg, train_cfg, mu_init(),
                                          CPU), train_cfg)
    (x, y), = padded(1)
    for jit in (True, False):
        sup, _ = tsteps.make_train_steps(state.model, train_cfg, jit=jit)
        with pytest.raises(ValueError, match='padded augmentation loader'):
            sup(state, x, y, 1.0)


def test_trainer_augmented_chunks_captured_equal_eager(monkeypatch, tmp_path,
                                                       counted_augment):
    """The Trainer with augment_pad 2 and steps_per_dispatch 4 (a short
    last chunk each epoch), jit=True (stand-in graphs) and jit=False: the
    same metrics.csv row for row, the same state and test accuracy, and
    one augment launch a dispatch either way."""
    out = {}
    for jit in (True, False):
        model_cfg, train_cfg = aug_configs()
        train_cfg = dataclasses.replace(train_cfg, n_epochs=2)
        splits = synthetic_splits(n_train=6 * B, n_valid=2 * B, n_test=2 * B,
                                  sup_frac=0.5, image_size=S, y_dim=Y,
                                  learnable_signal=True, train_pad=PAD)
        loaders = {k: BatchLoader(v, B, seed=0) for k, v in splits.items()}
        name = f'jit_{jit}'
        trainer = Trainer(model_cfg, train_cfg, mu_init=mu_init(),
                          device=CPU, steps_per_dispatch=4, jit=jit,
                          metrics_path=str(tmp_path / name / 'metrics.csv'))
        if jit:
            monkeypatch.setattr(graphs, 'graph_capture',
                                lambda dev: fake_capture(trainer.state))
        preprocess.augment_launches = 0
        trainer.train(loaders, log_every=1)
        out[jit] = (snapshot(trainer.state), trainer.test(loaders['test']),
                    preprocess.augment_launches)
        trainer.metrics.flush()
    assert _strip_rows(tmp_path / 'jit_True' / 'metrics.csv') \
        == _strip_rows(tmp_path / 'jit_False' / 'metrics.csv')
    with open(tmp_path / 'jit_True' / 'metrics.csv') as f:
        assert len(list(csv.DictReader(f))) == 12
    assert_same(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    assert out[True][2] == out[False][2] == 4       # chunks of 4 and 2
