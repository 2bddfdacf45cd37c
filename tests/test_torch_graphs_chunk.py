"""Captured chunks of train steps (gltvae_torch/train/graphs.py
``CapturedChunk``, ``JitChunk``) on the CPU: gltvae's ``lax.scan``
dispatch of ``--steps-per-dispatch`` steps, one graph per sup/unsup mask
pattern.

A chunk's host part draws its n steps' noise and alphas as n single steps
would; its device part runs the n steps in order, gathering a resident
split's rows inside the graph. Here the static-buffer path runs eagerly,
and tests/test_torch_graphs.py's ``fake_capture`` stands in for a graph.
Small widths (16 px, z 8, y 4, batch 8).

Tolerances: against the port's eager steps and its single captured steps,
bit for bit; against gltvae's jitted scans with gltvae's draws injected,
test_torch_graphs.py's (tests/test_torch_steps.py's): metrics rtol 1e-5
atol 1e-5, params atol 1e-7, Adam moments rtol 1e-4 with atol 1e-5 of
each leaf's largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import gltvae.train.steps as jsteps
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state as j_create
from gltvae.train.state import wrap_key
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.test_torch_graphs import (B, CPU, S, Y, _strip_rows, assert_same,
                                     batches, configs,
                                     counted,  # noqa: F401 (a fixture)
                                     fake_capture, mu_init, snapshot)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
import gltvae_torch.train.steps as tsteps
from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops import preprocess
from gltvae_torch.train import graphs
from gltvae_torch.train.graphs import JitChunk, JitStep
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import (TrainState, create_train_state,
                                      init_model)

torch.set_num_threads(2)

T, F = True, False
#: mask patterns of chunks, in dispatch order (a short last chunk, then a
#: one-step chunk, under 'short')
PATTERNS = {'sup': [(T, T, T)], 'unsup': [(F, F, F)],
            'mixed': [(T, F, T, F), (T, F, T, F)],
            'short': [(T, F, T, F), (T, F, T), (F,)]}


def state_for(monkeypatch, capture, model_cfg, train_cfg):
    """A fresh state, whose captured programs a stand-in graph captures
    (capture 'fake graph') or nothing (the static path)."""
    state = create_train_state(init_model(model_cfg, train_cfg, mu_init(),
                                          CPU), train_cfg)
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: (
        fake_capture(state) if capture == 'fake graph' else None))
    return state


def leg(monkeypatch, how, source, masks, data, capture='fake graph'):
    """The chunks `masks` on `data` (one (x, y) a step) run `how`: 'eager'
    single steps, 'steps' (single captured steps) or 'chunk' (one
    captured chunk each); batches shipped, or gathered from one resident
    split or two (the sup and the unsup steps' batches). Returns the
    final state, the per-step metrics and the dequant launches."""
    model_cfg, train_cfg = configs()
    state = state_for(monkeypatch, capture, model_cfg, train_cfg)
    kinds = [m for mask in masks for m in mask]
    xs = torch.stack([x for x, _ in data])
    ys = torch.stack([y for _, y in data])
    # a resident split and each step's rows of it
    if source == 'resident1':
        splits = {T: (xs.flatten(0, 1), ys.flatten(0, 1))}
        split_of = lambda m: T
        rows = [torch.arange(j * B, (j + 1) * B) for j in range(len(kinds))]
    else:
        splits = {k: (xs[[m == k for m in kinds]].flatten(0, 1),
                      ys[[m == k for m in kinds]].flatten(0, 1))
                  for k in (T, F)}
        split_of = lambda m: m
        seen = {T: 0, F: 0}
        rows = []
        for m in kinds:
            rows.append(torch.arange(seen[m] * B, (seen[m] + 1) * B))
            seen[m] += 1
    preprocess.launches = 0
    mets = []
    if how in ('eager', 'steps'):
        sup, unsup = tsteps.make_train_steps(state.model, train_cfg,
                                             jit=how == 'steps')
        for j, m in enumerate(kinds):
            step = sup if m else unsup
            if source == 'shipped':
                _, met = step(state, xs[j], ys[j], 0.8)
            elif how == 'steps':
                _, met = step.gathered(state, *splits[split_of(m)], rows[j],
                                       0.8)
            else:
                images, labels = splits[split_of(m)]
                _, met = step(state, images[rows[j]], labels[rows[j]], 0.8)
            mets.append(met)
        return snapshot(state), mets, preprocess.launches, None
    if source == 'shipped':
        chunk = tsteps.make_mixed_scan_train_step(state.model, train_cfg)
    elif source == 'resident1':
        chunk = tsteps.make_resident_scan_train_steps(state.model,
                                                      train_cfg)
    else:
        chunk = tsteps.make_resident_mixed_scan_train_step(state.model,
                                                           train_cfg)
    j = 0
    for mask in masks:
        n = len(mask)
        if source == 'shipped':
            _, ms = chunk(state, xs[j:j + n], ys[j:j + n], mask, 0.8)
        elif source == 'resident1':
            _, ms = chunk[0 if mask[0] else 1](
                state, *splits[T], torch.stack(rows[j:j + n]), 0.8)
        else:
            _, ms = chunk(state, *splits[T], *splits[F],
                          torch.stack(rows[j:j + n]), mask, 0.8)
        assert all(v.shape == (n,) for v in ms.values())
        mets += [{k: v[i] for k, v in ms.items()} for i in range(n)]
        j += n
    return snapshot(state), mets, preprocess.launches, chunk


CASES = [('sup', 'shipped'), ('unsup', 'shipped'), ('mixed', 'shipped'),
         ('short', 'shipped'), ('sup', 'resident1'), ('unsup', 'resident1'),
         ('mixed', 'resident2'), ('short', 'resident2')]


@pytest.mark.parametrize('pattern,source', CASES)
def test_chunk_graph_equals_single_steps_and_eager(monkeypatch, counted,
                                                   pattern, source):
    """Each mask pattern, shipped or gathered from one or two resident
    splits, a short last chunk among them: the chunk graphs (stand-in
    graphs' replays) equal the single captured steps and the eager steps
    bit for bit (params, Adam m and v, step, count, every metric), with
    one dequant launch a step counted at the replays."""
    masks = PATTERNS[pattern]
    n = sum(len(m) for m in masks)
    data = batches(n, seed=4)
    runs = {how: leg(monkeypatch, how, source, masks, data)
            for how in ('eager', 'steps', 'chunk')}
    eager = runs['eager']
    for how in ('steps', 'chunk'):
        got = runs[how]
        assert_same(got[0], eager[0])
        assert got[0]['step'] == got[0]['adam_count'] == n
        for a, b in zip(got[1], eager[1]):
            assert_same(a, b)
        assert got[2] == n
    chunk = runs['chunk'][3]
    jc = chunk if isinstance(chunk, JitChunk) else None
    if jc is None:              # a resident maker's closure
        fns = chunk if isinstance(chunk, tuple) else (chunk,)
        jc = next(c.cell_contents for f in fns for c in f.__closure__
                  if isinstance(c.cell_contents, JitChunk))
    assert len(jc.chunks) == len(set(masks))
    assert sum(c.graph.replays for c in jc.chunks.values()) == len(masks)


@pytest.mark.parametrize('source', ['shipped', 'resident'])
def test_chunk_matches_gltvae_jitted_scan(monkeypatch, source):
    """A mixed chunk (sup, unsup, sup, unsup) from one state: the port's
    captured chunk on the CPU (static buffers, gltvae's per-step draws
    injected) against gltvae's make_mixed_scan_train_step /
    make_resident_mixed_scan_train_step (jit=True), at
    test_static_path_matches_gltvae_jitted_steps's tolerances."""
    jm, tm = small_configs()
    cfg = dict(batch_size=B, perc_supervision=0.5)
    params = jax_params(jm, scheme_mu(jm), seed=5)
    jmodel = JCCVAE(jm)
    jstate = j_create(jmodel, jcfg.TrainConfig(**cfg), jax.random.key(0),
                      params=jax.tree.map(jnp.asarray, params))
    model = torch_model(tm, params)
    state = create_train_state(model, tcfg.TrainConfig(**cfg))
    mask = [T, F, T, F]
    r = np.random.RandomState(6)
    xs = r.randint(0, 256, (4, B, 16, 16, 3), dtype=np.uint8)
    ys = (r.rand(4, B, 4) > 0.5).astype(np.float32)
    rng = jnp.asarray(np.array(jstate.rng))     # the state is donated

    class _Step:
        def __init__(self, step):
            self.step = step
    monkeypatch.setattr(TrainState, 'next_generator',
                        lambda self: _Step(self.step))
    monkeypatch.setattr(tsteps, 'draw_noise', lambda model, b, sup, k, gen,
                        out=None: {n: torch.from_numpy(v) for n, v in
                                   reconstruct_noise(jax.random.fold_in(
                                       wrap_key(rng), gen.step), sup, b, k,
                                       z_dim=8, y_dim=4).items()})
    jtc = jcfg.TrainConfig(**cfg)
    if source == 'shipped':
        jstate, jmet = jsteps.make_mixed_scan_train_step(jmodel, jtc)(
            jstate, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mask),
            1.0)
        chunk = tsteps.make_mixed_scan_train_step(model,
                                                  tcfg.TrainConfig(**cfg))
        assert isinstance(chunk, JitChunk)
        state, tmet = chunk(state, torch.from_numpy(xs),
                            torch.from_numpy(ys), mask, 1.0)
    else:
        images = xs.reshape(-1, 16, 16, 3)
        labels = ys.reshape(-1, 4)
        idxs = np.arange(4 * B).reshape(4, B)
        jstate, jmet = jsteps.make_resident_mixed_scan_train_step(
            jmodel, jtc)(jstate, *(jnp.asarray(a) for a in (
                images, labels, images, labels, idxs)), jnp.asarray(mask),
            1.0)
        ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
        state, tmet = tsteps.make_resident_mixed_scan_train_step(
            model, tcfg.TrainConfig(**cfg))(state, ti, tl, ti, tl,
                                            torch.from_numpy(idxs), mask,
                                            1.0)
    assert state.step == int(jstate.step) == 4
    assert state.adam_count == int(jstate.opt_state.count)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jmet[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    got = state_dict_to_params(state.model.state_dict())
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-7)
    for mine, theirs in ((state.adam_m, jstate.opt_state.mu),
                         (state.adam_v, jstate.opt_state.nu)):
        mine = state_dict_to_params({**{k: v for k, v in
                                        state.model.state_dict().items()
                                        if k not in mine}, **mine})
        for g, w in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())


def test_one_capture_per_mask_pattern(monkeypatch, counted):
    """Chunks of patterns P, Q, P, Q, R, P: three graphs, each captured
    once (its first call) and replayed at every call of its pattern; the
    metrics come out stacked [n]."""
    model_cfg, train_cfg = configs()
    state = state_for(monkeypatch, 'fake graph', model_cfg, train_cfg)
    chunk = tsteps.make_mixed_scan_train_step(state.model, train_cfg)
    P, Q, R = (T, F, T, F), (F, F, T, F), (T, F)
    order = [P, Q, P, Q, R, P]
    data = batches(4, seed=8)
    xs = torch.stack([x for x, _ in data])
    ys = torch.stack([y for _, y in data])
    captures = []
    real = graphs.Captured._capture
    monkeypatch.setattr(graphs.Captured, '_capture', lambda self, owner: (
        captures.append(self.mask), real(self, owner))[1])
    for mask in order:
        n = len(mask)
        _, ms = chunk(state, xs[:n], ys[:n], mask, 1.0)
        assert ms['loss'].shape == (n,)
    assert captures == [P, Q, R]
    assert {k[0]: c.graph.replays for k, c in chunk.chunks.items()} \
        == {P: 3, Q: 2, R: 1}
    assert state.step == sum(map(len, order))
    assert preprocess.launches == sum(map(len, order))


def test_a_failed_chunk_capture_leaves_the_step(monkeypatch):
    """The host part draws each inner step at its own step, but the state's
    step advances only after the replay: a capture that raises leaves it
    where it was (the Adam count holds the drawn alphas, as a single
    captured step's does)."""
    model_cfg, train_cfg = configs()
    state = create_train_state(init_model(model_cfg, train_cfg, mu_init(),
                                          CPU), train_cfg)

    def failing(fn, pool):
        raise RuntimeError('injected capture failure')
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: failing)
    chunk = tsteps.make_mixed_scan_train_step(state.model, train_cfg)
    data = batches(3)
    before = snapshot(state)
    with pytest.raises(RuntimeError, match='injected capture failure'):
        chunk(state, torch.stack([x for x, _ in data]),
              torch.stack([y for _, y in data]), [T, F, T], 1.0)
    assert_same(snapshot(state), {**before, 'adam_count': 3})


def _trainer(tmp_path, name, spd, resident):
    model_cfg, train_cfg = configs()
    train_cfg = dataclasses.replace(train_cfg, n_epochs=2)
    # 3 sup + 3 unsup batches an epoch: chunks of 4 and 2 at spd 4
    splits = synthetic_splits(n_train=6 * B, n_valid=2 * B, n_test=2 * B,
                              sup_frac=0.5, image_size=S, y_dim=Y,
                              learnable_signal=True)
    loaders = {k: BatchLoader(v, B, seed=0) for k, v in splits.items()}
    kw = {} if resident else dict(resident_train='off', resident_eval='off')
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu_init(), device=CPU,
                      metrics_path=str(tmp_path / name / 'metrics.csv'),
                      steps_per_dispatch=spd, **kw)
    return trainer, loaders


@pytest.mark.parametrize('resident', [True, False])
def test_trainer_metrics_equal_at_1_and_4_steps_a_dispatch(
        monkeypatch, tmp_path, resident):
    """The captured Trainer (stand-in graphs) at steps_per_dispatch 1 and
    4, a short last chunk in each epoch: metrics.csv row for row, the
    state bit for bit and the test accuracy equal; at 4, one chunk graph
    a mask pattern."""
    runs = {}
    for spd in (1, 4):
        trainer, loaders = _trainer(tmp_path, f'spd{spd}', spd, resident)
        monkeypatch.setattr(graphs, 'graph_capture',
                            lambda dev: fake_capture(trainer.state))
        trainer.train(loaders, log_every=1)
        runs[spd] = (trainer, trainer.test(loaders['test']))
        trainer.metrics.flush()
    a, b = runs[1][0], runs[4][0]
    assert _strip_rows(tmp_path / 'spd1' / 'metrics.csv') \
        == _strip_rows(tmp_path / 'spd4' / 'metrics.csv')
    assert len(a.metrics.rows) == 12
    assert_same(snapshot(a.state), snapshot(b.state))
    assert runs[1][1] == runs[4][1]
    if not resident:
        assert isinstance(b._chunk_step, JitChunk)
        assert isinstance(a._sup_step, JitStep)
        assert sorted(k[0] for k in b._chunk_step.chunks) \
            == [(T, F), (T, F, T, F)]
