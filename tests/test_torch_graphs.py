"""The captured train step (gltvae_torch/train/graphs.py) on the CPU.

A captured step is a host part (noise, Adam count and alpha, step) and a
device part that is captured as a CUDA graph on the card. Here, where
there is nothing to capture, the same static-buffer path runs eagerly, and
``fake_capture`` stands in for a graph: its recording run leaves the state
as it found it, and its replay runs the device part again and writes the
results into the recorded outputs, as a replay overwrites a graph's
outputs. Small widths (16 px, z 8, y 4, batch 8).

Tolerances: the static-buffer path against the plain step, bit for bit
(the same ops on the same values); against gltvae's jitted step,
tests/test_torch_steps.py's: metrics rtol 1e-5 atol 1e-5, params atol
1e-7, Adam moments rtol 1e-4 with atol 1e-5 of each leaf's largest value.
"""

import csv
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state as j_create
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch import cli
from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.data.pipeline import BatchLoader
from gltvae_torch.data.synthetic import synthetic_splits
from gltvae_torch.ops import preprocess
from gltvae_torch.ops.gating import cooccurrence_gating_matrix
from gltvae_torch.train import graphs
from gltvae_torch.train.graphs import CapturedStep, JitStep
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import (create_train_state, init_model,
                                      keras_adam_update, keras_alpha,
                                      next_alpha)
from gltvae_torch.train.steps import make_train_steps, resolve_jit

torch.set_num_threads(2)

B, S, Y, K = 8, 16, 4, 4
CPU = torch.device('cpu')


def configs(dtype='float32', remat='none', gate='learnable', s2d=False):
    model_cfg = tcfg.ModelConfig(
        image_size=S, z_dim=8, y_dim=Y, enc_features=(8, 8), enc_hidden=16,
        dec_features=(16, 8), compute_dtype=dtype, input_s2d=s2d,
        output_s2d=s2d, gate_type=gate, gate_subtype='inferred')
    train_cfg = tcfg.TrainConfig(batch_size=B, perc_supervision=0.5,
                                 classifier_mc_samples=K, remat=remat)
    return model_cfg, train_cfg


def mu_init(seed=0):
    return cooccurrence_gating_matrix(
        np.random.RandomState(seed).rand(64, Y) > 0.5).astype(np.float32)


def batches(n, size=S, seed=1):
    r = np.random.RandomState(seed)
    return [(torch.from_numpy(r.randint(0, 256, (B, size, size, 3))
                              .astype(np.uint8)),
             torch.from_numpy((r.rand(B, Y) > 0.5).astype(np.float32)))
            for _ in range(n)]


def fresh(model_cfg, train_cfg, jit):
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    return create_train_state(model, train_cfg), make_train_steps(
        model, train_cfg, jit=jit)


def snapshot(state):
    return {'step': state.step, 'adam_count': state.adam_count,
            **{f'p.{k}': v.detach().clone()
               for k, v in state.model.state_dict().items()},
            **{f'm.{k}': v.clone() for k, v in state.adam_m.items()},
            **{f'v.{k}': v.clone() for k, v in state.adam_v.items()}}


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def fake_capture(state):
    """A capture function for `state`'s steps on the CPU (see the module
    docstring). Its replays add nothing to the dequant and augment
    counts: a graph's replay calls no wrapper."""
    def capture(fn, pool):
        saved = [t.detach().clone() for t in graphs._state_tensors(state)]
        out = fn()
        with torch.no_grad():
            for t, s in zip(graphs._state_tensors(state), saved):
                t.copy_(s)

        class Graph:
            replays = 0

            def replay(self):
                n = preprocess.launches, preprocess.augment_launches
                new = fn()
                preprocess.launches, preprocess.augment_launches = n
                for k, v in out.items():
                    v.copy_(new[k])
                Graph.replays += 1
        return Graph(), out
    return capture


@pytest.fixture
def counted(monkeypatch):
    """The dequant wrapper counting a launch on the CPU, where the card
    would launch."""
    import gltvae_torch.train.steps as tsteps
    dq = preprocess.dequant

    def dequant(u8, *a, **k):
        preprocess.launches += 1
        return dq(u8, *a, **k)
    monkeypatch.setattr(tsteps, 'dequant', dequant)
    monkeypatch.setattr(preprocess, 'launches', 0)


# ------------------------------------------------------------------ (1)
HOST_READS = ('item', '__bool__', '__float__', '__int__', 'tolist', 'numpy',
              'cpu', 'new_tensor')
#: tensors made from host data: on the card, a copy from the host
HOST_BUILDS = ('tensor', 'as_tensor', 'from_numpy')


@pytest.mark.parametrize('dtype,remat,gate,source,resize', [
    ('float32', 'none', 'learnable', 'shipped', False),
    ('float32', 'full', 'fixed', 'resident', False),
    ('float32', 'dots', 'learnable', 'resident', False),
    ('bfloat16', 'none', 'fixed', 'shipped', False),
    ('bfloat16', 'dots', 'learnable', 'shipped', False),
    ('bfloat16', 'full', 'learnable', 'resident', False),
    ('float32', 'none', 'learnable', 'shipped', True),
    ('bfloat16', 'dots', 'fixed', 'resident', True),
])
def test_device_part_reads_nothing_back(monkeypatch, dtype, remat, gate,
                                        source, resize):
    """After the warm-up, the input stage, sup and unsup device parts and
    the metric clones of a captured step run with every Tensor method that
    reads a value back to the host, and every tensor constructor from host
    data, raising: nothing would be baked into a graph, and no copy from
    the host would break its capture."""
    model_cfg, train_cfg = configs(dtype, remat, gate,
                                   s2d=dtype == 'bfloat16')
    state, (sup, unsup) = fresh(model_cfg, train_cfg, True)
    size = (37, 29) if resize else (S, S)
    r = np.random.RandomState(2)
    images = torch.from_numpy(r.randint(0, 256, (3 * B, *size, 3))
                              .astype(np.uint8))
    labels = torch.from_numpy((r.rand(3 * B, Y) > 0.5).astype(np.float32))
    idx = torch.from_numpy(r.permutation(3 * B)[:B])
    for step, supervised in ((sup, True), (unsup, False)):
        cs = step.captured(((B, *size, 3), torch.uint8),
                           ((B, Y), torch.float32))
        cs.set_noise(step.host(state, B, None))
        cs.temp.fill_(0.7)
        next_alpha(state, train_cfg.lr, out=cs.alpha)
        cs.load(images[:B], labels[:B])
        cs.warm_up(state)       # before a capture: constants made once
        before = snapshot(state)
        with monkeypatch.context() as m:
            for name in HOST_READS:
                m.setattr(torch.Tensor, name, _refuse(name))
            for name in HOST_BUILDS:
                m.setattr(torch, name, _refuse(name))
            if source == 'resident':
                cs.gather(images, labels, idx)
            else:
                cs.load(images[:B], labels[:B])
            met = cs(state)
        assert all(torch.isfinite(v).all() for k, v in met.items()
                   if k != 'c_nan'), supervised
        moved = [k for k, v in snapshot(state).items()
                 if k.startswith('p.') and not torch.equal(v, before[k])]
        assert moved, 'the device part did not update the params'
        assert ('p.mu' in moved) == (gate == 'learnable')


def _refuse(name):
    def refuse(self, *a, **k):
        raise AssertionError(f'host read: Tensor.{name}')
    return refuse


# ------------------------------------------------------------------ (2)
@pytest.mark.parametrize('capture', ['static', 'fake graph'])
@pytest.mark.parametrize('source', ['shipped', 'resident'])
def test_static_path_bit_equal_to_the_plain_step(monkeypatch, counted,
                                                 capture, source):
    """6 alternating steps (sup first) from one state: the captured path
    (its static buffers run eagerly, or replays of a stand-in graph) and
    the plain step give bit-equal params, Adam m and v, step, count and
    metrics; each replay counts the dequant launch its capture recorded."""
    model_cfg, train_cfg = configs()
    data = batches(6)
    runs = []
    for jit in (False, True):
        state, (sup, unsup) = fresh(model_cfg, train_cfg, jit)
        if jit and capture == 'fake graph':
            monkeypatch.setattr(graphs, 'graph_capture',
                                lambda dev: fake_capture(state))
        preprocess.launches = 0
        mets = []
        for i, (x, y) in enumerate(data):
            step = sup if i % 2 == 0 else unsup
            if source == 'resident':
                images, labels = torch.cat([x, x.flip(0)]), torch.cat(
                    [y, y.flip(0)])
                idx = torch.arange(B, 2 * B)
                if jit:
                    _, m = step.gathered(state, images, labels, idx, 0.9)
                else:
                    _, m = step(state, images[idx], labels[idx], 0.9)
            else:
                _, m = step(state, x, y, 0.9)
            mets.append(m)
        runs.append((snapshot(state), mets, preprocess.launches))
        if jit:
            cs = list(sup.steps.values()) + list(unsup.steps.values())
            assert len(cs) == 2 and all(c.dequant_launches == (
                1 if capture == 'fake graph' else 0) for c in cs)
            assert all((c.graph is None) == (capture == 'static')
                       for c in cs)
    (plain, pm, pl), (capt, cm, cl) = runs
    assert_same(plain, capt)
    assert capt['step'] == capt['adam_count'] == 6
    for a, b in zip(pm, cm):
        assert_same(a, b)
    assert pl == cl == 6


def test_keras_adam_alpha_tensor_rounds_as_a_python_float():
    """``p -= alpha_t * m / (sqrt(v) + eps)`` with alpha a 0-d f32 tensor
    equals the Python-float form bit for bit, over 50 updates."""
    model_cfg, train_cfg = configs()
    states = [fresh(model_cfg, train_cfg, False)[0] for _ in range(2)]
    r = np.random.RandomState(3)
    for _ in range(50):
        grads = {k: torch.from_numpy(r.standard_normal(tuple(p.shape))
                                     .astype(np.float32) * 0.01)
                 for k, p in states[0].trainable().items()}
        keras_adam_update(states[0], grads, 1e-3)
        st = states[1]
        st.adam_count += 1
        alpha = _python_alpha(st.adam_count)
        with torch.no_grad():
            for n, p in st.trainable().items():
                g = grads[n]
                m = 0.9 * st.adam_m[n] + (1.0 - 0.9) * g
                v = 0.999 * st.adam_v[n] + (1.0 - 0.999) * g * g
                st.adam_m[n].copy_(m)
                st.adam_v[n].copy_(v)
                p.add_(-alpha * m / (torch.sqrt(v) + 1e-7))
    assert_same(snapshot(states[0]), snapshot(states[1]))


def _python_alpha(count):
    return keras_alpha(count, 1e-3)


# ------------------------------------------------------------------ (3)
def test_warm_up_puts_the_state_back():
    """Two warm-up runs of the device part (which do update the params)
    leave params, moments, step and count as they were."""
    model_cfg, train_cfg = configs()
    state, (sup, _) = fresh(model_cfg, train_cfg, True)
    (x, y), (x2, y2) = batches(2)
    sup(state, x, y, 1.0)                   # moments no longer zero
    cs, = sup.steps.values()
    cs.load(x2, y2)
    runs = []
    part = cs.device_part
    cs.device_part = lambda *a: (runs.append(snapshot(state)), part(*a))[1]
    before = snapshot(state)
    cs.warm_up(state)
    assert len(runs) == 2 and any(          # the first run moved them
        not torch.equal(runs[1][k], before[k]) for k in before
        if k.startswith('p.'))
    assert_same(snapshot(state), before)
    assert (state.step, state.adam_count) == (1, 1)


# ------------------------------------------------------------------ (4)
def test_logged_metrics_survive_the_next_step(monkeypatch, tmp_path):
    """With a graph whose replay overwrites its outputs, a step's metrics
    (as the loop keeps them, and as a MetricsLogger row queued on the
    device) are unchanged by the next step of the same kind."""
    from gltvae_torch.train.metrics import MetricsLogger
    model_cfg, train_cfg = configs()
    state, (sup, _) = fresh(model_cfg, train_cfg, True)
    monkeypatch.setattr(graphs, 'graph_capture',
                        lambda dev: fake_capture(state))
    (x, y), (x2, y2) = batches(2)
    log = MetricsLogger(str(tmp_path / 'metrics.csv'))
    _, m1 = sup(state, x, y, 1.0)
    kept = {k: v.clone() for k, v in m1.items()}
    log.log(0, {k: v for k, v in m1.items() if k != 'c_nan'})
    _, m2 = sup(state, x2, y2, 1.0)
    cs, = sup.steps.values()
    assert cs.graph.replays == 2
    assert not torch.equal(m2['loss'], kept['loss'])
    assert_same(m1, kept)
    assert all(v.data_ptr() != cs.metrics[k].data_ptr()
               for k, v in m1.items())
    row = log.rows[0]
    assert all(row[k] == float(kept[k]) for k in kept if k != 'c_nan')


@pytest.mark.parametrize('capture', ['static', 'fake graph'])
def test_a_captured_step_refuses_another_state(monkeypatch, capture):
    """A graph updates the tensors of the state it was captured on, so a
    captured step called with a second state raises before it touches
    either state. Where nothing is captured, the second state runs as the
    plain step would run it."""
    model_cfg, train_cfg = configs()
    state, (sup, _) = fresh(model_cfg, train_cfg, True)
    if capture == 'fake graph':
        monkeypatch.setattr(graphs, 'graph_capture',
                            lambda dev: fake_capture(state))
    other, (plain, _) = fresh(model_cfg, train_cfg, False)
    twin = create_train_state(
        init_model(model_cfg, train_cfg, mu_init(), CPU), train_cfg)
    (x, y), = batches(1)
    sup(state, x, y, 1.0)
    first, second = snapshot(state), snapshot(other)
    if capture == 'fake graph':
        with pytest.raises(ValueError, match='another state'):
            sup(other, x, y, 1.0)
        assert_same(snapshot(state), first)
        assert_same(snapshot(other), second)
    else:
        _, m = sup(other, x, y, 1.0)
        _, want = plain(twin, x, y, 1.0)
        assert_same(snapshot(other), snapshot(twin))
        assert_same(m, want)


# ------------------------------------------------------------ (5), (6)
def trainer_run(tmp_path, name, jit, epochs=2, **kw):
    model_cfg, train_cfg = configs()
    train_cfg = dataclasses.replace(train_cfg, n_epochs=epochs)
    splits = synthetic_splits(n_train=4 * B, n_valid=2 * B, n_test=2 * B,
                              sup_frac=0.5, image_size=S, y_dim=Y,
                              learnable_signal=True)
    loaders = {k: BatchLoader(v, B, seed=0) for k, v in splits.items()}
    run = tmp_path / name
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu_init(), device=CPU,
                      checkpoint_dir=str(run / 'checkpoints'),
                      metrics_path=str(run / 'metrics.csv'), jit=jit, **kw)
    return trainer, loaders, run


def ptrs(state):
    return [t.data_ptr() for t in graphs._state_tensors(state)]


def test_state_tensors_keep_their_addresses(tmp_path):
    """Every param and Adam moment keeps its storage across two epochs,
    ``TrainState.load_state_dict``, a resume and a warm start: a captured
    graph reads and writes them where it found them."""
    trainer, loaders, run = trainer_run(tmp_path, 'run', True)
    before = ptrs(trainer.state)
    trainer.train(loaders, param_dir=str(run), log_every=1)
    assert ptrs(trainer.state) == before
    trainer.state.load_state_dict(trainer.ckpt.load())
    assert ptrs(trainer.state) == before
    trainer.train(loaders, param_dir=str(run), epochs=3, resume=True)
    assert ptrs(trainer.state) == before and trainer.state.step == 12
    trainer.load_params({k: v + 1 for k, v in
                         trainer.model.state_dict().items()})
    assert ptrs(trainer.state) == before and trainer._jit


def _strip_rows(path):
    with open(path) as f:
        return [{k: v for k, v in r.items() if k != 'time'}
                for r in csv.DictReader(f)]


def _result(path):
    with open(path) as f:
        out = json.load(f)
    out.pop('images_per_sec')
    for h in out['history']:
        h.pop('epoch_time')
    return out


def test_trainer_captured_equals_eager(monkeypatch, tmp_path):
    """Two epochs of the Trainer with jit=True and jit=False: equal
    metrics.csv and result.json (times apart); the captured train
    programs' static temperature (resident chunks of one step each) in
    epoch 2 is 0.99x epoch 1's."""
    temps = []
    call = graphs.Captured.__call__
    monkeypatch.setattr(graphs.Captured, '__call__', lambda self, owner: (
        self.writes and temps.append(float(self.temp)),
        call(self, owner))[1])
    for jit in (True, False):
        trainer, loaders, run = trainer_run(tmp_path, f'jit_{jit}', jit)
        result = trainer.train(loaders, param_dir=str(run), log_every=1)
        acc = trainer.test(loaders['test'])
        cli._write_result_json(str(run), result, acc, str(trainer.device))
        assert isinstance(trainer._sup_step, JitStep) == jit
    assert _strip_rows(tmp_path / 'jit_True' / 'metrics.csv') \
        == _strip_rows(tmp_path / 'jit_False' / 'metrics.csv')
    assert _result(tmp_path / 'jit_True' / 'result.json') \
        == _result(tmp_path / 'jit_False' / 'result.json')
    t0 = np.float32(1.0)
    assert len(temps) == 8                 # 4 steps an epoch
    assert temps[:4] == [t0] * 4 and temps[4:] == [np.float32(0.99)] * 4


# ------------------------------------------------------------------ (7)
def test_a_capture_error_raises_out_of_the_trainer(monkeypatch, tmp_path):
    """An injected failing graph raises out of Trainer.train; no step runs
    eagerly in its place."""
    def failing(fn, pool):
        raise RuntimeError('injected capture failure')
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: failing)
    trainer, loaders, run = trainer_run(tmp_path, 'fail', True)
    before = snapshot(trainer.state)
    with pytest.raises(RuntimeError, match='injected capture failure'):
        trainer.train(loaders, param_dir=str(run))
    # the warm-up put the state back and no step ran
    assert_same(snapshot(trainer.state), {**before, 'adam_count': 1})


#: mesh records (rank 0 of 2) for the rule of steps.resolve_jit: gloo over
#: CUDA tensors cannot be captured; NCCL and a CPU mesh can
MESHES = {'gloo-cuda': ('gloo', 'cuda:0'), 'nccl-cuda': ('nccl', 'cuda:0'),
          'gloo-cpu': ('gloo', 'cpu')}


def _mesh(name, world=2):
    from gltvae_torch.parallel.mesh import Mesh
    backend, device = MESHES[name]
    return Mesh(rank=0, world=world, device=torch.device(device),
                backend=backend)


@pytest.mark.parametrize('name', list(MESHES))
def test_jit_with_dp_raises(name):
    """jit=True on a gloo mesh over CUDA tensors raises and says why (a
    graph cannot hold gloo's trip through host memory), and its default
    is eager; NCCL and CPU meshes give JitSteps with jit=True and by
    default, an NCCL mesh of two ranks as one of one. The rule reads only
    the mesh's record, so no card is needed."""
    from gltvae_torch.parallel.dp import DataParallel
    model_cfg, train_cfg = configs()
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    dp = DataParallel(_mesh(name))
    if name == 'gloo-cuda':
        with pytest.raises(ValueError, match='gloo moves CUDA tensors '
                                             'through host memory'):
            make_train_steps(model, train_cfg, dp=dp, jit=True)
        steps = make_train_steps(model, train_cfg, dp=dp)
        assert not any(isinstance(s, JitStep) for s in steps)
    else:
        assert all(isinstance(s, JitStep) for s in make_train_steps(
            model, train_cfg, dp=dp, jit=True))
        for world in (1, 2):
            mesh = _mesh(name, world)
            assert resolve_jit(None, mesh) is True
            by_default = make_train_steps(model, train_cfg,
                                          dp=DataParallel(mesh))
            assert all(isinstance(s, JitStep) for s in by_default)
    assert not any(isinstance(s, JitStep) for s in make_train_steps(
        model, train_cfg, dp=dp, jit=False))


@pytest.mark.parametrize('name', ['gloo-cuda', 'gloo-cpu'])
def test_trainer_jit_on_a_mesh_raises(name):
    """The Trainer gives the makers' answer: jit=True on a gloo mesh over
    CUDA tensors raises, saying why, before the mesh is touched; on a CPU
    mesh (a world of 1, no group) its steps are JitSteps."""
    model_cfg, train_cfg = configs()
    if name == 'gloo-cuda':
        with pytest.raises(ValueError, match='a CUDA graph cannot hold'):
            Trainer(model_cfg, train_cfg, mu_init=mu_init(), jit=True,
                    mesh=_mesh(name))
        return
    tr = Trainer(model_cfg, train_cfg, mu_init=mu_init(), jit=True,
                 mesh=_mesh(name, world=1))
    assert isinstance(tr._sup_step, JitStep)


def test_a_captured_trainer_past_one_nccl_rank_warns(monkeypatch):
    """A Trainer on an NCCL mesh of two ranks takes captured steps by
    default and warns of nothing, as the step makers do: its rule
    (``resolve_jit``) says captured, with jit=None and jit=True, before
    anything touches a card."""
    from gltvae_torch.parallel.dp import DataParallel
    from gltvae_torch.train import loop
    model_cfg, train_cfg = configs()
    mesh = _mesh('nccl-cuda', world=2)
    chosen = []

    def rule(jit, m):
        chosen.append(resolve_jit(jit, m))
        return chosen[-1]
    monkeypatch.setattr(loop, 'resolve_jit', rule)
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert all(isinstance(s, JitStep) for s in make_train_steps(
            model, train_cfg, dp=DataParallel(mesh)))
        for jit in (None, True):
            with pytest.raises(AssertionError,
                               match='not compiled with CUDA'):
                Trainer(model_cfg, train_cfg, mu_init=mu_init(), jit=jit,
                        mesh=mesh)
    assert chosen == [True, True]


# ------------------------------------------------------------------ (8)
def test_static_path_matches_gltvae_jitted_steps():
    """sup, unsup, sup from one state: the port's captured path on the
    CPU (static buffers, gltvae's draws injected) against gltvae's
    make_train_steps(jit=True), at test_torch_steps.py's tolerances."""
    jm, tm = small_configs()
    cfg = dict(batch_size=B, perc_supervision=0.5)
    params = jax_params(jm, scheme_mu(jm), seed=5)
    jmodel = JCCVAE(jm)
    jstate = j_create(jmodel, jcfg.TrainConfig(**cfg), jax.random.key(0),
                      params=jax.tree.map(jnp.asarray, params))
    j_sup, j_unsup = j_make_train_steps(jmodel, jcfg.TrainConfig(**cfg))
    model = torch_model(tm, params)
    state = create_train_state(model, tcfg.TrainConfig(**cfg))
    t_sup, t_unsup = make_train_steps(model, tcfg.TrainConfig(**cfg),
                                      jit=True)
    assert isinstance(t_sup, JitStep)
    r = np.random.RandomState(6)
    for sup in (True, False, True):
        x = r.randint(0, 256, (B, 16, 16, 3), dtype=np.uint8)
        y = (r.rand(B, 4) > 0.5).astype(np.float32)
        noise = reconstruct_noise(jstate.next_rng(), sup, B, 100, z_dim=8,
                                  y_dim=4)
        jstate, jmet = (j_sup if sup else j_unsup)(
            jstate, jnp.asarray(x), jnp.asarray(y), 1.0)
        state, tmet = (t_sup if sup else t_unsup)(
            state, torch.from_numpy(x), torch.from_numpy(y), 1.0,
            noise={k: torch.tensor(v) for k, v in noise.items()})
        assert state.step == int(jstate.step)
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
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
