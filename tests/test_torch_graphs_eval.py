"""Captured eval and ELBO passes (gltvae_torch/train/graphs.py
``CapturedPass``) on the CPU, and the bench twin's rooflines under
capture (fault F3).

A captured pass is a host part (the n batches' draws from the one eval
generator, into static buffers) and a device part (row gather, dequant,
forward, the values) replayed as one CUDA graph on the card. Here the
static-buffer path runs eagerly, and tests/test_torch_graphs.py's
``fake_capture`` stands in for a graph. Small widths (16 px, z 8, y 4,
batch 8).

Tolerances: against gltvae's jitted makers with gltvae's draws injected,
accuracies within one label of B·y (atol 1/(B·y)) and ELBOs rtol 1e-5
(tests/test_torch_steps.py's); captured against eager, bit for bit (the
same ops on the same values and draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import gltvae.train.steps as jsteps
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.sampling import sample_gumbel as j_gumbel
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)
from tests.test_torch_graphs import (B, CPU, HOST_BUILDS, HOST_READS,
                                     _refuse, configs,
                                     counted,  # noqa: F401 (a fixture)
                                     fake_capture, mu_init)
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
import gltvae_torch.train.steps as tsteps
from gltvae_torch.ops import preprocess
from gltvae_torch.train import graphs
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(2)

N = 3           # batches a pass
FORMS = ('batch', 'scan', 'resident')


def data(seed=7, n=N, y_dim=4, size=16):
    """u8 images [n, B, size, size, 3] and f32 labels [n, B, y]."""
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (n, B, size, size, 3)).astype(np.uint8),
            (r.rand(n, B, y_dim) > 0.5).astype(np.float32))


MAKERS = {'batch': ('make_eval_step', 'make_elbo_eval_step'),
          'scan': ('make_scan_eval_step', 'make_scan_elbo_step'),
          'resident': ('make_resident_eval_step', 'make_resident_elbo_step')}


def port_pass(model, train_cfg, kind, form, jit, xs, ys, gen, temp=0.7,
              fn=None):
    """The port's pass `kind` ('eval' or 'elbo') in `form` over the
    stacked batches: values [n]. The resident form takes the batches as a
    split, rows in order. `fn` is the maker's pass (made here unless
    given)."""
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    if fn is None:
        fn = getattr(tsteps, MAKERS[form][kind == 'elbo'])(model, train_cfg,
                                                           jit=jit)
    if form == 'batch':
        if kind == 'eval':
            return torch.stack([fn(model, x, y, gen, temp)
                                for x, y in zip(xs, ys)])
        return torch.stack([fn(model, x, gen, temp) for x in xs])
    if form == 'scan':
        if kind == 'eval':
            return fn(model, xs, ys, gen, temp)
        return fn(model, xs, gen, temp)
    images, labels = xs.reshape(-1, *xs.shape[2:]), ys.reshape(-1,
                                                               ys.shape[-1])
    idxs = torch.arange(len(images)).view(len(xs), -1)
    if kind == 'eval':
        return fn(model, images, labels, idxs, gen, temp)
    return fn(model, images, idxs, gen, temp)


# ------------------------------------------------------------------ (1)
def _eval_noise(sub, b, z_dim, y_dim):
    """gltvae's predict_probs draws from `sub` (split into z and gates,
    the gates' key into the two Gumbels)."""
    key_z, key_gate = jax.random.split(sub)
    k1, k2 = jax.random.split(key_gate)
    return {'eps_z': np.asarray(jax.random.normal(key_z, (b, z_dim),
                                                  dtype=jnp.float32)),
            'g1': np.asarray(j_gumbel(k1, (y_dim, y_dim))),
            'g2': np.asarray(j_gumbel(k2, (y_dim, y_dim)))}


@pytest.mark.parametrize('kind,det', [('eval', False), ('eval', True),
                                      ('elbo', False)])
@pytest.mark.parametrize('form', FORMS)
def test_captured_passes_match_gltvae_jitted(monkeypatch, kind, det, form):
    """The port's captured pass against gltvae's make_eval_step,
    make_scan_eval_step, make_resident_eval_step (or the ELBO makers) with
    jit=True on the same params and inputs, gltvae's draws injected into
    the port's host part: accuracies within 1/(B·y), ELBOs rtol 1e-5."""
    jm, tm = small_configs()
    params = jax.tree.map(jnp.asarray,
                          jax_params(jm, scheme_mu(jm), seed=5))
    jmodel = JCCVAE(jm)
    jtc = jcfg.TrainConfig(batch_size=B, deterministic_eval=det)
    model = torch_model(tm, params)
    ttc = tcfg.TrainConfig(batch_size=B, deterministic_eval=det)
    xs, ys = data()
    key = jax.random.key(11)
    subs, k = [], key
    for _ in range(N):
        k, sub = jax.random.split(k)
        subs.append(sub)
    # the port's host part draws gltvae's noise, batch by batch
    queue = iter([_eval_noise(s, B, 8, 4) if kind == 'eval'
                  else reconstruct_noise(s, False, B, 0, z_dim=8, y_dim=4)
                  for s in subs])
    draw = lambda *a, **kw: {n: torch.from_numpy(np.array(v))
                             for n, v in next(queue).items()}
    monkeypatch.setattr(tsteps, 'draw_eval_noise', draw)
    monkeypatch.setattr(tsteps, 'draw_noise', draw)
    got = port_pass(model, ttc, kind, form, True, xs, ys,
                    torch.Generator(), 0.7).numpy()
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    if kind == 'eval':
        if form == 'batch':
            ev = jsteps.make_eval_step(jmodel, jtc, jit=True)
            want = [ev(params, x, y, s, 0.7) for x, y, s in zip(jx, jy,
                                                               subs)]
        elif form == 'scan':
            want = jsteps.make_scan_eval_step(jmodel, jtc, jit=True)(
                params, jx, jy, jnp.stack(subs), 0.7)
        else:
            want, _ = jsteps.make_resident_eval_step(jmodel, jtc, jit=True)(
                params, jx.reshape(-1, 16, 16, 3), jy.reshape(-1, 4),
                jnp.arange(N * B).reshape(N, B), key, 0.7)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1 / (B * 4) + 1e-7)
    else:
        if form == 'batch':
            el = jsteps.make_elbo_eval_step(jmodel, jtc, jit=True)
            want = [el(params, x, s, 0.7) for x, s in zip(jx, subs)]
        elif form == 'scan':
            want = jsteps.make_scan_elbo_step(jmodel, jtc, jit=True)(
                params, jx, jnp.stack(subs), 0.7)
        else:
            want, _ = jsteps.make_resident_elbo_step(jmodel, jtc, jit=True)(
                params, jx.reshape(-1, 16, 16, 3),
                jnp.arange(N * B).reshape(N, B), key, 0.7)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


# ------------------------------------------------------------------ (2)
def fresh_model(det=False, dtype='float32'):
    model_cfg, train_cfg = configs(dtype=dtype)
    train_cfg = tcfg.TrainConfig(batch_size=B, deterministic_eval=det)
    return init_model(model_cfg, train_cfg, mu_init(), CPU), train_cfg


def stand_in(monkeypatch, model, train_cfg):
    """Passes of `model` captured by a stand-in graph."""
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: fake_capture(
        create_train_state(model, train_cfg)))


@pytest.mark.parametrize('capture', ['static', 'fake graph'])
@pytest.mark.parametrize('kind,det', [('eval', False), ('eval', True),
                                      ('elbo', False)])
@pytest.mark.parametrize('form', FORMS)
def test_captured_equals_eager_bit_for_bit(monkeypatch, counted, capture,
                                           kind, det, form):
    """Two passes of each form from one eval generator, captured (static
    buffers, or a stand-in graph's replays) and eager: the values bit for
    bit, the generator's state after equal (it advanced as the eager pass
    advances it), one dequant launch a batch either way."""
    model, train_cfg = fresh_model(det)
    xs, ys = data()
    runs = []
    for jit in (False, True):
        if jit and capture == 'fake graph':
            stand_in(monkeypatch, model, train_cfg)
        gen = torch.Generator().manual_seed(3)
        preprocess.launches = 0
        vals = [port_pass(model, train_cfg, kind, form, jit, xs, ys, gen)
                for _ in range(2)]
        runs.append((vals, gen.get_state(), preprocess.launches))
    (eager, g_eager, l_eager), (capt, g_capt, l_capt) = runs
    assert all(torch.equal(a, b) for a, b in zip(eager, capt))
    assert torch.equal(g_eager, g_capt)
    assert l_eager == l_capt == 2 * N
    if not det:                 # the passes drew, and differ
        assert not torch.equal(capt[0], capt[1])


def test_a_resident_pass_is_one_replay(monkeypatch, counted):
    """A resident eval epoch is one replay of one graph (n dequant
    launches counted at it), and a second split gets its own graph."""
    model, train_cfg = fresh_model()
    stand_in(monkeypatch, model, train_cfg)
    ev = tsteps.make_resident_eval_step(model, train_cfg)
    jp = ev.__self__
    xs, ys = (torch.from_numpy(a) for a in data())
    images, labels = xs.reshape(-1, 16, 16, 3), ys.reshape(-1, 4)
    idxs = torch.arange(N * B).view(N, B)
    gen = torch.Generator().manual_seed(1)
    preprocess.launches = 0
    for _ in range(3):
        ev(model, images, labels, idxs, gen, 0.5)
    p, = jp.passes.values()
    assert p.graph.replays == 3 and p.dequant_launches == N
    assert preprocess.launches == 3 * N
    ev(model, images.clone(), labels, idxs, gen, 0.5)
    assert len(jp.passes) == 2


# ------------------------------------------------------------------ (3)
@pytest.mark.parametrize('kind,form', [(k, f) for k in ('eval', 'elbo')
                                       for f in FORMS])
def test_device_part_reads_nothing_back(monkeypatch, kind, form):
    """After its first run (which makes the constants a capture must not
    make), a pass's device part runs with every Tensor method that reads
    a value back to the host, and every tensor constructor from host
    data, raising: nothing would be baked into a graph."""
    model, train_cfg = fresh_model(dtype='bfloat16')
    xs, ys = data()
    gen = torch.Generator().manual_seed(1)
    fn = getattr(tsteps, MAKERS[form][kind == 'elbo'])(model, train_cfg)
    jp = getattr(fn, '__self__', None)
    if jp is None:          # a lambda over the maker's JitPass
        jp = next(c.cell_contents for c in fn.__closure__
                  if isinstance(c.cell_contents, graphs.JitPass))
    port_pass(model, train_cfg, kind, form, True, xs, ys, gen, fn=fn)
    p, = jp.passes.values()
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, _refuse(name))
        for name in HOST_BUILDS:
            m.setattr(torch, name, _refuse(name))
        out = p._run(model)['value']
    assert out.shape == (1 if form == 'batch' else N,)


# ------------------------------------------------------------------ (4)
@pytest.mark.parametrize('form', FORMS)
def test_another_model_raises(monkeypatch, form):
    """A captured pass reads the parameters of the model it was captured
    on: another model raises before the eval generator is touched."""
    model, train_cfg = fresh_model()
    stand_in(monkeypatch, model, train_cfg)
    other, _ = fresh_model()
    xs, ys = data()
    gen = torch.Generator().manual_seed(1)
    fn = {'batch': tsteps.make_eval_step, 'scan': tsteps.make_scan_eval_step,
          'resident': tsteps.make_resident_eval_step}[form](model, train_cfg)
    xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
    images, labels = xs.reshape(-1, 16, 16, 3), ys.reshape(-1, 4)
    call = {'batch': lambda m: fn(m, xs[0], ys[0], gen, 0.5),
            'scan': lambda m: fn(m, xs, ys, gen, 0.5),
            'resident': lambda m: fn(m, images, labels,
                                     torch.arange(N * B).view(N, B), gen,
                                     0.5)}[form]
    call(model)
    state = gen.get_state()
    with pytest.raises(ValueError, match='another model'):
        call(other)
    assert torch.equal(gen.get_state(), state)


# ------------------------------------------------------------------ (5)
def test_an_eval_after_load_params_reads_the_new_params(monkeypatch,
                                                       tmp_path):
    """Trainer.load_params writes into the tensors a captured pass reads:
    the captured Trainer's evaluate and test_elbo after a load equal the
    eager Trainer's after the same load."""
    from tests.test_torch_graphs import trainer_run
    got = []
    for jit in (True, False):
        trainer, loaders, _ = trainer_run(tmp_path, f'load_{jit}', jit)
        if jit:
            monkeypatch.setattr(graphs, 'graph_capture',
                                lambda dev: fake_capture(trainer.state))
        first = trainer.evaluate(loaders['valid'])
        sd = {k: v * 1.5 if v.is_floating_point() else v
              for k, v in trainer.model.state_dict().items()}
        trainer.load_params(sd)
        got.append((first, trainer.evaluate(loaders['valid']),
                    trainer.test_elbo(loaders['valid'])))
        if jit:
            p = next(iter(trainer._resident_eval_step.__self__.passes
                          .values()))
            assert p.graph.replays == 2
        monkeypatch.undo()
    assert got[0] == got[1]
    assert got[0][0] != got[0][1]


# ------------------------------------------------------------------ F3
def hidden_capture(fn, pool):
    """A stand-in graph whose replay dispatches no op that a dispatch mode
    (FlopCounterMode) sees, as a CUDA graph's replay launches kernels
    without dispatching aten ops."""
    from torch.utils._python_dispatch import _disable_current_modes
    out = fn()

    class Graph:
        def replay(self):
            n = preprocess.launches, preprocess.augment_launches
            with _disable_current_modes():
                new = fn()
            preprocess.launches, preprocess.augment_launches = n
            for k, v in out.items():
                v.copy_(new[k])
    return Graph(), out


def _small_bench_model(monkeypatch):
    from gltvae_torch import bench
    real = bench.ModelConfig
    monkeypatch.setattr(bench, 'ModelConfig', lambda **kw: real(
        image_size=64, z_dim=24, y_dim=18, enc_features=(8,) * 4,
        enc_hidden=16, dec_features=(16, 8, 8, 8), **kw))
    return bench


@pytest.mark.parametrize('which', ['roofline', 'eval_roofline',
                                   'eval_roofline_resident'])
def test_bench_rooflines_count_the_captured_work(monkeypatch, which):
    """Fault F3: each of the bench twin's rooflines, with its dispatches
    captured by a graph whose replay dispatches no op, counts FLOPs above
    0, equal to the count with nothing captured (every op dispatched); a
    count made on the captured dispatch itself reads 0."""
    bench = _small_bench_model(monkeypatch)
    call = {'roofline': lambda: bench.bench_train_step(
                batch_size=2, steps=1, warmup=1, compute_dtype='float32',
                scan=2, device='cpu')[2],
            'eval_roofline': lambda: bench.bench_eval(
                batch_size=2, iters=1, scan=2, device='cpu')[1],
            'eval_roofline_resident': lambda: bench.bench_eval_resident(
                batch_size=2, n_images=8, dispatches=1,
                batches_per_dispatch=3, device='cpu')[1]}[which]
    got = {}
    for how, capture in (('hidden', hidden_capture), ('none', None)):
        monkeypatch.setattr(graphs, 'graph_capture',
                            lambda dev, c=capture: c)
        got[how] = call()['step_gflops']
    assert got['hidden'] > 0 and got['hidden'] == got['none']
    # what F3 counted: the captured dispatch itself
    model, train_cfg = fresh_model()
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: hidden_capture)
    ev = tsteps.make_scan_eval_step(model, train_cfg)
    xs, ys = (torch.from_numpy(a) for a in data())
    gen = torch.Generator().manual_seed(1)
    ev(model, xs, ys, gen, 0.5)
    assert bench.count_flops(lambda: ev(model, xs, ys, gen, 0.5)) == 0
