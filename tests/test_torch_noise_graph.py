"""The gate noise's transforms inside the captured programs (gltvae draws
its noise inside each jitted step, gltvae/train/steps.py): the host part of
a captured dispatch draws only the raw variates (z's normals, the two gate
uniforms, then eps_k or u_y) into its static buffers, and the device part
turns the uniforms into Gumbels (``steps.gate_gumbels``, out of place).

On the CPU, where the captured path is the static-buffer path run eagerly
and tests/test_torch_graphs.py's ``fake_capture`` stands in for a graph.
Held bit for bit (the same ops on the same values): the split Gumbel
sampler against ``sample_gumbel``; the raw draws against ``draw_noise``'s
(the generator ends where it does); the captured steps, chunks, eval and
ELBO passes and ``infer.make_predict`` fed raw draws against the eager
ones, and again with Gumbels injected through the module's draw functions
(the seam tests/torch_f2_twin.py and tests/torch_dp_workers.py use),
which then run in programs of their own; a device part leaves its static
noise as the host part filled it. Two gloo ranks against one process
(tests/torch_noise_workers.py): the static draws, the eval accuracies,
inference's probabilities and the generator bit for bit, the train
metrics and ELBOs rtol 1e-5 and the params rtol 2e-4 atol 1e-6
(tests/test_torch_dp.py's: the ranks average the gradient in another
order than one process sums it)."""

import numpy as np
import pytest
import torch

from tests import torch_noise_workers as NW
from tests.test_torch_config_bridge import jax_params, scheme_mu, small_configs
from tests.test_torch_graphs import (B, CPU, K, Y, assert_same, batches,
                                     configs, fake_capture, fresh, mu_init,
                                     snapshot)

from gltvae_torch import infer
from gltvae_torch.bridge import params_to_state_dict
from gltvae_torch.ops.sampling import gumbel_from_uniform, sample_gumbel
from gltvae_torch.train import graphs
from gltvae_torch.train import steps as tsteps
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(2)

RAW = {True: {'eps_z', 'u1', 'u2', 'eps_k'},
       False: {'eps_z', 'u1', 'u2', 'u_y'}}
MASK = (True, False, False, True)


def _gens(seed=5):
    return (torch.Generator().manual_seed(seed) for _ in 'ab')


@pytest.mark.parametrize('into', [False, True])
def test_gumbel_from_uniform_is_sample_gumbel(into):
    """The draw, then the transform: the same bits as ``sample_gumbel``
    (new or in place), and the generator where it leaves it."""
    a, b = _gens()
    out = torch.empty(18, 18) if into else None
    want = sample_gumbel((18, 18), a, out=out)
    got = gumbel_from_uniform(torch.rand(18, 18, generator=b))
    assert torch.equal(got, want)
    assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize('kind', ['sup', 'unsup', 'eval'])
@pytest.mark.parametrize('into', [False, True])
def test_raw_draws_leave_the_generator_where_draw_noise_does(kind, into):
    """The raw draws hold the uniforms where the draws hold the Gumbels,
    every other draw equal, the uniforms' Gumbels equal the Gumbels, and
    the generator ends where ``draw_noise``/``draw_eval_noise`` leave it;
    drawn into buffers (``out``), they land in them."""
    model_cfg, train_cfg = configs()
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)

    def draw(gen, raw, out=None):
        if kind == 'eval':
            return tsteps.draw_eval_noise(model, B, gen, out=out, raw=raw)
        return tsteps.draw_noise(model, B, kind == 'sup', K, gen, out=out,
                                 raw=raw)
    a, b = _gens()
    gumbel = draw(a, False)
    shapes = {k: v.shape for k, v in draw(torch.Generator(), True).items()}
    bufs = {k: torch.empty(s) for k, s in shapes.items()} if into else None
    raw = draw(b, True, bufs)
    assert torch.equal(a.get_state(), b.get_state())
    want_keys = {'eps_z', 'u1', 'u2'} | (set() if kind == 'eval' else
                                         RAW[kind == 'sup'] - {'u1', 'u2'})
    assert set(raw) == want_keys
    assert set(gumbel) == want_keys - {'u1', 'u2'} | {'g1', 'g2'}
    assert raw['u1'].shape == raw['u2'].shape == model.mu.shape
    assert ((raw['u1'] >= 0) & (raw['u1'] < 1)).all()
    made = tsteps.gate_gumbels(raw)
    assert made.keys() == gumbel.keys()
    for k in gumbel:
        assert torch.equal(made[k], gumbel[k]), k
    if into:
        assert all(raw[k] is bufs[k] for k in raw)


def test_gate_gumbels_leaves_gumbels_and_none_alone():
    noise = {'eps_z': torch.zeros(2, 3), 'g1': torch.ones(2, 2),
             'g2': torch.ones(2, 2)}
    assert tsteps.gate_gumbels(noise) is noise
    assert tsteps.gate_gumbels(None) is None


def _inject(monkeypatch):
    """The module's draws replaced by functions that take no `raw` (the
    old seam's form) and give the real Gumbel draws."""
    draw, draw_eval = tsteps.draw_noise, tsteps.draw_eval_noise
    monkeypatch.setattr(tsteps, 'draw_noise',
                        lambda model, b, sup, k, gen, out=None:
                        draw(model, b, sup, k, gen))
    monkeypatch.setattr(tsteps, 'draw_eval_noise',
                        lambda model, b, gen, out=None:
                        draw_eval(model, b, gen))


def _slots(program):
    noise = program.noise
    if isinstance(noise, dict):
        return [noise]
    return [] if noise is None else [s for s in noise.slots if s is not None]


@pytest.fixture
def untouched(monkeypatch):
    """Every captured program's run leaves its static noise as the host
    part filled it (so a replay with no new fill gives the same bits);
    returns the key sets of the noise the runs read."""
    seen = []
    call = graphs.Captured.__call__

    def run(self, owner):
        before = [{k: v.clone() for k, v in s.items()} for s in _slots(self)]
        out = call(self, owner)
        for s, b in zip(_slots(self), before):
            for k in s:
                assert torch.equal(s[k], b[k]), k
        seen.extend(frozenset(s) for s in before)
        return out
    monkeypatch.setattr(graphs.Captured, '__call__', run)
    return seen


@pytest.mark.parametrize('capture', ['static', 'fake graph'])
@pytest.mark.parametrize('injected', [False, True])
def test_captured_steps_equal_eager(monkeypatch, untouched, capture,
                                    injected):
    """Four alternating steps, captured and eager, from one state: params,
    moments, step, count and metrics bit for bit; the captured steps read
    the raw draws (one program a kind, noise form 'uniform'), or the
    injected Gumbels (form 'gumbel')."""
    model_cfg, train_cfg = configs()
    if injected:
        _inject(monkeypatch)
    runs = {}
    for jit in (False, True):
        state, (sup, unsup) = fresh(model_cfg, train_cfg, jit)
        if jit and capture == 'fake graph':
            monkeypatch.setattr(graphs, 'graph_capture',
                                lambda dev: fake_capture(state))
        mets = []
        for i, (x, y) in enumerate(batches(4)):
            state, m = (sup if i % 2 == 0 else unsup)(state, x, y, 0.7)
            mets.append(m)
        runs[jit] = snapshot(state), mets, (sup, unsup)
    assert_same(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    form = 'gumbel' if injected else 'uniform'
    for s, kind in zip(runs[True][2], (True, False)):
        assert [key[2] for key in s.steps] == [form]
        keys = RAW[kind] if not injected else RAW[kind] - {'u1', 'u2'} | {
            'g1', 'g2'}
        assert set(next(iter(s.steps.values())).noise) == keys
    assert len(untouched) == 4


@pytest.mark.parametrize('injected', [False, True])
def test_captured_chunk_equals_eager(monkeypatch, untouched, injected):
    """A mixed chunk (sup, unsup, unsup, sup), captured and eager: the
    state and the stacked metrics bit for bit; one program, keyed by the
    noise form, its slots holding the raw draws."""
    model_cfg, train_cfg = configs()
    if injected:
        _inject(monkeypatch)
    xs = torch.stack([x for x, _ in batches(4, seed=2)])
    ys = torch.stack([y for _, y in batches(4, seed=2)])
    runs = {}
    for jit in (False, True):
        model = init_model(model_cfg, train_cfg, mu_init(), CPU)
        state = create_train_state(model, train_cfg)
        chunk = tsteps.make_mixed_scan_train_step(model, train_cfg, jit=jit)
        state, m = chunk(state, xs, ys, MASK, 0.7)
        runs[jit] = snapshot(state), m, chunk
    assert_same(runs[True][0], runs[False][0])
    for k in runs[False][1]:
        assert torch.equal(runs[True][1][k], runs[False][1][k]), k
    (key, c), = runs[True][2].chunks.items()
    assert key[-1] == ('gumbel' if injected else 'uniform')
    if not injected:
        assert [set(s) for s in c.noise.slots] == [RAW[m] for m in MASK]
    assert len(untouched) == len(MASK)


@pytest.mark.parametrize('kind', ['eval', 'elbo'])
@pytest.mark.parametrize('injected', [False, True])
def test_captured_passes_equal_eager(monkeypatch, untouched, kind,
                                     injected):
    """Two stochastic chunked passes of 3 batches from one eval generator,
    captured and eager: the values and the generator's state after bit
    for bit; the captured pass read the raw draws or the injected
    Gumbels."""
    model_cfg, train_cfg = configs()
    if injected:
        _inject(monkeypatch)
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    data = batches(3, seed=4)
    xs = torch.stack([x for x, _ in data])
    ys = torch.stack([y for _, y in data])
    got = {}
    for jit in (False, True):
        gen = torch.Generator().manual_seed(3)
        if kind == 'eval':
            fn = tsteps.make_scan_eval_step(model, train_cfg, jit=jit)
            vals = [fn(model, xs, ys, gen, 0.7) for _ in range(2)]
        else:
            fn = tsteps.make_scan_elbo_step(model, train_cfg, jit=jit)
            vals = [fn(model, xs, gen, 0.7) for _ in range(2)]
        got[jit] = torch.stack(vals), gen.get_state()
    assert torch.equal(got[True][0], got[False][0])
    assert torch.equal(got[True][1], got[False][1])
    gates = {'g1', 'g2'} if injected else {'u1', 'u2'}
    assert len(untouched) == 6 and all(gates <= s for s in untouched)


@pytest.mark.parametrize('given', [None, 'gumbel', 'uniform'])
def test_captured_predict_equals_eager(untouched, given):
    """``infer.make_predict`` stochastic, captured and eager, over two
    batches from one generator (or with the noise given, as Gumbels or as
    the raw uniforms): the probabilities bit for bit."""
    model_cfg, train_cfg = configs()
    model = init_model(model_cfg, train_cfg, mu_init(), CPU).eval()
    data = batches(2, seed=6)
    got = {}
    for jit in (False, True):
        predict = infer.make_predict(model, True, 0.3, jit=jit)
        gen = torch.Generator().manual_seed(8)
        probs = []
        for x, _ in data:
            if given is None:
                probs.append(predict(x, gen))
                continue
            noise = tsteps.draw_eval_noise(model, B, gen,
                                           raw=given == 'uniform')
            probs.append(predict(x, noise=noise))
        got[jit] = torch.stack(probs), gen.get_state()
    assert got[True][0].shape == (2, B, Y)
    assert torch.equal(got[True][0], got[False][0])
    assert torch.equal(got[True][1], got[False][1])
    gates = {'g1', 'g2'} if given == 'gumbel' else {'u1', 'u2'}
    assert len(untouched) == 2 and all(gates <= s for s in untouched)


# -------------------------------------------------------------- the mesh
@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    jm, _ = small_configs()
    params = params_to_state_dict(jax_params(jm, scheme_mu(jm), seed=5))
    r = np.random.RandomState(0)
    data = [(r.randint(0, 256, (NW.configs()[1].batch_size, 16, 16, 3),
                       dtype=np.uint8),
             (r.rand(NW.configs()[1].batch_size, 4) > 0.5).astype(
                 np.float32)) for _ in range(3)]
    kw = dict(params=params, batches=data, kinds=[True, False, True])
    return {'one': NW.raw_draws(None, **kw),
            2: NW.launch(2, tmp_path_factory.mktemp('noise'), **kw)}


def test_two_ranks_draw_what_one_process_draws(mesh_runs):
    """Each rank's static buffers hold the global batch's raw draws, bit
    for bit one process's, and its captured programs read them."""
    one = mesh_runs['one']
    assert one['forms'] == ['uniform']
    for rank in mesh_runs[2]:
        assert rank['forms'] == ['uniform']
        for got, want, kind in zip(rank['noise'], one['noise'],
                                   [True, False, True]):
            assert set(got) == RAW[kind]
            for k in want:
                assert torch.equal(got[k], want[k]), k


def test_two_ranks_equal_one_process(mesh_runs):
    one = mesh_runs['one']
    for rank in mesh_runs[2]:
        for got, want in zip(rank['metrics'], one['metrics']):
            for k in ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc',
                      'log_qy_x', 'c_sum'):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=1e-5, err_msg=k)
        for k, v in one['state']['params'].items():
            np.testing.assert_allclose(rank['state']['params'][k].numpy(),
                                       v.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        assert torch.equal(rank['acc'], one['acc'])
        np.testing.assert_allclose(rank['elbo'].numpy(),
                                   one['elbo'].numpy(), rtol=1e-5)
        assert torch.equal(rank['probs'], one['probs'])
        assert torch.equal(rank['gen'], one['gen'])
