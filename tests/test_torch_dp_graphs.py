"""gltvae_torch's captured data-parallel dispatches (gltvae's jitted
parallel makers, gltvae/parallel/dp.py; train/graphs.py on a mesh), on
two gloo ranks spawned on the CPU (tests/torch_dp_workers.py), where the
captured path is the static-buffer path run eagerly.

Held:
- with ``jit=True`` the ranks equal, bit for bit, the same ranks with
  ``jit=False``: every data-parallel maker (single steps, mixed and
  uniform chunks, resident chunks with the row exchange, eval and ELBO
  steps, chunked and resident passes, deterministic and stochastic), the
  shardmap steps, ``infer.make_predict`` and the Trainer (chunks of 4,
  the augmented path per step and in chunks of 2);
- every rank runs the same programs in the same order (on a card, where
  each captures them);
- against gltvae's jitted parallel makers on the 8-device CPU mesh
  (tests/conftest.py), the same params (the bridge) and gltvae's draws
  injected: the train steps at tests/test_torch_dp.py's
  tolerances (metrics rtol 1e-5, params rtol 2e-4 atol 1e-6), the eval
  accuracy within one label of B·y (tests/test_torch_graphs_eval.py's
  atol 1/(B·y)), the ELBO rtol 1e-5, and ``infer.make_predict`` against
  tools/infer.py's at tests/test_torch_infer.py's 1e-5;
- a mesh device part reads nothing back to the host;
- ``--debug-nans`` on a mesh replays each rank's eager data-parallel
  step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.parallel.dp import (make_parallel_elbo_step,
                                make_parallel_eval_step, shard_batch)
from gltvae.parallel.mesh import create_mesh
from tests import torch_dp_workers as W
from tests.test_torch_config_bridge import jax_params, scheme_mu, small_configs
from tests.test_torch_graphs import HOST_BUILDS, HOST_READS, _refuse
from tests.test_torch_graphs_eval import _eval_noise
from tests.tf_twin import reconstruct_noise

from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.parallel.dp import DataParallel
from gltvae_torch.parallel.mesh import Mesh
from gltvae_torch.train import steps as tsteps

torch.set_num_threads(1)

PARTS = ['train', 'resident', 'eval', 'shardmap', 'infer',
         *W.GRAPH_TRAINERS]


@pytest.fixture(scope='module')
def params():
    jm, _ = small_configs()
    return jax_params(jm, scheme_mu(jm), seed=5)


@pytest.fixture(scope='module')
def ranks(params, tmp_path_factory):
    """Both ranks' dp_graphs results, {jit: {part: ...}}."""
    return W.launch('dp_graphs', 2, tmp_path_factory.mktemp('dp_graphs'),
                    params=params_to_state_dict(params))


def _same(a, b, where=''):
    """a and b equal bit for bit (tensors, numbers, nested containers);
    walls are skipped, and so is a crop list (a captured step crops inside
    its graph)."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            if k not in ('crops', 'time', 'epoch_time'):
                _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    else:
        assert a == b, where


@pytest.mark.parametrize('part', PARTS)
def test_captured_ranks_equal_eager_ranks(ranks, part):
    for rank in ranks:
        _same(rank[True][part], rank[False][part], part)


def test_ranks_end_with_one_state(ranks):
    for part in ('train', 'resident', *W.GRAPH_TRAINERS):
        _same(ranks[0][True][part]['state'], ranks[1][True][part]['state'],
              part)


def test_every_rank_runs_the_same_programs_in_the_same_order(ranks):
    """The captured programs in the order of their first runs (where a
    card captures them) are the same on both ranks: steps, chunks (their
    mask patterns, a short one among them) and passes."""
    logs = [rank[True]['programs'] for rank in ranks]
    assert logs[0] == logs[1]
    kinds = {kind for kind, _, _ in logs[0]}
    assert kinds == {'CapturedStep', 'CapturedChunk', 'CapturedPass'}
    masks = {mask for kind, mask, _ in logs[0] if kind == 'CapturedChunk'}
    assert (True, False) in masks and len(masks) >= 3
    assert not ranks[0][False]['programs']


def test_captured_ranks_match_gltvae_jitted_makers(params, tmp_path):
    """Sup, unsup and sup steps (tests/torch_dp_workers.py ``steps`` with
    jit=True) on 2 ranks against gltvae's make_parallel_train_steps on the
    8-device CPU mesh, gltvae's draws injected. The chunks equal these
    steps bit for bit (``test_captured_ranks_equal_eager_ranks``), and
    tests/test_torch_dp.py's test_two_ranks_equal_gltvae_mesh holds the
    default (also captured) steps and mixed chunk the same way."""
    from tests.test_torch_dp import KINDS, _batches
    from gltvae.parallel.dp import make_parallel_train_steps, shard_state
    from gltvae.train.state import create_train_state
    jm, _ = small_configs()
    cfg = jcfg.TrainConfig(batch_size=W.B, lr=W.LR,
                           classifier_mc_samples=W.K)
    jmodel = JCCVAE(jm)
    mesh = create_mesh()
    jstate = shard_state(create_train_state(
        jmodel, cfg, jax.random.key(0),
        params=jax.tree.map(jnp.asarray, params)), mesh)
    sup, unsup = make_parallel_train_steps(jmodel, cfg, mesh, donate=False)
    batches = _batches(n=len(KINDS), seed=2)
    noise, jmets = [], []
    for (x, y), kind in zip(batches, KINDS):
        noise.append(reconstruct_noise(jstate.next_rng(), kind, W.B, W.K,
                                       z_dim=8, y_dim=4))
        jstate, m = (sup if kind else unsup)(
            jstate, *shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh),
            1.0)
        jmets.append(m)
    got_ranks = W.launch('steps', 2, tmp_path,
                         params=params_to_state_dict(params),
                         batches=batches, kinds=KINDS, chunk_mask=[],
                         noise=noise, jit=True)
    want = jax.tree.map(np.asarray, jstate.params)
    for rank in got_ranks:
        assert rank['jit_steps']
        for got, jm_ in zip(rank['metrics'], jmets):
            for k in ('loss', 'elbo', 'log_pxz', 'kl'):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(jm_[k]),
                                           rtol=1e-5, err_msg=k)
        got = state_dict_to_params(rank['state']['params'])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


def test_captured_eval_elbo_and_predict_match_gltvae(params, tmp_path):
    """One global batch: the port's captured eval step, ELBO step and
    ``infer.make_predict`` (stochastic) on 2 ranks, gltvae's draws
    injected as the global batch's, against gltvae's
    make_parallel_eval_step and make_parallel_elbo_step on the 8-device
    CPU mesh and tools/infer.py's jitted make_predict on it."""
    from tools import infer as jinfer
    jm, _ = small_configs()
    jmodel = JCCVAE(jm)
    mesh = create_mesh()
    jtc = jcfg.TrainConfig(batch_size=W.B)
    jp = jax.tree.map(jnp.asarray, params)
    r = np.random.RandomState(8)
    x = r.randint(0, 256, (W.B, 16, 16, 3)).astype(np.uint8)
    y = (r.rand(W.B, 4) > 0.5).astype(np.float32)
    keys = jax.random.split(jax.random.key(13), 3)
    jx, jy = shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    want_acc = float(make_parallel_eval_step(jmodel, jtc, mesh)(
        jp, jx, jy, keys[0], 0.7))
    want_elbo = float(make_parallel_elbo_step(jmodel, jtc, mesh)(
        jp, jx, keys[1], 0.7))
    want_probs = np.asarray(jinfer.make_predict(jmodel, True, 0.3, mesh)(
        jp, jx, keys[2]))
    noise = [_eval_noise(keys[0], W.B, 8, 4),
             reconstruct_noise(keys[1], False, W.B, 0, z_dim=8, y_dim=4),
             _eval_noise(keys[2], W.B, 8, 4)]
    for rank in W.launch('graphs_vs_gltvae', 2, tmp_path,
                         params=params_to_state_dict(params), x=x, y=y,
                         noise=noise):
        assert abs(float(rank['acc']) - want_acc) <= 1 / (W.B * 4) + 1e-7
        np.testing.assert_allclose(float(rank['elbo']), want_elbo,
                                   rtol=1e-5)
        assert rank['probs'].shape == want_probs.shape
        np.testing.assert_allclose(rank['probs'].numpy(), want_probs,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize('kind', ['sup', 'unsup'])
def test_mesh_device_part_reads_nothing_back(monkeypatch, kind):
    """tests/test_torch_graphs.py's test_device_part_reads_nothing_back
    with ``dp``: after the warm-up, a data-parallel step's device part
    (noise rows as views, the gradient average) and the eval pass's (the
    matches' gather) run with every host read and every tensor from host
    data raising. The mesh is rank 0 of 2 with no group (its collectives
    are no-ops; the rows and the averaging are the mesh's)."""
    model_cfg, train_cfg = W.configs(perc_supervision=0.5)
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.train.state import create_train_state
    model = CCVAE(model_cfg, mu_init=np.full((4, 4), 0.5, np.float32))
    state = create_train_state(model, train_cfg)
    dp = DataParallel(Mesh(0, 2, torch.device('cpu')))
    sup, unsup = tsteps.make_train_steps(model, train_cfg, dp, jit=True)
    step = sup if kind == 'sup' else unsup
    b = W.B // 2
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randint(0, 256, (b, 16, 16, 3)).astype(np.uint8))
    y = torch.from_numpy((r.rand(b, 4) > 0.5).astype(np.float32))
    cs = step.captured(((b, 16, 16, 3), torch.uint8), ((b, 4), torch.float32))
    cs.set_noise(step.host(state, b, None))
    assert cs.noise['eps_z'].shape == (W.B, 8)         # the global batch's
    cs.temp.fill_(0.7)
    tsteps.next_alpha(state, train_cfg.lr, out=cs.alpha)
    cs.load(x, y)
    cs.warm_up(state)
    ev = tsteps._eval_pass(model, train_cfg, dp)
    p = ev.captured('batch', 1, ((1, b, 16, 16, 3), torch.uint8),
                    ((1, b, 4), torch.float32))
    p.load(x[None], y[None])
    p.noise.fill(0, tsteps.draw_eval_noise(model, p.batch, torch.Generator()))
    p.warm_up(model)
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, _refuse(name))
        for name in HOST_BUILDS:
            m.setattr(torch, name, _refuse(name))
        met = cs(state)
        acc = p(model)['value']
    assert all(torch.isfinite(v).all() for k, v in met.items()
               if k != 'c_nan')
    assert acc.shape == (1,) and 0 <= float(acc) <= 1


def test_debug_nans_on_a_mesh_replays_the_dp_steps(tmp_path):
    """A NaN encoder weight on rank 0, the Trainer's steps captured (the
    static-buffer path): both ranks raise, and each rank's op-by-op replay
    is its eager data-parallel step, so each averages its gradient twice
    (the dispatch and the replay), meeting the other rank's all-reduce."""
    got = W.launch('debug_nans_dp', 2, tmp_path, timeout_s=60.0)
    for rank in got:
        assert rank['captured']
        assert rank['average_calls'] == 2
        assert rank['raised'].startswith('invalid value (nan)')
    assert 'aten.convolution' in got[0]['raised']
