"""gltvae_torch.parallel's DP step against one process and against gltvae's
8-device CPU mesh (tests/conftest.py), with two gloo ranks spawned on the
CPU (tests/torch_dp_workers.py).

The same global batches, params (the bridge) and noise go through each
side: sup, unsup and sup steps, then one mixed chunk (sup, unsup, unsup,
sup). Tolerances, as tests/test_parallel.py holds gltvae's mesh: loss and
the other metrics rtol 1e-5; params rtol 2e-4, atol 1e-6 (the gradient
is averaged over ranks in another order than one process sums it). A
mesh of one rank with a gloo group equals no mesh bit for bit; the ranks
end with the same state bit for bit. The explicit variant (per-rank noise,
``parallel/shardmap.py``) is held to tests/test_shardmap.py's rule: loss
within 5%, params within 2·lr."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.parallel.dp import (make_parallel_mixed_scan_train_step,
                                make_parallel_train_steps, shard_batch,
                                shard_stacked_batch, shard_state)
from gltvae.parallel.mesh import create_mesh
from gltvae.train.state import create_train_state
from tests import torch_dp_workers as W
from tests.test_torch_config_bridge import jax_params, scheme_mu, small_configs
from tests.tf_twin import reconstruct_noise

from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.ops import _build
from gltvae_torch.parallel import dp as tdp
from gltvae_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

KINDS = [True, False, True]
MASK = [True, False, False, True]


def _batches(n=len(KINDS) + len(MASK), seed=0):
    r = np.random.RandomState(seed)
    return [(r.randint(0, 256, (W.B, 16, 16, 3), dtype=np.uint8),
             (r.rand(W.B, 4) > 0.5).astype(np.float32)) for _ in range(n)]


@pytest.fixture(scope='module')
def params():
    jm, _ = small_configs()
    return jax_params(jm, scheme_mu(jm), seed=5)


@pytest.fixture(scope='module')
def port_runs(params, tmp_path_factory):
    """The port's steps in one process and on 1 and 2 gloo ranks, the noise
    drawn from the state's generator."""
    tmp = tmp_path_factory.mktemp('dp')
    kw = dict(params=params_to_state_dict(params), batches=_batches(),
              kinds=KINDS, chunk_mask=MASK)
    return {'one': W.steps(None, **kw),
            1: W.launch('steps', 1, tmp, **kw)[0],
            2: W.launch('steps', 2, tmp, **kw)}


def _close(got, want, rtol, atol):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_two_ranks_equal_one_process(port_runs):
    one = port_runs['one']
    for rank in port_runs[2]:
        for got, want in zip(rank['metrics'], one['metrics']):
            for k in ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc',
                      'log_qy_x', 'c_sum'):
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=1e-5, err_msg=k)
            assert torch.equal(got['c_nan'], want['c_nan'])
        _close(rank['state']['params'], one['state']['params'], 2e-4, 1e-6)
        assert rank['state']['step'] == one['state']['step'] == 7


def test_ranks_end_with_one_state(port_runs):
    a, b = port_runs[2]
    for group in ('params', 'adam_m', 'adam_v'):
        for k, v in a['state'][group].items():
            assert torch.equal(v, b['state'][group][k]), (group, k)


def test_mesh_of_one_equals_no_mesh_bit_for_bit(port_runs):
    one, mesh1 = port_runs['one'], port_runs[1]
    for got, want in zip(mesh1['metrics'], one['metrics']):
        assert all(torch.equal(got[k], want[k]) for k in want)
    for group in ('params', 'adam_m', 'adam_v'):
        for k, v in one['state'][group].items():
            assert torch.equal(mesh1['state'][group][k], v), (group, k)


def test_two_ranks_equal_gltvae_mesh(params, tmp_path):
    """gltvae's make_parallel_train_steps and mixed scan on the 8-device
    CPU mesh against the port's DP steps on 2 ranks: the same params,
    batches and each step's noise (gltvae's threefry draws, rebuilt from
    the step's key and injected on the port's side as the global batch's
    draws, which each rank slices)."""
    jm, _ = small_configs()
    cfg = jcfg.TrainConfig(batch_size=W.B, lr=W.LR,
                           classifier_mc_samples=W.K)
    jmodel = JCCVAE(jm)
    mesh = create_mesh()
    jstate = shard_state(create_train_state(
        jmodel, cfg, jax.random.key(0),
        params=jax.tree.map(jnp.asarray, params)), mesh)
    sup, unsup = make_parallel_train_steps(jmodel, cfg, mesh, donate=False)
    mixed = make_parallel_mixed_scan_train_step(jmodel, cfg, mesh,
                                                donate=False)
    batches = _batches(seed=1)
    noise, jmets = [], []
    for (x, y), kind in zip(batches, KINDS):
        noise.append(reconstruct_noise(jstate.next_rng(), kind, W.B, W.K,
                                       z_dim=8, y_dim=4))
        jstate, m = (sup if kind else unsup)(
            jstate, *shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh),
            1.0)
        jmets.append(m)
    for j, kind in enumerate(MASK):
        noise.append(reconstruct_noise(
            jstate.replace(step=jstate.step + j).next_rng(), kind, W.B,
            W.K, z_dim=8, y_dim=4))
    rest = batches[len(KINDS):]
    xs, ys = shard_stacked_batch(
        (jnp.asarray(np.stack([x for x, _ in rest])),
         jnp.asarray(np.stack([y for _, y in rest]))), mesh)
    jstate, m = mixed(jstate, xs, ys, np.asarray(MASK), 1.0)
    jmets.append(m)
    ranks = W.launch('steps', 2, tmp_path,
                     params=params_to_state_dict(params), batches=batches,
                     kinds=KINDS, chunk_mask=MASK, noise=noise)
    want = jax.tree.map(np.asarray, jstate.params)
    for rank in ranks:
        for got, jm_ in zip(rank['metrics'], jmets):
            for k in ('loss', 'elbo'):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(jm_[k]),
                                           rtol=1e-5, err_msg=k)
        got = state_dict_to_params(rank['state']['params'])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


def test_shardmap_close_to_the_annotation_path(tmp_path):
    """Per-rank noise (2 ranks) against the one-process step at the same
    global batch, by tests/test_shardmap.py's rule and on its inputs: the
    model's own initialization (seed 0) and the batch of RandomState(0).
    The rule is statistical: at B = 16 the sup loss's spread over draws is
    itself a few percent."""
    from gltvae_torch.models.ccvae import CCVAE
    mu = np.full((4, 4), 0.5, np.float32)
    np.fill_diagonal(mu, 1.0)
    sd = CCVAE(W.configs()[0], mu_init=mu,
               generator=torch.Generator().manual_seed(0)).state_dict()
    batch = _batches(1, seed=0)[0]
    ref = W.steps(None, sd, [batch], [True], [])
    for rank in W.launch('shardmap', 2, tmp_path, params=sd, batch=batch):
        loss, want = float(rank['metrics']['loss']), \
            float(ref['metrics'][0]['loss'])
        assert abs(loss - want) / abs(want) < 0.05
        for k, v in ref['state']['params'].items():
            assert float((rank['state']['params'][k] - v).abs().max()) \
                <= 2 * W.LR + 1e-6, k


def test_shardmap_noise_is_per_rank():
    """Each rank's draws come from the step's seed folded with its rank:
    two ranks of one step draw differently, one rank twice the same."""
    from gltvae_torch.parallel.shardmap import _RankNoise
    from gltvae_torch.train.state import create_train_state
    from gltvae_torch.models.ccvae import CCVAE
    m, t = W.configs()
    state = create_train_state(CCVAE(m, mu_init=np.eye(4)), t)
    def draw(rank):
        dp = _RankNoise(Mesh(rank, 2, torch.device('cpu')))
        return dp.rows_of(dp.draws(state, 8, True, W.K))
    a, b, a2 = draw(0), draw(1), draw(0)
    assert a['eps_z'].shape == (8, 8) and a['eps_k'].shape == (W.K, 8, 8)
    assert not torch.equal(a['eps_z'], b['eps_z'])
    assert all(torch.equal(a[k], a2[k]) for k in a)


def test_global_noise_is_sliced_by_rank():
    """DataParallel.draws, then rows_of: rank r of D keeps rows
    [r·b, (r+1)·b) of the global draw (eps_k on axis 1) and the gate
    Gumbels whole."""
    from gltvae_torch.train.state import create_train_state
    from gltvae_torch.train.steps import draw_noise
    from gltvae_torch.models.ccvae import CCVAE
    m, t = W.configs()
    state = create_train_state(CCVAE(m, mu_init=np.eye(4)), t)
    full = draw_noise(state.model, 12, True, W.K, state.next_generator())
    for rank in range(3):
        dp = tdp.DataParallel(Mesh(rank, 3, torch.device('cpu')))
        got = dp.rows_of(dp.draws(state, 4, True, W.K))
        rows = slice(4 * rank, 4 * rank + 4)
        assert torch.equal(got['eps_z'], full['eps_z'][rows])
        assert torch.equal(got['eps_k'], full['eps_k'][:, rows])
        assert torch.equal(got['g1'], full['g1'])
        assert torch.equal(got['g2'], full['g2'])


def test_shard_batch_both_conventions_and_the_divisibility_message():
    """local=False keeps this rank's rows of the global batch (axis 1 for
    stacked chunks); local=True passes a host-sharded batch through; a
    global dim the world does not divide raises gltvae's message."""
    x = np.arange(12 * 2).reshape(12, 2)
    mesh = Mesh(1, 3, torch.device('cpu'))
    assert np.array_equal(tdp.shard_batch(x, mesh), x[4:8])
    assert tdp.shard_batch(x[4:8], mesh, local=True) is not None
    xs, ys = tdp.shard_stacked_batch((x.reshape(2, 12), x.reshape(2, 12)),
                                     mesh)
    assert np.array_equal(xs, x.reshape(2, 12)[:, 4:8])
    with pytest.raises(ValueError, match='global batch dim 10 not divisible '
                                         'by process_count 3: rows would be '
                                         'silently dropped'):
        tdp.shard_batch(np.zeros((10, 2)), mesh)


def test_place_resident_split_holds_ceil_rows():
    """Each rank holds ⌈N/D⌉ rows of a resident split, the last padded
    with zero rows; labels whole."""
    x = np.arange(7 * 2, dtype=np.uint8).reshape(7, 2)
    y = np.ones((7, 3), np.float32)
    got = [tdp.place_resident_split(x, y, Mesh(r, 3, torch.device('cpu')))
           for r in range(3)]
    assert [tuple(g[0].shape) for g in got] == [(3, 2)] * 3
    assert np.array_equal(torch.cat([g[0] for g in got])[:7].numpy(), x)
    assert not got[2][0][1:].any() and tuple(got[1][1].shape) == (7, 3)


def test_concurrent_builds_keep_their_own_logs(tmp_path, monkeypatch):
    """Two ranks building one kernel at once: each nvcc writes its library
    and its log under its own process id, so a failed build raises with
    its own log, and a finished one moves its own log beside the
    library."""
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\necho "ptxas info: $PTXAS_SAYS"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    '[ "$PTXAS_SAYS" = fail ] && exit 1\n'
                    'echo lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    started = {}
    for pid, says in ((101, 'fail'), (202, 'rank two')):
        monkeypatch.setattr(os, 'getpid', lambda pid=pid: pid)
        monkeypatch.setenv('PTXAS_SAYS', says)
        started[says] = _build._start('dequant')
    assert started['fail'][1] != started['rank two'][1]
    with pytest.raises(RuntimeError, match='ptxas info: fail'):
        _build._finish('dequant', started['fail'])
    _build._finish('dequant', started['rank two'])
    assert _build.library_path('dequant').read_text() == 'lib\n'
    assert _build.build_log('dequant') == 'ptxas info: rank two\n'
