"""The plain reference against gltvae_torch's eager path on the CPU, at a
small batch: the losses and their gradients, Keras Adam, the stochastic
eval, and what the reference works out again of the program's
derivations (gating init, index streams, schedule, step seeds).

Run with ``python -m pytest perfbench -q``. The reference itself imports
nothing of the program; this test imports both.
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness as H  # noqa: E402
from reference import ccvae as R  # noqa: E402
from reference import streams as S  # noqa: E402

B, K = 6, 5


def _cell(config):
    """A cell of `config` with no traffic: what the reference tests need."""
    with open(os.path.join(H.BENCH, 'configs', f'{config}.json')) as f:
        return H.Cell(config, {'traffic': {}, 'chips': 1}, json.load(f))


def _port(cell, params):
    from gltvae_torch.models.ccvae import CCVAE
    mcfg = H.model_config(cell)
    mcfg = dataclasses.replace(mcfg, compute_dtype='float32')
    model = CCVAE(mcfg, mu_init=params['mu'].numpy())
    model.load_state_dict({n: v.clone() for n, v in params.items()})
    return model


def _inputs(cell, seed=3):
    m = dict(cell.model, compute_dtype='float32')
    g = torch.Generator().manual_seed(seed)
    p = H.make_weights(cell, seed, 'cpu')
    lab = (torch.rand((64, m['y_dim']), generator=g) < 0.4).numpy()
    lab[:, 0] = 1
    p['mu'] = torch.from_numpy(S.cooccurrence(lab))
    s = m['image_size']
    x = torch.randint(0, 256, (B, s, s, 3), generator=g).float() / 255.0
    y = (torch.rand((B, m['y_dim']), generator=g) < 0.5).float()
    z, yd = m['z_dim'], m['y_dim']
    noise = {'eps_z': torch.randn((B, z), generator=g),
             'u1': torch.rand((yd, yd), generator=g),
             'u2': torch.rand((yd, yd), generator=g),
             'eps_k': torch.randn((K, B, z), generator=g),
             'u_y': torch.rand((B, yd), generator=g)}
    return m, p, x, y, noise


def _port_noise(noise):
    out = {k: v for k, v in noise.items() if k not in ('u1', 'u2')}
    out['g1'], out['g2'] = R.gumbel(noise['u1']), R.gumbel(noise['u2'])
    return out


@pytest.mark.parametrize('name', ['celeba64', 'celeba128'])
@pytest.mark.parametrize('supervised', [True, False])
def test_loss_and_gradients_match_the_port(name, supervised):
    from gltvae_torch.models.ccvae import Temps
    cell = _cell(name)
    m, p, x, y, noise = _inputs(cell)
    model = _port(cell, p)
    temps = Temps(gating=torch.tensor(0.7))
    pn = _port_noise(noise)
    if supervised:
        lp, _ = model.sup_loss(x, y, temps, gating_reg=0.2, k=K, noise=pn)
    else:
        lp, _ = model.unsup_loss(x, temps, gating_reg=0.2, noise=pn)
    gp = torch.autograd.grad(lp, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    leaves = {n: v.clone().requires_grad_(True) for n, v in p.items()}
    lr = R.loss(leaves, x, y, noise, 0.7, m, 0.2, K, R.Ops('f32'),
                supervised)
    gr = torch.autograd.grad(lr, [leaves[n] for n in names])
    assert float(lr.detach()) == pytest.approx(float(lp.detach()), rel=1e-5)
    for n, a, b in zip(names, gp, gr):
        scale = max(float(b.norm()), 1e-6)
        assert float((a - b).norm()) / scale < 2e-4, n


def test_adam_matches_keras_adam_of_the_port():
    from gltvae_torch.train.state import (create_train_state,
                                          keras_adam_update, keras_alpha)
    cell = _cell('celeba64')
    _, p, *_ = _inputs(cell)
    model = _port(cell, p)
    st = create_train_state(model, H.train_config(cell, 0))
    mine = {n: v.clone() for n, v in p.items()}
    opt = R.Adam(mine, 1e-4, 1e-7)
    g = torch.Generator().manual_seed(5)
    for _ in range(3):
        grads = {n: torch.randn(v.shape, generator=g) for n, v in p.items()}
        keras_adam_update(st, grads, 1e-4, eps=1e-7)
        opt.step(mine, grads)
    for n, v in model.named_parameters():
        assert torch.equal(v.detach(), mine[n]), n
    assert R.keras_alpha(7, 1e-4) == keras_alpha(7, 1e-4)


def test_eval_accuracy_matches_the_port():
    from gltvae_torch.models.ccvae import Temps
    cell = _cell('celeba64')
    m, p, x, y, noise = _inputs(cell, seed=11)
    model = _port(cell, p)
    acc = model.classifier_accuracy(x, y, Temps(gating=torch.tensor(0.3)),
                                    noise=_port_noise(noise))
    ref = R.eval_pass(p, [(x, y)], [noise], 0.3, m)
    assert ref == pytest.approx(float(acc), abs=1e-7)


def test_streams_match_the_programs_derivations():
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.ops.gating import gating_matrix_from_labels
    from gltvae_torch.train.loop import Trainer
    from gltvae_torch.train.state import step_seed
    seed = 2 ** 31 + 77
    ds = ArrayDataset(np.zeros((50, 1, 1, 3), np.uint8),
                      np.zeros((50, 2), np.float32))
    loader = BatchLoader(ds, 16, seed=seed)
    mine = S.batches(50, 16, seed)
    for _ in range(12):
        assert np.array_equal(loader._next_batch_idxs(), next(mine))
    for n_sup, n_unsup, bs, sup in ((32554, 130216, 256, 0.2),
                                    (40, 0, 16, 1.0), (30, 70, 8, 0.5)):
        sb, ub = math.ceil(n_sup / bs), math.ceil(n_unsup / bs)
        total, period = (sb, 1) if sup == 1.0 else (sb + ub,
                                                    int((sb + ub) / sb))
        want = Trainer._schedule_flags(total, period, sb)
        assert S.schedule(n_sup, n_unsup, bs, sup) == want
    assert S.step_seed(seed, 9) == step_seed(seed, 9)
    lab = (np.random.RandomState(0).rand(40, 6) < 0.3).astype(np.float32)
    mu = gating_matrix_from_labels(lab[:25], lab[25:], 6, 0.2)
    assert np.array_equal(S.cooccurrence(lab),
                          torch.as_tensor(mu, dtype=torch.float32).numpy())


def test_draws_match_the_programs_draws():
    from gltvae_torch.train.steps import draw_eval_noise, draw_noise
    cell = _cell('celeba64')
    _, p, *_ = _inputs(cell)
    model = _port(cell, p)
    m = cell.model
    for sup in (True, False):
        g = torch.Generator().manual_seed(S.step_seed(9, 4))
        theirs = draw_noise(model, B, sup, K, g, raw=True)
        mine = S.train_noise(9, 4, B, m, K, sup, 'cpu')
        assert theirs.keys() == mine.keys()
        for k in mine:
            assert torch.equal(theirs[k], mine[k]), k
    g, mine = S.eval_generator(9, 'cpu'), S.eval_generator(9, 'cpu')
    from gltvae_torch.train.state import step_seed
    g.manual_seed(step_seed(10, 0))
    for _ in range(2):
        theirs = draw_eval_noise(model, B, g, raw=True)
        ours = S.eval_noise(mine, B, m, 'cpu')
        for k in ours:
            assert torch.equal(theirs[k], ours[k]), k


def test_the_reference_imports_nothing_of_the_program():
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'reference')
    for f in os.listdir(here):
        if f.endswith('.py'):
            src = open(os.path.join(here, f)).read()
            assert 'gltvae' not in src.replace('gltvae_torch', '')
            assert 'import gltvae' not in src and 'from gltvae' not in src
