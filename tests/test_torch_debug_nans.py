"""``--debug-nans`` (gltvae_torch.utils.debug_nans) raises where
``jax_debug_nans`` raises, on the same params and batches at the test
widths: a clean sup and unsup step raises in neither package; with one
NaN encoder weight both raise FloatingPointError (the port names an aten
op); without the flag both finish with a NaN loss. The Trainer and the CLI
run a clean epoch under the flag (resident chunks and eval passes
included), and a NaN first made in the backward pass is named too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state
from gltvae.train.steps import make_train_steps as j_make_train_steps
from tests.test_torch_config_bridge import (jax_params, scheme_mu,
                                            small_configs, torch_model)

import gltvae_torch.config as tcfg
from gltvae_torch import cli
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import create_train_state as t_create
from gltvae_torch.train.steps import make_train_steps
from gltvae_torch.utils.debug_nans import nan_checked

torch.set_num_threads(2)

B = 8


def _packages(nan_weight: bool):
    """(gltvae (sup, unsup, state), port (sup, unsup, state)) on one set
    of params, the encoder's first kernel NaN at one element if asked."""
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm), seed=5)
    if nan_weight:
        params['encoder']['conv1']['kernel'][0, 0, 0, 0] = np.nan
    train_cfg = jcfg.TrainConfig(batch_size=B, perc_supervision=0.5)
    jmodel = JCCVAE(jm)
    jstate = create_train_state(jmodel, train_cfg, jax.random.key(0),
                                params=jax.tree.map(jnp.asarray, params))
    j_steps = [jax.jit(f) for f in
               j_make_train_steps(jmodel, train_cfg, jit=False)]
    tcfg_ = tcfg.TrainConfig(batch_size=B, perc_supervision=0.5)
    model = torch_model(tm, params)
    return (*j_steps, jstate), (*make_train_steps(model, tcfg_),
                                t_create(model, tcfg_))


def _batch():
    r = np.random.RandomState(6)
    return (r.randint(0, 256, (B, 16, 16, 3), dtype=np.uint8),
            (r.rand(B, 4) > 0.5).astype(np.float32))


def _run(nan_weight: bool, debug: bool, sup: bool):
    """Each package's loss after one step (sup or unsup), or the
    FloatingPointError it raised."""
    (j_sup, j_unsup, jstate), (t_sup, t_unsup, state) = _packages(nan_weight)
    x, y = _batch()
    out = []
    try:
        with jax.debug_nans(debug):
            _, m = (j_sup if sup else j_unsup)(jstate, jnp.asarray(x),
                                               jnp.asarray(y), 1.0)
            out.append(float(m['loss']))
    except FloatingPointError as e:
        out.append(e)
    step = t_sup if sup else t_unsup
    try:
        _, m = (nan_checked(step) if debug else step)(
            state, torch.from_numpy(x), torch.from_numpy(y), 1.0)
        out.append(float(m['loss']))
    except FloatingPointError as e:
        out.append(e)
    return out


@pytest.mark.parametrize('sup', [True, False], ids=['sup', 'unsup'])
def test_clean_step_raises_in_neither_package(sup):
    j, t = _run(nan_weight=False, debug=True, sup=sup)
    assert np.isfinite(j) and np.isfinite(t)    # (each its own noise)


@pytest.mark.parametrize('sup', [True, False], ids=['sup', 'unsup'])
def test_nan_weight_raises_in_both_packages(sup):
    j, t = _run(nan_weight=True, debug=True, sup=sup)
    assert isinstance(j, FloatingPointError), j
    assert isinstance(t, FloatingPointError), t
    assert 'invalid value (nan)' in str(j)
    assert 'aten.convolution' in str(t)


@pytest.mark.parametrize('sup', [True, False], ids=['sup', 'unsup'])
def test_nan_weight_without_the_flag_gives_a_nan_loss(sup):
    j, t = _run(nan_weight=True, debug=False, sup=sup)
    assert np.isnan(j) and np.isnan(t)


def test_replay_restores_the_state_and_names_a_backward_nan():
    """A NaN first made in the backward pass (d sqrt at 0) is named by its
    aten op; the replay starts from the step's inputs, and it raises
    before the update, so the state is left as it was."""
    calls = []

    def step(state, x):
        calls.append(state.step)
        g, = torch.autograd.grad((torch.sqrt(x * state.model.w) * 0).sum(),
                                 [state.model.w])
        state.model.w.data.add_(g)
        state.step += 1
        return state, {'g': g}

    state = t_create(torch_model(*_tiny()), tcfg.TrainConfig())
    state.model.w = torch.nn.Parameter(torch.tensor([0.0, 1.0]))
    with pytest.raises(FloatingPointError, match=r'aten\.div'):
        nan_checked(step)(state, torch.tensor([1.0, 1.0]))
    assert calls == [0, 0] and state.step == 0
    assert torch.equal(state.model.w, torch.tensor([0.0, 1.0]))


def _tiny():
    jm, tm = small_configs()
    return tm, jax_params(jm, scheme_mu(jm))


def test_trainer_and_cli_run_a_clean_epoch_under_the_flag(tmp_path):
    res = cli.main(['--synthetic', '--synthetic-n', '64', '-bs', '16',
                    '--epochs', '1', '--sup', '0.5', '--do-train',
                    '--debug-nans', '--device', 'cpu',
                    '--output-dir', str(tmp_path)])
    assert np.isfinite(res[0.5])
    tm, params = _tiny()
    t = Trainer(tm, tcfg.TrainConfig(batch_size=8, perc_supervision=1.0),
                mu_init=params['mu'], device='cpu', debug_nans=True)
    with torch.no_grad():
        t.model.encoder.conv1.weight[0, 0, 0, 0] = float('nan')
    x, y = _batch()
    with pytest.raises(FloatingPointError, match='aten'):
        t._sup_step(t.state, torch.from_numpy(x), torch.from_numpy(y), 1.0)
