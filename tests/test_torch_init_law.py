"""The port's initial draw for fixed/one-one against gltvae's, tensor by
tensor, and the pieces of ``tests/torch_init_report.py`` that the fault-F2
rule reads.

- gltvae's draw as the report makes it is the one gltvae's CLI trains at
  ``--seed s`` for the cell (the pairing of the report's two legs rests on
  it);
- each port tensor spans its Flax initializer's range: the glorot limit
  sqrt(6 / (fan_in + fan_out)) over Flax's fans, N(0, 0.05), or gltvae's
  zeros, ones and identity;
- a two-sample KS test per tensor, values pooled over seeds 0-4, passes at
  the rule's threshold 0.001 / (number of tensors);
- the census's dead-unit count on hand-made encoders.
"""

import math

import jax
import numpy as np
import pytest
import torch

import train as jtrain
from gltvae.train.loop import Trainer as JTrainer
from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.models.ccvae import CCVAE
from tests import torch_init_report as report

N_TENSORS = 33
KS_THRESHOLD = 0.001 / N_TENSORS
POOLED_SEEDS = range(5)
# TFConvTranspose keeps TF's (kh, kw, out, in) layout: glorot over in=-1,
# out=-2 (gltvae/models/networks.py, TFConvTranspose)
_TRANSPOSED = ('conv1t', 'conv2t', 'conv3t', 'conv4t', 'conv5t')


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    from tools.parity_corpus import generate_corpus
    d = tmp_path_factory.mktemp('init_law') / 'data'
    generate_corpus(str(d), n=35, seed=0)
    return str(d)


def _cli_initial_params(corpus, seed):
    """The parameters gltvae's Trainer starts from when train.py runs the
    cell as tools/seed_panel.py runs it, at ``--seed seed``."""
    argv = ['--do-train', '--epochs', '12', '-bs', '64', '--data-dir',
            corpus, '--gate-type', 'fixed', '--gate-subtype', 'one-one',
            '--sup', '1.0', '--n-train', '25', '--n-valid', '5',
            '--n-test', '5', '--seed', str(seed), '--parity',
            '--decode-backend', 'pil', '--posterior-locs', 'relu',
            '--steps-per-dispatch', '8', '--platform', 'cpu']
    args = jtrain.parse_args(argv)
    model_cfg, train_cfg, data_cfg = jtrain.build_configs(args, 1.0)
    _, mu_init, _ = jtrain.make_loaders(args, data_cfg, train_cfg,
                                        model_cfg.y_dim)
    trainer = JTrainer(model_cfg, train_cfg, mu_init=mu_init,
                       steps_per_dispatch=args.steps_per_dispatch)
    return params_to_state_dict(jax.tree.map(np.asarray,
                                             trainer.state.params))


@pytest.mark.parametrize('seed', [0, 2, 17])
def test_report_draw_is_what_gltvae_cli_trains(corpus, seed):
    ours = report.gltvae_init(seed)
    theirs = _cli_initial_params(corpus, seed)
    assert list(ours) == list(theirs)
    for name in theirs:
        torch.testing.assert_close(ours[name], theirs[name], rtol=0, atol=0,
                                   msg=name)


@pytest.fixture(scope='module')
def pooled():
    """{'port' / 'gltvae': {name: values pooled over POOLED_SEEDS}}, the
    port's in Flax layout."""
    out = {'port': {}, 'gltvae': {}}
    for seed in POOLED_SEEDS:
        for key, sd in (('port', report.port_init(seed)),
                        ('gltvae', report.gltvae_init(seed))):
            for name, t in sd.items():
                out[key].setdefault(name, []).append(t.numpy())
    return {k: {n: np.stack(v) for n, v in d.items()}
            for k, d in out.items()}


def _names():
    return list(report.port_init(0))


def test_tensor_count():
    assert len(_names()) == N_TENSORS


def _flax_glorot_limit(name, flax_shape):
    """sqrt(6 / (fan_in + fan_out)) with Flax's variance_scaling fans for
    the kernel's axes."""
    in_axis, out_axis = ((-1, -2) if name.split('.')[1] in _TRANSPOSED
                         else (-2, -1))
    receptive = math.prod(flax_shape) // (flax_shape[in_axis]
                                          * flax_shape[out_axis])
    fan_in = flax_shape[in_axis] * receptive
    fan_out = flax_shape[out_axis] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


def _flax_shape(name):
    path = name.split('.')
    if path[-1] == 'weight':
        path[-1] = 'kernel'
    node = jax.tree.map(np.asarray, state_dict_to_params(report.port_init(0)))
    for p in path:
        node = node[p]
    return node.shape


@pytest.mark.parametrize('name', _names())
def test_port_tensor_spans_the_flax_initializer(pooled, name):
    ours, theirs = pooled['port'][name], pooled['gltvae'][name]
    assert ours.shape == theirs.shape
    if theirs.min() == theirs.max() or name == 'mu':
        # gltvae's zeros, ones or identity: the same constants
        np.testing.assert_array_equal(ours, theirs)
        return
    n = ours.size
    if name.startswith('classifier.'):
        # N(0, 0.05), kernel and bias alike: the sample std within 5 of its
        # standard errors (0.05 / sqrt(2n)), the mean within 5 of its own
        assert abs(ours.std() - 0.05) < 5 * 0.05 / math.sqrt(2 * n), name
        assert abs(ours.mean()) < 5 * 0.05 / math.sqrt(n), name
        return
    limit = _flax_glorot_limit(name, _flax_shape(name))
    for x in (ours, theirs):
        # bounded by the limit and reaching it, std limit/sqrt(3)
        assert np.abs(x).max() <= limit * (1 + 1e-6), name
        assert np.abs(x).max() > limit * (1 - 20.0 / n), name
        assert abs(x.std() / (limit / math.sqrt(3)) - 1) < 5 * math.sqrt(
            0.8 / 4 / n), name


@pytest.mark.parametrize('name', _names())
def test_port_tensor_law_ks_against_gltvae(pooled, name):
    d, p = report.tensor_ks(pooled['port'][name], pooled['gltvae'][name])
    assert p >= KS_THRESHOLD, (name, d, p)


def _encoder_with_biases(bias):
    model = CCVAE(report.cell_config())
    with torch.no_grad():
        model.encoder.locs.bias.copy_(torch.as_tensor(bias))
    return model.encoder


@pytest.mark.parametrize('dead', [(), (0,), (3, 17), tuple(range(18))])
def test_census_counts_dead_z_classify_dims(dead):
    """A locs bias far below any pre-activation kills that dim on every
    image; a z_style dim so set does not count."""
    bias = np.full(45, 50.0, np.float32)
    for j in dead:
        bias[27 + j] = -1e6
    bias[0] = -1e6                      # z_style: not a z_classify dim
    images = np.random.RandomState(0).randint(0, 256, (40, 64, 64, 3),
                                              dtype=np.uint8)
    locs = report.encoder_locs(_encoder_with_biases(bias), images, bs=16)
    got = report.locs_census(locs)
    assert got['dead'] == len(dead)
    assert got['active'] == pytest.approx(1 - len(dead) / 18)
    assert got['mean'] > 0 or len(dead) == 18


def test_census_counts_a_dim_dead_only_on_every_image():
    """A dim that is 0 on all images but one is alive."""
    locs = torch.zeros(10, 45)
    locs[:, 27:] = 1.0
    locs[:, 30] = 0.0
    locs[:, 31] = 0.0
    locs[4, 31] = 0.5
    got = report.locs_census(locs)
    assert got['dead'] == 1
    assert got['active'] == pytest.approx((10 * 16 + 1) / 180)


@pytest.mark.parametrize('group', sorted(report.SWAP_GROUPS))
def test_swap_takes_one_group_from_gltvae(group):
    mixed = report.swapped_init(3, group)
    ours, theirs = report.port_init(3), report.gltvae_init(3)
    prefixes = report.SWAP_GROUPS[group]
    for name, t in mixed.items():
        src = theirs if name.startswith(prefixes) else ours
        assert torch.equal(t, src[name]), name
    assert any(name.startswith(prefixes) and not torch.equal(ours[name],
                                                             theirs[name])
               for name in mixed)
