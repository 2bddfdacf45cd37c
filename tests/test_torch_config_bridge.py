"""gltvae_torch config and parameter bridge against the JAX package.

Also holds the small helpers the other tests/test_torch_*.py files share:
a small model config and random gltvae params shaped by ``CCVAE.init``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.gating import cooccurrence_gating_matrix as j_cooc

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import params_to_state_dict, state_dict_to_params
from gltvae_torch.models.ccvae import CCVAE as TCCVAE

torch.set_num_threads(2)

# a few layers, narrow widths: 16px -> 8 -> 4 -> valid 4x4 conv -> 1x1
SMALL = dict(image_size=16, z_dim=8, y_dim=4, enc_features=(8, 8),
             enc_hidden=16, dec_features=(16, 8))

SCHEMES = [('learnable', 'inferred'), ('fixed', 'inferred'),
           ('fixed', 'one-one')]


def small_configs(gate_type='learnable', gate_subtype='inferred', **kw):
    """(gltvae ModelConfig, gltvae_torch ModelConfig), same fields."""
    fields = dict(SMALL, gate_type=gate_type, gate_subtype=gate_subtype, **kw)
    return jcfg.ModelConfig(**fields), tcfg.ModelConfig(**fields)


def scheme_mu(model_cfg, seed=0):
    """μ for a gate scheme: identity for fixed one-one, else a
    co-occurrence matrix (unit diagonal: the clip's tie case)."""
    if model_cfg.gate_type == 'fixed' and model_cfg.gate_subtype == 'one-one':
        return np.eye(model_cfg.z_classify, model_cfg.y_dim, dtype=np.float32)
    labels = np.random.RandomState(seed).rand(64, model_cfg.y_dim) > 0.5
    return j_cooc(labels).astype(np.float32)


def jax_params(model_cfg, mu, seed=0):
    """A gltvae params pytree of numpy arrays shaped by CCVAE.init, filled
    with glorot-scaled normals (traced with eval_shape, so nothing of the
    JAX init is compiled)."""
    model = JCCVAE(model_cfg)
    shapes = jax.eval_shape(lambda k: model.init(k, mu_init=mu),
                            jax.random.key(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == 'mu':
            return np.asarray(mu, np.float32)
        if name == 'kernel' and len(s.shape) >= 2:
            rf = int(np.prod(s.shape[:-2]))
            std = np.sqrt(2.0 / (rf * (s.shape[-2] + s.shape[-1])))
        else:
            std = 0.1
        return (rng.standard_normal(s.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def torch_model(model_cfg, params):
    """gltvae_torch CCVAE carrying `params` (a gltvae pytree)."""
    model = TCCVAE(model_cfg, mu_init=params['mu'])
    model.load_state_dict(params_to_state_dict(params), strict=True)
    return model


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


# ----------------------------- config -----------------------------

def test_config_fields_and_defaults_equal():
    for j, t in ((jcfg.ModelConfig, tcfg.ModelConfig),
                 (jcfg.TrainConfig, tcfg.TrainConfig),
                 (jcfg.DataConfig, tcfg.DataConfig)):
        assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    for fn in ('default_celeba64', 'celeba128'):
        jm, jt = getattr(jcfg, fn)(sup=0.5)
        tm, tt = getattr(tcfg, fn)(sup=0.5)
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert tcfg.CELEBA_LABELS == jcfg.CELEBA_LABELS
    assert tcfg.CELEBA_EASY_LABELS == jcfg.CELEBA_EASY_LABELS
    m = tcfg.ModelConfig()
    assert (m.z_classify, m.z_style, m.mu_trainable) == (18, 27, True)
    assert m.dtype == torch.float32 and m.matmul_precision == 'highest'


@pytest.mark.parametrize('bad', [dict(gate_type='x'), dict(gate_subtype='x'),
                                 dict(y_dim=50), dict(posterior_locs='x'),
                                 dict(input_s2d=True, image_size=63)])
def test_config_validation_matches(bad):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.ModelConfig(**bad)


def test_model_config_json_read_by_both(tmp_path):
    cfg = dict(image_size=128, z_dim=100, y_dim=40,
               enc_features=(32, 32, 64, 128, 256), gate_type='fixed',
               posterior_locs='linear')
    a, b = tmp_path / 'a', tmp_path / 'b'
    a.mkdir()
    b.mkdir()
    jcfg.save_model_config(jcfg.ModelConfig(**cfg), str(a))
    tcfg.save_model_config(tcfg.ModelConfig(**cfg), str(b))
    assert (a / 'model_config.json').read_text() == \
        (b / 'model_config.json').read_text()
    assert tcfg.load_model_config(str(a)) == tcfg.ModelConfig(**cfg)
    assert jcfg.load_model_config(str(b)) == jcfg.ModelConfig(**cfg)
    assert tcfg.load_model_config(str(tmp_path)) is None


@pytest.mark.parametrize('bad', [dict(compute_dtype='bfloat16'),
                                 dict(input_s2d=True), dict(output_s2d=True)])
def test_unsupported_model_values_raise(bad):
    """bf16 and the s2d flags, once unsupported, now build a model; the one
    value still raising is a device mesh (ROADMAP Queue 1 item 12)."""
    cfg = tcfg.ModelConfig(**bad)
    tcfg.check_supported(cfg)
    model = TCCVAE(cfg, mu_init=np.eye(18))
    assert model.encoder.input_s2d == cfg.input_s2d
    assert model.decoder.output_s2d == cfg.output_s2d
    assert model.encoder.dtype == model.classifier.dtype == cfg.dtype
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tcfg.check_supported(cfg, mesh=object())


@pytest.mark.parametrize('train,data', [
    (dict(remat='full'), {}), (dict(augment_pad=2), dict(augment_pad=2)),
    ({}, dict(device_resize=True))])
def test_unsupported_train_data_values_raise(train, data):
    """remat, augment_pad and device_resize, once unsupported, now pass;
    only a mesh raises, naming its ROADMAP item."""
    args = (tcfg.ModelConfig(), tcfg.TrainConfig(**train),
            tcfg.DataConfig(**data))
    tcfg.check_supported(*args)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tcfg.check_supported(*args, mesh=object())


# ----------------------------- bridge -----------------------------

@pytest.mark.parametrize('name', ['default_celeba64', 'celeba128'])
def test_bridge_round_trip_bit_identical(name):
    jm, _ = getattr(jcfg, name)()
    tm, _ = getattr(tcfg, name)()
    params = jax_params(jm, scheme_mu(jm))
    model = torch_model(tm, params)        # strict load: every name/shape
    back = state_dict_to_params(model.state_dict())
    _tree_equal(params, back)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))


def test_bridge_layouts():
    jm, tm = small_configs()
    params = jax_params(jm, scheme_mu(jm))
    sd = params_to_state_dict(params)
    k = params['encoder']['conv1']['kernel']            # HWIO
    assert np.array_equal(sd['encoder.conv1.weight'].numpy(),
                          k.transpose(3, 2, 0, 1))      # OIHW
    kt = params['decoder']['conv2t']['kernel']          # (kh, kw, out, in)
    w = sd['decoder.conv2t.weight'].numpy()             # (in, out, kh, kw)
    assert w[1, 2, 3, 0] == kt[3, 0, 2, 1]
    assert np.array_equal(sd['encoder.locs.weight'].numpy(),
                          params['encoder']['locs']['kernel'].T)
    assert np.array_equal(sd['classifier.kernel'].numpy(),
                          params['classifier']['kernel'])
