"""Export the port's parameters to the reference's Keras .h5 checkpoint
format (counterpart of gltvae/utils/h5_export.py).

The inverse of utils/h5_import.py: one weight file per sub-model, with the
group layout and Keras metadata the reference's ``Model.load_weights``
reads (its gated_ccvae.py:155-158), so a model trained with the port drops
back into the reference codebase. The files are the JAX package's: the
same attributes (``backend``, ``keras_version``, ``layer_names``, each
group's ``weight_names``, the weightless ``flatten``/``reshape`` groups),
dataset paths '<layer>/<model>/<layer>/<var>:0' and float32 data.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.train.checkpoint import export_gating_matrix
from gltvae_torch.utils.h5_import import _h5py


def _write_keras_h5(path: str, model_name: str,
                    layers: List[Tuple[str, Dict[str, np.ndarray]]],
                    extra_layers: List[str] = ()):
    """layers: [(layer_name, {var_name: array})] in Keras build order;
    extra_layers: weightless layers (e.g. 'flatten') listed in
    layer_names."""
    h5py = _h5py()
    sdt = h5py.string_dtype()
    names = [name for name, _ in layers] + list(extra_layers)
    with h5py.File(path, 'w') as f:
        f.attrs['backend'] = 'tensorflow'
        f.attrs['keras_version'] = '2.8.0'
        f.attrs['layer_names'] = np.array(names, dtype=sdt)
        for name, variables in layers:
            g = f.create_group(name)
            wnames = [f'{model_name}/{name}/{v}:0' for v in variables]
            g.attrs['weight_names'] = np.array(wnames, dtype=sdt)
            for v, arr in variables.items():
                g.create_dataset(f'{model_name}/{name}/{v}:0',
                                 data=np.asarray(arr, np.float32))
        for name in extra_layers:
            g = f.create_group(name)
            g.attrs['weight_names'] = np.array([], dtype=sdt)


def export_encoder(params: dict, path: str):
    n_convs = len([k for k in params if k.startswith('conv')])
    layers = []
    for i in range(n_convs):
        suffix = '' if i == 0 else f'_{i}'
        p = params[f'conv{i + 1}']
        layers.append((f'conv2d{suffix}',
                       {'kernel': p['kernel'], 'bias': p['bias']}))
    layers.append(('dense', {'kernel': params['locs']['kernel'],
                             'bias': params['locs']['bias']}))
    layers.append(('dense_1', {'kernel': params['scale']['kernel'],
                               'bias': params['scale']['bias']}))
    _write_keras_h5(path, 'encoder', layers, extra_layers=['flatten'])


def export_decoder(params: dict, path: str):
    n_deconvs = len([k for k in params if k.endswith('t')])
    layers = [('dense_2', {'kernel': params['fc1']['kernel'],
                           'bias': params['fc1']['bias']})]
    for i in range(n_deconvs):
        suffix = '' if i == 0 else f'_{i}'
        p = params[f'conv{i + 1}t']
        layers.append((f'conv2d_transpose{suffix}',
                       {'kernel': p['kernel'], 'bias': p['bias']}))
    _write_keras_h5(path, 'decoder', layers, extra_layers=['reshape'])


def export_classifier(params: dict, path: str):
    _write_keras_h5(path, 'classifier',
                    [('my_inference_layer',
                      {'kernel': params['kernel'], 'bias': params['bias']})])


def export_cond_prior(params: dict, path: str):
    keys = ['loc_true', 'loc_false', 'scale_true', 'scale_false']
    layers = [(f'my_cond_generation_layer{"" if i == 0 else f"_{i}"}',
               {'kernel': params[k]}) for i, k in enumerate(keys)]
    _write_keras_h5(path, 'conditional__prior', layers)


def export_reference_checkpoint(model_or_state_dict, param_dir: str,
                                model_id: str = 'best', label_names=None):
    """Write the reference's per-sub-model .h5 set (its
    gated_ccvae.py:146-165 reads it) from a CCVAE or its state_dict. This
    function owns the μ artifacts: learned_gating_matrix_{id}.npy always,
    and the labeled .csv when `label_names` is given (the reference writes
    both, gated_ccvae.py:395-401)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    params = state_dict_to_params(sd)
    os.makedirs(param_dir, exist_ok=True)
    export_encoder(params['encoder'],
                   os.path.join(param_dir, f'encoder_model_{model_id}.h5'))
    export_decoder(params['decoder'],
                   os.path.join(param_dir, f'decoder_model_{model_id}.h5'))
    export_classifier(params['classifier'],
                      os.path.join(param_dir, f'classifier_{model_id}.h5'))
    export_cond_prior(params['cond_prior'],
                      os.path.join(param_dir, f'cond_prior_{model_id}.h5'))
    if label_names is not None:
        export_gating_matrix(params['mu'], param_dir, model_id, label_names)
    else:
        np.save(os.path.join(param_dir,
                             f'learned_gating_matrix_{model_id}.npy'),
                np.asarray(params['mu'], np.float32))
