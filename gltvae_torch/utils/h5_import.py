"""Import the reference's Keras .h5 checkpoints into the port's state_dict
(counterpart of gltvae/utils/h5_import.py).

The reference saves one weight file per sub-model plus the learned gating
matrix as .npy (its gated_ccvae.py:391-401). The layer layouts need no
change on the way in: Keras Conv2D kernels are (kh, kw, in, out), as the
JAX package's convs, and Keras Conv2DTranspose kernels are (kh, kw, out,
in), as its transposed convs, so the files give the JAX package's params
pytree and ``bridge.params_to_state_dict`` maps that to the port.
Dataset paths look like '<layer>/<model>/<layer>/kernel:0'.

h5py is imported when a file is read, so the port imports without it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from gltvae_torch.bridge import params_to_state_dict


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError('Keras .h5 checkpoints need the h5py package, '
                          'which is not installed') from e
    return h5py


def _load_h5_weights(path: str) -> Dict[str, np.ndarray]:
    """Flatten an h5 weight file to {'<layer>/<var>': array}."""
    out = {}
    with _h5py().File(path, 'r') as f:
        def visit(name, obj):
            if hasattr(obj, 'shape') and obj.shape is not None:
                # 'conv2d_1/encoder/conv2d_1/kernel:0' -> ('conv2d_1','kernel')
                parts = name.split('/')
                layer, var = parts[0], parts[-1].split(':')[0]
                out[f'{layer}/{var}'] = np.array(obj)
        f.visititems(visit)
    return out


def _ordered_layers(weights: Dict[str, np.ndarray], prefix: str):
    """Layer names '<prefix>', '<prefix>_1', ... in numeric order (so
    'dense_10' follows 'dense_2')."""
    return sorted(
        {k.split('/')[0] for k in weights if k.split('/')[0] == prefix
         or re.fullmatch(re.escape(prefix) + r'_\d+', k.split('/')[0])},
        key=lambda s: int(s.rsplit('_', 1)[1]) if s[len(prefix):] else -1)


def load_encoder_params(path: str) -> dict:
    w = _load_h5_weights(path)
    convs = _ordered_layers(w, 'conv2d')
    denses = _ordered_layers(w, 'dense')
    params = {}
    for i, name in enumerate(convs):
        params[f'conv{i + 1}'] = {'kernel': w[f'{name}/kernel'],
                                  'bias': w[f'{name}/bias']}
    # declaration order: locs first, then scale
    params['locs'] = {'kernel': w[f'{denses[0]}/kernel'],
                      'bias': w[f'{denses[0]}/bias']}
    params['scale'] = {'kernel': w[f'{denses[1]}/kernel'],
                       'bias': w[f'{denses[1]}/bias']}
    return params


def load_decoder_params(path: str) -> dict:
    w = _load_h5_weights(path)
    deconvs = _ordered_layers(w, 'conv2d_transpose')
    denses = _ordered_layers(w, 'dense')
    params = {'fc1': {'kernel': w[f'{denses[0]}/kernel'],
                      'bias': w[f'{denses[0]}/bias']}}
    for i, name in enumerate(deconvs):
        params[f'conv{i + 1}t'] = {'kernel': w[f'{name}/kernel'],
                                   'bias': w[f'{name}/bias']}
    return params


def load_classifier_params(path: str) -> dict:
    w = _load_h5_weights(path)
    (layer,) = _ordered_layers(w, 'my_inference_layer')
    return {'kernel': w[f'{layer}/kernel'], 'bias': w[f'{layer}/bias']}


def load_cond_prior_params(path: str) -> dict:
    w = _load_h5_weights(path)
    layers = _ordered_layers(w, 'my_cond_generation_layer')
    # declaration order (the reference's networks.py:113-116)
    keys = ['loc_true', 'loc_false', 'scale_true', 'scale_false']
    return {k: w[f'{layer}/kernel'] for k, layer in zip(keys, layers)}


def load_reference_checkpoint(param_dir: str, model_id: str = 'best',
                              mu: Optional[np.ndarray] = None
                              ) -> Dict[str, torch.Tensor]:
    """The port's CCVAE state_dict from a reference checkpoint folder: the
    four sub-model .h5 files and learned_gating_matrix_{id}.npy, or `mu`
    where the folder has no .npy (fixed gate schemes keep μ outside it)."""
    params = {
        'encoder': load_encoder_params(
            os.path.join(param_dir, f'encoder_model_{model_id}.h5')),
        'decoder': load_decoder_params(
            os.path.join(param_dir, f'decoder_model_{model_id}.h5')),
        'classifier': load_classifier_params(
            os.path.join(param_dir, f'classifier_{model_id}.h5')),
        'cond_prior': load_cond_prior_params(
            os.path.join(param_dir, f'cond_prior_{model_id}.h5')),
    }
    mu_path = os.path.join(param_dir, f'learned_gating_matrix_{model_id}.npy')
    if os.path.exists(mu_path):
        params['mu'] = np.load(mu_path).astype(np.float32)
    elif mu is not None:
        params['mu'] = np.asarray(mu, np.float32)
    else:
        raise FileNotFoundError(
            f'no learned gating matrix in {param_dir}; pass mu= explicitly')
    return params_to_state_dict(params)
