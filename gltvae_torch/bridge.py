"""Parameter bridge: the JAX package's params pytree <-> the port's
state_dict.

The pytree is given as nested dicts of numpy arrays (``jax.device_get`` of
``CCVAE.init``'s tree). By leaf:

- a 4-d ``kernel`` is a Flax conv (HWIO) or a ``TFConvTranspose``
  (kh, kw, out, in); both become torch's layout by the same permutation,
  (3, 2, 0, 1): Conv2d (out, in, kh, kw), ConvTranspose2d (in, out, kh, kw);
- a 2-d ``kernel`` of the encoder or decoder is a Dense (in, out) and
  becomes a Linear weight (out, in);
- ``kernel`` becomes ``weight`` in those cases; the classifier, the
  conditional prior and ``mu`` pass through unchanged.

The same mapping carries Adam's first and second moments, so a test can
start both packages from one optimizer state. Round trips are exact (pure
transposes).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_DENSE_OWNERS = ('encoder', 'decoder')


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """gltvae params pytree (nested dicts of arrays) -> CCVAE state_dict.
    Adam's moment trees (optax ``.mu``/``.nu``) map the same way; a frozen
    μ's leaf may be absent."""
    out = {}
    for path, leaf in _flatten(params):
        a = np.asarray(leaf)
        name = list(path)
        if path[-1] == 'kernel' and a.ndim == 4:
            a, name[-1] = a.transpose(3, 2, 0, 1), 'weight'
        elif (path[-1] == 'kernel' and a.ndim == 2
              and path[0] in _DENSE_OWNERS):
            a, name[-1] = a.T, 'weight'
        out['.'.join(name)] = torch.from_numpy(np.array(a, copy=True))
    return out


def state_dict_to_params(state_dict: Dict[str, torch.Tensor]) -> dict:
    """CCVAE state_dict (or Adam moments keyed alike) -> gltvae pytree of
    numpy arrays."""
    out: dict = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        path = key.split('.')
        if path[-1] == 'weight' and a.ndim == 4:
            a, path[-1] = a.transpose(2, 3, 1, 0), 'kernel'
        elif path[-1] == 'weight' and a.ndim == 2:
            a, path[-1] = a.T, 'kernel'
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out

