"""gltvae_torch — the gated CCVAE in PyTorch, for one NVIDIA H100.

The PyTorch/CUDA counterpart of the JAX package ``gltvae``, which stays the
reference. Module names mirror ``gltvae`` so each counterpart is easy to
find; this package imports torch and numpy and nothing of JAX or ``gltvae``.

Package layout
--------------
- ``gltvae_torch.config``   ModelConfig/TrainConfig/DataConfig, model_config.json
- ``gltvae_torch.bridge``   gltvae params/Adam pytrees <-> torch state_dicts
- ``gltvae_torch.ops``      distributions, samplers, gating init, the dequant
                            and augment kernels
- ``gltvae_torch.models``   encoder/decoder/classifier/cond-prior, CCVAE losses
- ``gltvae_torch.train``    Keras Adam state, steps, Trainer, metrics, checkpoints
- ``gltvae_torch.data``     in-memory datasets, batch loader, synthetic fixture
- ``gltvae_torch.cli``      ``python -m gltvae_torch.cli`` (train.py counterpart)

Public functions keep the JAX package's NHWC image layout. Entry points run
on ``cuda`` unless the caller passes ``device='cpu'``; without a CUDA
device they raise instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = '0.1.0'


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'gltvae_torch runs on a CUDA device by default and none is '
            "available; pass device='cpu' to run on the CPU")
    return dev
