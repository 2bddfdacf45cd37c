"""Typed configuration of the gated CCVAE, PyTorch side.

A copy of the JAX package's ``config.py`` (same dataclasses, field names,
defaults and ``__post_init__`` validation), kept here so that the port
never imports the JAX package. ``save_model_config``/``load_model_config``
read and write the same ``model_config.json``, so a run directory is
readable by either package.

``dtype`` and ``matmul_precision`` map to torch: ``compute_dtype='float32'``
is the counterpart of ``precision='highest'`` and turns TF32 off in cuDNN
and cuBLAS (``apply_precision``). Values this slice does not support yet
raise ``NotImplementedError`` naming the ROADMAP item that adds them
(``check_supported``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# CelebA attribute vocabularies (the reference's utils_data.py:16-25).
CELEBA_LABELS = (
    '5_o_Clock_Shadow', 'Arched_Eyebrows', 'Attractive', 'Bags_Under_Eyes',
    'Bald', 'Bangs', 'Big_Lips', 'Big_Nose', 'Black_Hair', 'Blond_Hair',
    'Blurry', 'Brown_Hair', 'Bushy_Eyebrows', 'Chubby', 'Double_Chin',
    'Eyeglasses', 'Goatee', 'Gray_Hair', 'Heavy_Makeup', 'High_Cheekbones',
    'Male', 'Mouth_Slightly_Open', 'Mustache', 'Narrow_Eyes', 'No_Beard',
    'Oval_Face', 'Pale_Skin', 'Pointy_Nose', 'Receding_Hairline',
    'Rosy_Cheeks', 'Sideburns', 'Smiling', 'Straight_Hair', 'Wavy_Hair',
    'Wearing_Earrings', 'Wearing_Hat', 'Wearing_Lipstick', 'Wearing_Necklace',
    'Wearing_Necktie', 'Young',
)

CELEBA_EASY_LABELS = (
    'Arched_Eyebrows', 'Bags_Under_Eyes', 'Bangs', 'Black_Hair', 'Blond_Hair',
    'Brown_Hair', 'Bushy_Eyebrows', 'Chubby', 'Eyeglasses', 'Heavy_Makeup',
    'Male', 'No_Beard', 'Pale_Skin', 'Receding_Hairline', 'Smiling',
    'Wavy_Hair', 'Wearing_Necktie', 'Young',
)

GATE_TYPES = ('learnable', 'fixed')
GATE_SUBTYPES = ('one-one', 'inferred')

_TORCH_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the gated CCVAE (defaults: the CelebA-64 model)."""

    image_size: int = 64
    channels: int = 3
    z_dim: int = 45
    y_dim: int = 18                  # == len(CELEBA_EASY_LABELS)
    # Stride-2 conv features; 64px: (32, 32, 64, 128) -> 4x4 spatial, then a
    # valid 4x4 conv to 1x1.
    enc_features: Tuple[int, ...] = (32, 32, 64, 128)
    enc_hidden: int = 256
    dec_features: Tuple[int, ...] = (128, 64, 32, 32)
    # Reference quirk: Decoder(hidden_dim=z_dim), so fc1 is Dense(45 -> 45).
    dec_hidden: Optional[int] = None  # None -> z_dim
    gate_type: str = 'learnable'
    gate_subtype: str = 'inferred'
    label_prior: float = 0.5
    # Posterior-mean head activation: 'relu' (reference) or 'linear'.
    posterior_locs: str = 'relu'
    input_s2d: bool = False
    output_s2d: bool = False
    compute_dtype: str = 'float32'

    def __post_init__(self):
        if self.gate_type not in GATE_TYPES:
            raise ValueError(f'gate_type must be one of {GATE_TYPES}')
        if self.gate_subtype not in GATE_SUBTYPES:
            raise ValueError(f'gate_subtype must be one of {GATE_SUBTYPES}')
        if self.z_classify > self.z_dim:
            raise ValueError('y_dim (== z_classify) must be <= z_dim')
        if self.posterior_locs not in ('relu', 'linear'):
            raise ValueError("posterior_locs must be 'relu' or 'linear'")
        if (self.input_s2d or self.output_s2d) and self.image_size % 2:
            raise ValueError('input_s2d/output_s2d require an even '
                             'image_size')

    @property
    def z_classify(self) -> int:
        return self.y_dim

    @property
    def z_style(self) -> int:
        return self.z_dim - self.z_classify

    @property
    def mu_trainable(self) -> bool:
        return self.gate_type == 'learnable'

    @property
    def dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.compute_dtype]

    @property
    def matmul_precision(self) -> Optional[str]:
        """'highest' (full f32, no TF32) in f32 mode, as in the JAX package."""
        return 'highest' if self.compute_dtype == 'float32' else None

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.image_size, self.image_size, self.channels)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (the reference's gated_ccvae.py:462-476)."""

    n_epochs: int = 75
    batch_size: int = 256
    lr: float = 1e-4                 # constant: the reference never anneals
    adam_eps: float = 1e-7           # Keras Adam epsilon
    perc_supervision: float = 1.0
    gating_reg: float = 0.2          # L1 coeff on mu (learnable only)
    gating_init_temp: Optional[float] = None   # None -> from gate_type
    gating_temp_decay: float = 0.99
    eval_gating_temp: float = 0.3
    classifier_mc_samples: int = 100  # k in the q(y|x) marginal
    seed: int = 0
    prng_impl: str = 'threefry'
    reshuffle_each_epoch: bool = True
    deterministic_eval: bool = False
    augment_pad: int = 0
    remat: str = 'none'

    def gating_temp_for(self, model: ModelConfig) -> float:
        if self.gating_init_temp is not None:
            return self.gating_init_temp
        return 1.0 if model.gate_type == 'learnable' else 0.3


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """CelebA pipeline config (the reference's utils_data.py:83-196)."""

    data_dir: str = './data'
    image_dir: str = 'img_align_celeba'
    attr_file: str = 'list_attr_celeba.csv'
    image_size: int = 64
    n_train: int = 162770
    n_valid: int = 19867
    n_test: int = 19962
    split_file: Optional[str] = None
    use_easy_labels: bool = True
    center_crop: bool = False
    prefetch_batches: int = 4
    num_workers: int = 8
    decode_backend: str = 'auto'
    device_resize: bool = False
    augment_pad: int = 0
    cache_decoded: bool = False
    cache_dir: Optional[str] = None


def check_supported(model: ModelConfig, train: Optional[TrainConfig] = None,
                    data: Optional[DataConfig] = None) -> None:
    """Raise NotImplementedError for config values this slice of the port
    does not run yet, naming the ROADMAP item that will add each."""
    if model.compute_dtype != 'float32':
        raise NotImplementedError(
            f"compute_dtype={model.compute_dtype!r}: only 'float32' is "
            'ported (bf16: ROADMAP Queue 1 item 3)')
    if model.input_s2d or model.output_s2d:
        raise NotImplementedError(
            'input_s2d/output_s2d: ROADMAP Queue 1 item 3 (s2d regroupings)')
    if train is not None and train.remat != 'none':
        raise NotImplementedError(
            f'remat={train.remat!r}: ROADMAP Queue 1 item 6 '
            '(torch.utils.checkpoint)')
    if data is not None and data.device_resize:
        raise NotImplementedError(
            'device_resize: ROADMAP Queue 1 item 11 (ops/resize.py)')


def apply_precision(model: ModelConfig) -> None:
    """f32 mode: full-precision f32 convs and matmuls. cuDNN runs f32 convs
    in TF32 by default; this is the counterpart of the JAX package's
    precision='highest'. Process-wide (torch.backends flags)."""
    check_supported(model)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


MODEL_CONFIG_FILENAME = 'model_config.json'


def save_model_config(cfg: ModelConfig, run_dir: str) -> str:
    """Write ``run_dir/model_config.json`` in the JAX package's format."""
    import json
    import os
    path = os.path.join(run_dir, MODEL_CONFIG_FILENAME)
    with open(path, 'w') as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, sort_keys=True)
    return path


def load_model_config(run_dir: str) -> Optional[ModelConfig]:
    """ModelConfig recorded in `run_dir`, or None if absent."""
    import json
    import os
    path = os.path.join(run_dir, MODEL_CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    for k in ('enc_features', 'dec_features'):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return ModelConfig(**d)


def default_celeba64(gate_type: str = 'learnable',
                     gate_subtype: str = 'inferred',
                     sup: float = 1.0,
                     **overrides) -> tuple[ModelConfig, TrainConfig]:
    """The reference's headline CelebA-64 configuration."""
    model = ModelConfig(gate_type=gate_type, gate_subtype=gate_subtype)
    train = TrainConfig(perc_supervision=sup, **overrides)
    return model, train


def celeba128(gate_type: str = 'learnable', sup: float = 1.0,
              gate_subtype: str = 'inferred',
              **overrides) -> tuple[ModelConfig, TrainConfig]:
    """128x128, all 40 attributes, widened latent; one extra stride-2 stage
    keeps the final valid 4x4 conv at 1x1."""
    model = ModelConfig(
        image_size=128,
        z_dim=100,
        y_dim=40,
        enc_features=(32, 32, 64, 128, 256),
        enc_hidden=512,
        dec_features=(256, 128, 64, 32, 32),
        dec_hidden=256,
        gate_type=gate_type,
        gate_subtype=gate_subtype,
    )
    train = TrainConfig(perc_supervision=sup, **overrides)
    return model, train
