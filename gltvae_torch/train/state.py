"""Train state and the Keras-semantics Adam (counterpart of
gltvae/train/state.py).

``TrainState`` carries everything a resume needs: the step counter, the
model (its parameters), the Adam moments and count, and the seed. The
per-step noise comes from a generator seeded by (seed, step), so a resumed
run replays the same draws.

Keras Adam puts ε on the UNCORRECTED √v:
    p -= lr·√(1-β₂ᵗ)/(1-β₁ᵗ) · m/(√v + ε)
``torch.optim.Adam`` puts it on the bias-corrected v̂, so it is not used.
For the fixed gate schemes μ is frozen: it gets no moments and no update.
Updates are made in place on the model's parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gltvae_torch.config import TrainConfig
from gltvae_torch.models.ccvae import CCVAE

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step) (splitmix64 finalizer), so
    neighbouring steps and seeds get unrelated streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


@dataclasses.dataclass
class TrainState:
    step: int
    model: CCVAE
    adam_m: Dict[str, torch.Tensor]
    adam_v: Dict[str, torch.Tensor]
    adam_count: int
    seed: int

    @property
    def device(self) -> torch.device:
        return self.model.mu.device

    def trainable(self) -> Dict[str, torch.nn.Parameter]:
        """The parameters Adam updates (μ only for learnable gating)."""
        return {n: p for n, p in self.model.named_parameters()
                if n in self.adam_m}

    def next_generator(self) -> torch.Generator:
        """This step's generator, on the state's device, seeded by
        (seed, step)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, self.step))
        return gen

    def state_dict(self) -> dict:
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
        return {'step': self.step, 'seed': self.seed,
                'adam_count': self.adam_count,
                'params': cpu(self.model.state_dict()),
                'adam_m': cpu(self.adam_m), 'adam_v': cpu(self.adam_v)}

    def load_state_dict(self, sd: dict) -> None:
        dev = self.device
        self.step = int(sd['step'])
        self.seed = int(sd['seed'])
        self.adam_count = int(sd['adam_count'])
        self.model.load_state_dict(sd['params'])
        for k in self.adam_m:
            self.adam_m[k].copy_(sd['adam_m'][k].to(dev))
            self.adam_v[k].copy_(sd['adam_v'][k].to(dev))


def create_train_state(model: CCVAE, train_cfg: TrainConfig) -> TrainState:
    """Fresh Adam state for `model` (zero moments, count 0, step 0)."""
    frozen = () if model.cfg.mu_trainable else ('mu',)
    names = [n for n, _ in model.named_parameters() if n not in frozen]
    params = dict(model.named_parameters())
    return TrainState(
        step=0, model=model,
        adam_m={n: torch.zeros_like(params[n]) for n in names},
        adam_v={n: torch.zeros_like(params[n]) for n in names},
        adam_count=0, seed=train_cfg.seed)


def keras_alpha(count: int, lr: float, b1: float = 0.9,
                b2: float = 0.999) -> float:
    """lr·√(1-β₂ᵗ)/(1-β₁ᵗ), computed in float32 as the JAX package does."""
    f = np.float32
    t = f(count)
    return float(f(lr) * np.sqrt(f(1.0) - f(b2) ** t) / (f(1.0) - f(b1) ** t))


@torch.no_grad()
def keras_adam_update(state: TrainState, grads: Dict[str, torch.Tensor],
                      lr: float, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-7) -> None:
    """One Keras Adam step on the trainable parameters, in place. `grads`
    maps parameter names to gradients; names Adam does not track (a frozen
    μ) are ignored."""
    state.adam_count += 1
    alpha = keras_alpha(state.adam_count, lr, b1, b2)
    params = state.trainable()
    for n, p in params.items():
        g = grads[n]
        m = b1 * state.adam_m[n] + (1.0 - b1) * g
        v = b2 * state.adam_v[n] + (1.0 - b2) * g * g
        state.adam_m[n].copy_(m)
        state.adam_v[n].copy_(v)
        p.add_(-alpha * m / (torch.sqrt(v) + eps))


def init_model(model_cfg, train_cfg: TrainConfig,
               mu_init: Optional[np.ndarray] = None,
               device: Optional[torch.device] = None) -> CCVAE:
    """A CCVAE initialized from train_cfg.seed (on the CPU, so every device
    starts from the same weights) and moved to `device`."""
    gen = torch.Generator().manual_seed(train_cfg.seed)
    model = CCVAE(model_cfg, mu_init=mu_init, generator=gen)
    return model.to(device) if device is not None else model
