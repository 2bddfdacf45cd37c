"""The largest port-vs-gltvae differences the parity tests see, on the CPU.

    python -m tests.torch_parity_report

tests/test_torch_*.py assert tolerances; this prints what each comparison
actually shows, on the same inputs, params and noise as those tests, so
that the record states observed numbers and not only limits.
"""

import tests.conftest  # noqa: F401  (JAX on the CPU, as the suite runs it)

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE, Temps as JTemps
from gltvae.ops.pallas.preprocess import (fused_augment_given as j_aug,
                                          fused_augment_stacked_given
                                          as j_aug_stacked,
                                          normalize_images)
from gltvae.train.steps import _as_f32_image
from tests.test_torch_augment import CASES, _case, _draws, augmented_steps
from tests.test_torch_ccvae import B, K, _jax_loss_and_grad, _setup
from tests.test_torch_config_bridge import (SCHEMES, jax_params, scheme_mu,
                                            torch_model)
from tests.test_torch_steps import three_steps
from tests.tf_twin import reconstruct_noise

import gltvae_torch.config as tcfg
from gltvae_torch.bridge import state_dict_to_params
from gltvae_torch.models.ccvae import Temps
from gltvae_torch.ops.preprocess import (dequant, fused_augment_given,
                                         fused_augment_stacked_given)

torch.set_num_threads(2)


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def tree_rel(got, want):
    """max over leaves of max|got - want| / max|want| (the tests' atol
    form)."""
    return max(max_abs(g, w) / max(float(np.abs(np.asarray(w)).max()), 1e-30)
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def dequant_rows():
    r = np.random.RandomState(0)
    out = []
    for shape in ((8, 64, 64, 3), (3, 5, 7, 3)):
        u8 = r.randint(0, 256, shape, dtype=np.uint8)
        t = torch.from_numpy(u8)
        out.append((f'dequant div vs _as_f32_image {shape}', max_abs(
            dequant(t, 'div'), _as_f32_image(jnp.asarray(u8)))))
        out.append((f'dequant mul vs normalize_images {shape}', max_abs(
            dequant(t, 'mul'), normalize_images(jnp.asarray(u8),
                                                interpret=True))))
    return out


def augment_rows():
    """Plain augment vs gltvae's Pallas kernel (interpret), same draws."""
    out = []
    for label in CASES:
        u8, draws, S = _case(label)
        got = fused_augment_given(*map(torch.from_numpy, (u8, *draws)), S)
        want = j_aug(*map(jnp.asarray, (u8, *draws)), S, interpret=True)
        out.append((f'augment vs fused_augment_given, {label}',
                    max_abs(got, want)))
    r = np.random.RandomState(1)
    u8 = r.randint(0, 256, (3, 4, 20, 20, 3), dtype=np.uint8)
    draws = _draws(r, (3, 4), 20, 20, 16)
    got = fused_augment_stacked_given(*map(torch.from_numpy, (u8, *draws)),
                                      16)
    want = j_aug_stacked(*map(jnp.asarray, (u8, *draws)), 16, interpret=True)
    out.append(('augment stacked vs fused_augment_stacked_given (3,4,20,20,3)',
                max_abs(got, want)))
    return out


def network_rows():
    out = []
    for locs in ('relu', 'linear'):
        jm = jcfg.ModelConfig(posterior_locs=locs)
        params = jax_params(jm, scheme_mu(jm), seed=1)
        jmodel = JCCVAE(jm)
        tmodel = torch_model(tcfg.ModelConfig(posterior_locs=locs), params)
        x = np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32)
        z = np.random.RandomState(1).randn(4, 45).astype(np.float32)
        jl, js = jax.jit(jmodel.encode)(params, jnp.asarray(x))
        with torch.no_grad():
            tl, ts = tmodel.encode(torch.from_numpy(x))
            td = tmodel.decode(torch.from_numpy(z))
        out.append((f'encoder locs ({locs}), 64 px', max_abs(tl, jl)))
        out.append((f'encoder scale ({locs}), 64 px', max_abs(ts, js)))
        if locs == 'relu':
            jd = jax.jit(jmodel.decode)(params, jnp.asarray(z))
            out.append(('decoder, 64 px', max_abs(td, jd)))
    return out


def loss_rows():
    out = []
    for scheme in SCHEMES:
        for kind in ('sup', 'unsup'):
            jmodel, tmodel, params, x, y, temp, reg = _setup(scheme)
            key = jax.random.key(11)
            noise = reconstruct_noise(key, kind == 'sup', B, K, z_dim=8,
                                      y_dim=4)
            (jl, jaux), jg = _jax_loss_and_grad(jmodel, kind, reg)(
                params, jnp.asarray(x), jnp.asarray(y), key,
                JTemps(gating=jnp.float32(temp)))
            tnoise = {k: torch.tensor(v) for k, v in noise.items()}
            if kind == 'sup':
                tl, taux = tmodel.sup_loss(
                    torch.from_numpy(x), torch.from_numpy(y), Temps(temp),
                    gating_reg=reg, k=K, noise=tnoise)
            else:
                tl, taux = tmodel.unsup_loss(torch.from_numpy(x),
                                             Temps(temp), gating_reg=reg,
                                             noise=tnoise)
            names = [n for n, _ in tmodel.named_parameters()]
            grads = state_dict_to_params(dict(zip(names, torch.autograd.grad(
                tl, list(tmodel.parameters())))))
            aux = max(max_abs(getattr(taux, f).detach(), getattr(jaux, f))
                      / max(float(np.abs(np.asarray(getattr(jaux, f))).max()),
                            1e-30) for f in jaux._fields)
            tag = f'{"/".join(scheme)} {kind}, k={K}'
            out.append((f'{tag}: loss rel', abs(tl.item() - float(jl))
                        / abs(float(jl))))
            out.append((f'{tag}: LossAux fields, max rel', aux))
            out.append((f'{tag}: gradients incl. mu, max abs / leaf max',
                        tree_rel(grads, jax.tree.map(np.asarray, jg))))
    return out


def step_rows():
    out = []
    # lazily: the port's state is updated in place from step to step
    runs = itertools.chain(
        ((f'step {i + 1} ({"sup" if i != 1 else "unsup"})', r)
         for i, r in enumerate(three_steps())),
        ((f'augmented step {i + 1} ({"sup" if i == 0 else "unsup"})', r[:4])
         for i, r in enumerate(augmented_steps())))
    for tag, (tmet, jmet, state, jstate) in runs:
        out.append((f'{tag}: params max abs', max(
            max_abs(g, w) for g, w in zip(
                jax.tree.leaves(state_dict_to_params(
                    state.model.state_dict())),
                jax.tree.leaves(jstate.params)))))
        out.append((f'{tag}: Adam m, max abs / leaf max', tree_rel(
            state_dict_to_params(state.adam_m), jstate.opt_state.mu)))
        out.append((f'{tag}: Adam v, max abs / leaf max', tree_rel(
            state_dict_to_params(state.adam_v), jstate.opt_state.nu)))
        out.append((f'{tag}: metrics max rel', max(
            max_abs(tmet[k], jmet[k])
            / max(abs(float(np.asarray(jmet[k]))), 1e-30) for k in jmet)))
    return out


def main():
    for label, value in (dequant_rows() + augment_rows() + network_rows()
                         + loss_rows() + step_rows()):
        print(f'{label}: {value:.3e}', flush=True)


if __name__ == '__main__':
    main()
