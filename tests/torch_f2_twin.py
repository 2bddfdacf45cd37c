"""The training half of fault F2, seed by seed, on the CPU.

    python -m tests.torch_f2_twin --workdir /tmp/twin --seeds 6

Trains the fixed/one-one cell of ``tests/torch_init_report.py`` (the
head-to-head's: sup=1.0, 12 epochs, bs 64, --parity, PIL decode) from
gltvae's initial parameters for each seed, three ways:

- ``port``: the port's CLI with its own draws (the report's
  ``gltvae_init`` leg);
- ``twin``: the port's CLI with gltvae's draws: each train step's noise
  rebuilt from gltvae's per-step key (``TrainState.next_rng``), each eval
  batch's from gltvae's eval key chain (``make_key(seed + 1)``, split once
  a batch, as ``make_resident_eval_step`` does);
- ``gltvae``: train.py's run of the cell, in this process.

After each validation it logs the accuracy and the dead ``z_classify``
dims on the train split, then the test accuracy; with ``--json`` it
writes them there. If the twin follows gltvae's run, the port's loader
order, interleave, step, eval and best-checkpoint choice are gltvae's, and
what is left between the two frameworks is their random draws. ~1 min a
port leg and ~5 min the gltvae leg on 8 CPU cores.
"""

from tests import torch_init_report as report

import argparse
import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import torch

import gltvae.config as jcfg
import gltvae.train.loop as jloop
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.ops.sampling import sample_gumbel
from gltvae.train.state import create_train_state, make_key, wrap_key

import gltvae_torch.train.steps as tsteps
from gltvae_torch import cli
from gltvae_torch.bridge import params_to_state_dict
from gltvae_torch.models.ccvae import CCVAE
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import TrainState
from tests.tf_twin import reconstruct_noise


class GltvaeDraws:
    """gltvae's draws for the port's run at `seed`: a train step's noise by
    its step, an eval batch's along the eval key chain."""

    def __init__(self, seed):
        cfg = jcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one')
        state = create_train_state(JCCVAE(cfg), jcfg.TrainConfig(seed=seed),
                                   make_key(seed),
                                   mu_init=np.eye(18, dtype=np.float32))
        self.rng = state.rng
        self.eval_key = make_key(seed + 1)

    def step_noise(self, step, batch, supervised, k):
        key = jax.random.fold_in(wrap_key(self.rng), step)
        return {n: torch.tensor(v) for n, v in
                reconstruct_noise(key, supervised, batch, k).items()}

    def eval_noise(self, batch):
        """predict_probs's draws: split(sub) -> (z, gates), gates split
        again into the two Gumbels."""
        self.eval_key, sub = jax.random.split(self.eval_key)
        key_z, key_gate = jax.random.split(sub)
        k1, k2 = jax.random.split(key_gate)
        draws = {'eps_z': jax.random.normal(key_z, (batch, 45),
                                            dtype=np.float32),
                 'g1': sample_gumbel(k1, (18, 18)),
                 'g2': sample_gumbel(k2, (18, 18))}
        return {n: torch.tensor(np.asarray(v)) for n, v in draws.items()}


class _Step:
    def __init__(self, step):
        self.step = step


_EVAL = object()


@contextlib.contextmanager
def gltvae_draws(draws):
    """The port's Trainer takes its train and eval noise from `draws`."""
    next_gen, draw_noise = TrainState.next_generator, tsteps.draw_noise
    draw_eval = tsteps.draw_eval_noise
    predict, init = CCVAE.predict_probs, Trainer.__init__

    def predict_probs(self, x, temps, deterministic=False, noise=None,
                      generator=None):
        if generator is _EVAL:
            noise, generator = draws.eval_noise(x.shape[0]), None
        return predict(self, x, temps, deterministic, noise, generator)

    def trainer_init(self, *a, **kw):
        init(self, *a, **kw)
        self._eval_gen = _EVAL

    TrainState.next_generator = lambda self: _Step(self.step)
    tsteps.draw_noise = lambda model, batch, supervised, k, gen, out=None: \
        draws.step_noise(gen.step, batch, supervised, k)
    # a captured eval pass draws in its host part, batch by batch
    tsteps.draw_eval_noise = lambda model, batch, gen, out=None: (
        draws.eval_noise(batch) if gen is _EVAL
        else draw_eval(model, batch, gen, out))
    CCVAE.predict_probs = predict_probs
    Trainer.__init__ = trainer_init
    try:
        yield
    finally:
        TrainState.next_generator, tsteps.draw_noise = next_gen, draw_noise
        tsteps.draw_eval_noise = draw_eval
        CCVAE.predict_probs, Trainer.__init__ = predict, init


@contextlib.contextmanager
def logged_evaluations(trainer_cls, state_dict_of, images, log):
    """Each ``trainer_cls.evaluate`` call appends (accuracy, dead z_classify
    dims of the model it evaluated, on `images`) to `log`."""
    evaluate = trainer_cls.evaluate
    model = CCVAE(report.cell_config())

    def logged(self, *a, **kw):
        acc = evaluate(self, *a, **kw)
        model.load_state_dict(state_dict_of(self))
        dead = report.locs_census(report.encoder_locs(model.encoder,
                                                      images))['dead']
        log.append({'accuracy': acc, 'dead': dead})
        return acc
    trainer_cls.evaluate = logged
    try:
        yield
    finally:
        trainer_cls.evaluate = evaluate


def port_leg(data_dir, out_dir, seed, epochs, n, images, twin):
    log = []
    draws = GltvaeDraws(seed) if twin else None
    with contextlib.ExitStack() as stack:
        if twin:
            stack.enter_context(gltvae_draws(draws))
        stack.enter_context(logged_evaluations(
            Trainer, lambda t: t.model.state_dict(), images, log))
        acc = report.run(data_dir, out_dir, seed, epochs, n,
                         report.gltvae_init(seed))
    return acc, log


def gltvae_leg(data_dir, out_dir, seed, epochs, n, images):
    n_tr, n_va, n_te = report.splits(n)
    shutil.rmtree(out_dir, ignore_errors=True)
    log = []
    argv = ['--do-train', '--epochs', str(epochs), '-bs', '64',
            '--data-dir', data_dir, '--output-dir', out_dir,
            '--gate-type', 'fixed', '--gate-subtype', 'one-one',
            '--sup', '1.0', '--n-train', str(n_tr), '--n-valid', str(n_va),
            '--n-test', str(n_te), '--seed', str(seed), '--parity',
            '--decode-backend', 'pil', '--posterior-locs', 'relu',
            '--steps-per-dispatch', '8', '--platform', 'cpu',
            '--no-compilation-cache']
    import train as jtrain
    state_dict_of = lambda t: params_to_state_dict(
        jax.tree.map(np.asarray, t.state.params))
    with logged_evaluations(jloop.Trainer, state_dict_of, images, log), \
            contextlib.redirect_stderr(io.StringIO()):
        acc = jtrain.main(argv)[1.0]
    return float(acc), log


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--epochs', type=int, default=12)
    p.add_argument('--n', type=int, default=2100)
    p.add_argument('--legs', nargs='*', default=['port', 'twin', 'gltvae'],
                   choices=['port', 'twin', 'gltvae'])
    p.add_argument('--json', default=None)
    args = p.parse_args(argv)
    data_dir = os.path.join(args.workdir, 'data')
    if not os.path.exists(os.path.join(data_dir, 'list_attr_celeba.csv')):
        report.generate_corpus(data_dir, n=args.n, seed=0)
    images = report.split_arrays(data_dir, args.n)['sup'][0]
    out = {}
    for seed in args.seeds:
        out[seed] = {}
        for leg in args.legs:
            out_dir = os.path.join(args.workdir, f'{leg}_s{seed}')
            if leg == 'gltvae':
                acc, log = gltvae_leg(data_dir, out_dir, seed, args.epochs,
                                      args.n, images)
            else:
                acc, log = port_leg(data_dir, out_dir, seed, args.epochs,
                                    args.n, images, leg == 'twin')
            out[seed][leg] = {'test_accuracy': acc, 'val': log[:-1],
                              'test': log[-1]}
            print(f'{leg} seed {seed}: test acc {acc:.4f}; val acc '
                  + ' '.join(f'{e["accuracy"]:.3f}' for e in log[:-1])
                  + '; dead z_classify dims '
                  + ' '.join(str(e['dead']) for e in log[:-1]), flush=True)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == '__main__':
    main()
