"""The fixed/one-one basin against the initial draw, on the CPU.

    python -m tests.torch_init_report --workdir /tmp/init --seeds 0 1 2 3 4

For each training seed the port's CLI trains fixed/one-one sup=1.0 on the
2,100-image parity corpus (the head-to-head cell: 12 epochs, bs 64,
--parity, PIL decode) twice: from the port's own initial parameters
(``train/state.py::init_model``) and from gltvae's initial parameters for
that seed (``create_train_state``'s draw, through the bridge). Everything
else (data order, noise, eval draws) is the port's in both runs. It
prints each initial tensor's std and kurtosis from both draws at the
first seed, one line a seed with both test accuracies, then both means;
with ``--json`` it writes them there too. A run takes ~20-40 s on 8 CPU
cores.
"""

import tests.conftest  # noqa: F401  (JAX on the CPU, as the suite runs it)

import argparse
import contextlib
import io
import json
import logging
import os
import shutil

import jax
import numpy as np

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state, make_key

from gltvae_torch import cli
from gltvae_torch.bridge import params_to_state_dict
from gltvae_torch.parity_corpus import generate_corpus
from gltvae_torch.parity_head2head import splits
from gltvae_torch.train.loop import Trainer


def gltvae_init(seed, y_dim=18):
    """gltvae's initial fixed/one-one parameters for `seed` as a port
    state_dict."""
    model_cfg = jcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one')
    state = create_train_state(JCCVAE(model_cfg), jcfg.TrainConfig(seed=seed),
                               make_key(seed),
                               mu_init=np.eye(y_dim, dtype=np.float32))
    return params_to_state_dict(jax.tree.map(np.asarray, state.params))


def print_laws(seed):
    """Each initial tensor's std and kurtosis from both draws at `seed`
    (a uniform has kurtosis 1.8, a normal 3)."""
    import gltvae_torch.config as tcfg
    from gltvae_torch.train.state import init_model
    theirs = gltvae_init(seed)
    ours = init_model(tcfg.ModelConfig(gate_type='fixed',
                                       gate_subtype='one-one'),
                      tcfg.TrainConfig(seed=seed)).state_dict()
    for name, t in ours.items():
        row = []
        for x in (t, theirs[name]):
            x = x.double().flatten() - x.double().mean()
            var = float((x ** 2).mean())
            row += [var ** 0.5, float((x ** 4).mean()) / var ** 2 if var
                    else float('nan')]
        print(f'{name}: std {row[0]:.5f} port, {row[2]:.5f} gltvae; '
              f'kurtosis {row[1]:.3f} port, {row[3]:.3f} gltvae')


def run(data_dir, out_dir, seed, epochs, n, state_dict=None):
    """The cell's test accuracy, trained from the port's init or from
    `state_dict`."""
    n_tr, n_va, n_te = splits(n)
    # a run folder from an earlier call would lend its best checkpoint to
    # this run's test
    shutil.rmtree(out_dir, ignore_errors=True)
    init = Trainer.__init__

    def from_state_dict(self, *a, **kw):
        init(self, *a, **kw)
        if state_dict is not None:
            self.load_params(state_dict)
    Trainer.__init__ = from_state_dict
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            acc = cli.main([
                '--do-train', '--epochs', str(epochs), '-bs', '64',
                '--data-dir', data_dir, '--output-dir', out_dir,
                '--gate-type', 'fixed', '--gate-subtype', 'one-one',
                '--sup', '1.0', '--n-train', str(n_tr), '--n-valid',
                str(n_va), '--n-test', str(n_te), '--seed', str(seed),
                '--parity', '--decode-backend', 'pil',
                '--steps-per-dispatch', '8', '--device', 'cpu'])
    finally:
        Trainer.__init__ = init
    return float(acc[1.0])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[0, 1, 2, 3, 4])
    p.add_argument('--epochs', type=int, default=12)
    p.add_argument('--n', type=int, default=2100)
    p.add_argument('--json', default=None)
    args = p.parse_args(argv)
    logging.getLogger('gltvae_torch').setLevel(logging.WARNING)
    data_dir = os.path.join(args.workdir, 'data')
    if not os.path.exists(os.path.join(data_dir, 'list_attr_celeba.csv')):
        generate_corpus(data_dir, n=args.n, seed=0)
    print_laws(args.seeds[0])
    out = {}
    for seed in args.seeds:
        own = run(data_dir, os.path.join(args.workdir, f'own_s{seed}'),
                  seed, args.epochs, args.n)
        glt = run(data_dir, os.path.join(args.workdir, f'gltvae_s{seed}'),
                  seed, args.epochs, args.n, gltvae_init(seed))
        out[seed] = {'port_init': own, 'gltvae_init': glt}
        print(f'seed {seed}: port init {own:.4f}, gltvae init {glt:.4f}',
              flush=True)
    for key in ('port_init', 'gltvae_init'):
        vals = [r[key] for r in out.values()]
        print(f'{key}: mean {np.mean(vals):.4f}, sd {np.std(vals):.4f}, '
              f'{sum(v >= 0.68 for v in vals)} of {len(vals)} at or above '
              f'0.68 (the high basin)')
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == '__main__':
    main()
