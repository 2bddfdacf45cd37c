"""The fixed/one-one basin against the initial draw, on the CPU.

    python -m tests.torch_init_report --workdir /tmp/init --seeds 0 1 2 3 4

For each training seed the port's CLI trains fixed/one-one sup=1.0 on the
2,100-image parity corpus (the head-to-head cell: 12 epochs, bs 64,
--parity, PIL decode) twice: from the port's own initial parameters
(``train/state.py::init_model``) and from gltvae's initial parameters for
that seed (``create_train_state``'s draw, through the bridge). Everything
else (data order, noise, eval draws) is the port's in both runs. For every
seed it prints each initial tensor's std and kurtosis from both draws and
their two-sample KS statistic, then one line with both test accuracies and
one with the dead ``z_classify`` dims of each run's best checkpoint on the
train split and its stuck labels (test accuracy within 0.01 of the
label's majority rate); at the end both means. With ``--json`` it writes
them there too (each run's per-label test accuracy included). A run takes
~20-40 s on 8 CPU cores.

Other modes, each on the same corpus:

- ``--legs port`` (or ``gltvae``) trains one of the two legs only.
- ``--swap encoder|decoder|classifier`` trains from the port's init with
  that group of tensors taken from gltvae's draw instead (``classifier``
  is the classifier with the conditional prior), one run a seed.
- ``--census N`` draws both inits for seeds 0..N-1 without training, runs
  each encoder over the corpus's 1,500 train images and records, per seed
  and draw, the dead ``z_classify`` dims (the last 18 locs dims, 0 on
  every image), the share of positive ``z_classify`` locs and their mean;
  then a two-sample KS test of each statistic over the seeds, and of each
  parameter tensor's values pooled over seeds 0-9.
- ``--gltvae-runs DIR`` reads the best checkpoints that
  ``tools/seed_panel.py --workdir DIR --locs relu`` left for ``--seeds``
  (gltvae's own loader, then the bridge) and records the same dead dims,
  per-label test accuracy and stuck labels.
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
import torch
from scipy import stats

import gltvae.config as jcfg
from gltvae.models.ccvae import CCVAE as JCCVAE
from gltvae.train.state import create_train_state, make_key

import gltvae_torch.config as tcfg
from gltvae_torch import cli
from gltvae_torch.bridge import params_to_state_dict
from gltvae_torch.models.ccvae import CCVAE, Temps
from gltvae_torch.parity_corpus import generate_corpus
from gltvae_torch.parity_head2head import splits
from gltvae_torch.train.checkpoint import CheckpointManager
from gltvae_torch.train.loop import Trainer
from gltvae_torch.train.state import init_model

RUN_NAME = 'params_1.0_fixed_one-one'
# the census pools each tensor's values over seeds 0..KS_SEEDS-1
KS_SEEDS = 10
# the tensors each --swap group takes from gltvae's draw
SWAP_GROUPS = {'encoder': ('encoder.',), 'decoder': ('decoder.',),
               'classifier': ('classifier.', 'cond_prior.')}


def cell_config():
    return tcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one')


def gltvae_init(seed, y_dim=18):
    """gltvae's initial fixed/one-one parameters for `seed` as a port
    state_dict."""
    model_cfg = jcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one')
    state = create_train_state(JCCVAE(model_cfg), jcfg.TrainConfig(seed=seed),
                               make_key(seed),
                               mu_init=np.eye(y_dim, dtype=np.float32))
    return params_to_state_dict(jax.tree.map(np.asarray, state.params))


def port_init(seed):
    """The port's initial fixed/one-one parameters for `seed`."""
    return init_model(cell_config(), tcfg.TrainConfig(seed=seed)).state_dict()


def swapped_init(seed, group):
    """The port's init for `seed` with `group`'s tensors from gltvae's."""
    ours, theirs = port_init(seed), gltvae_init(seed)
    return {k: theirs[k] if k.startswith(SWAP_GROUPS[group]) else v
            for k, v in ours.items()}


def tensor_ks(a, b):
    """Two-sample KS (statistic, p) of two tensors' values; (0, 1) when
    both are one constant (KS is undefined on ties alone)."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    if a.min() == a.max() == b.min() == b.max():
        return 0.0, 1.0
    r = stats.ks_2samp(a, b)
    return float(r.statistic), float(r.pvalue)


def print_laws(seed):
    """Each initial tensor's std and kurtosis from both draws at `seed` (a
    uniform has kurtosis 1.8, a normal 3), then their two-sample KS."""
    ours, theirs = port_init(seed), gltvae_init(seed)
    print(f'laws at seed {seed}:')
    for name, t in ours.items():
        row = []
        for x in (t, theirs[name]):
            x = x.double().flatten() - x.double().mean()
            var = float((x ** 2).mean())
            row += [var ** 0.5, float((x ** 4).mean()) / var ** 2 if var
                    else float('nan')]
        print(f'{name}: std {row[0]:.5f} port, {row[2]:.5f} gltvae; '
              f'kurtosis {row[1]:.3f} port, {row[3]:.3f} gltvae')
        d, p = tensor_ks(t, theirs[name])
        print(f'{name}: KS D {d:.5f}, p {p:.4g}')


def cell_argv(data_dir, out_dir, seed, epochs, n):
    """The port CLI's argv for the cell (the head-to-head's)."""
    n_tr, n_va, n_te = splits(n)
    return ['--do-train', '--epochs', str(epochs), '-bs', '64',
            '--data-dir', data_dir, '--output-dir', out_dir,
            '--gate-type', 'fixed', '--gate-subtype', 'one-one',
            '--sup', '1.0', '--n-train', str(n_tr), '--n-valid', str(n_va),
            '--n-test', str(n_te), '--seed', str(seed),
            '--parity', '--decode-backend', 'pil',
            '--steps-per-dispatch', '8', '--device', 'cpu']


def split_arrays(data_dir, n):
    """{'sup', 'test'}: (uint8 images, labels) of the corpus's train and test
    splits, decoded as the cell's CLI decodes them."""
    args = cli.parse_args(cell_argv(data_dir, data_dir, 0, 1, n))
    model_cfg, train_cfg = cli.build_configs(args, 1.0)
    loaders, _ = cli.make_loaders(args, model_cfg, train_cfg)
    out = {}
    for k in ('sup', 'test'):
        ds = loaders[k].dataset
        out[k] = ds.fetch(np.arange(len(ds)))
    return out


def as_images(u8):
    return torch.from_numpy(np.ascontiguousarray(u8)).to(torch.float32) \
        * (1.0 / 255.0)


@torch.no_grad()
def encoder_locs(encoder, u8, bs=500):
    """The encoder's locs (N, z_dim) over uint8 images."""
    return torch.cat([encoder(as_images(u8[i:i + bs]))[0]
                      for i in range(0, len(u8), bs)])


def locs_census(locs, z_classify=18):
    """dead: the z_classify dims (the last ones) that are 0 on every image;
    active: the share of positive z_classify locs; mean: their mean."""
    zc = locs[:, -z_classify:]
    return {'dead': int((zc == 0).all(0).sum()),
            'active': float((zc > 0).to(torch.float64).mean()),
            'mean': float(zc.to(torch.float64).mean())}


@torch.no_grad()
def label_accuracy(model, u8, labels, bs=500):
    """Per-label test accuracy of the posterior-mean prediction (z = locs,
    expected gates)."""
    hits = []
    for i in range(0, len(u8), bs):
        y_hat = model.predict_labels(as_images(u8[i:i + bs]), Temps(0.3),
                                     deterministic=True)
        hits.append(y_hat == torch.from_numpy(
            np.asarray(labels[i:i + bs], np.float32)))
    return torch.cat(hits).to(torch.float64).mean(0).tolist()


def describe(state_dict, arrays):
    """Dead z_classify dims on the train split, per-label test accuracy of
    a trained fixed/one-one model, and its stuck labels: those whose
    accuracy is within 0.01 of the test split's majority rate."""
    model = CCVAE(cell_config())
    model.load_state_dict(state_dict)
    model.eval()
    out = locs_census(encoder_locs(model.encoder, arrays['sup'][0]))
    acc = label_accuracy(model, *arrays['test'])
    y = np.asarray(arrays['test'][1], np.float64).mean(0)
    out['label_accuracy'] = acc
    majority = np.maximum(y, 1 - y)
    out['stuck'] = int((np.asarray(acc) <= majority + 0.01).sum())
    return out


def run(data_dir, out_dir, seed, epochs, n, state_dict=None):
    """The cell's test accuracy, trained from the port's init or from
    `state_dict`."""
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
            acc = cli.main(cell_argv(data_dir, out_dir, seed, epochs, n))
    finally:
        Trainer.__init__ = init
    return float(acc[1.0])


def best_params(out_dir):
    """The best checkpoint's parameters of a port run folder."""
    return CheckpointManager(os.path.join(out_dir, RUN_NAME,
                                          'checkpoints')).load()['params']


def gltvae_best_params(run_dir):
    """The best checkpoint of a gltvae run folder, read by gltvae's own
    checkpoint manager, as a port state_dict."""
    from gltvae.train.checkpoint import CheckpointManager as JManager
    model_cfg = jcfg.ModelConfig(gate_type='fixed', gate_subtype='one-one')
    template = create_train_state(JCCVAE(model_cfg), jcfg.TrainConfig(),
                                  make_key(0))
    mgr = JManager(os.path.join(run_dir, RUN_NAME, 'orbax'))
    try:
        state = mgr.restore(template)
    finally:
        mgr.close()
    return params_to_state_dict(jax.tree.map(np.asarray, state.params))


def census(data_dir, n, n_seeds):
    """The init census over seeds 0..n_seeds-1 (no training)."""
    u8 = split_arrays(data_dir, n)['sup'][0]
    draws = {'port': port_init, 'gltvae': gltvae_init}
    per_seed = {k: {s: [] for s in ('dead', 'active', 'mean')}
                for k in draws}
    model = CCVAE(cell_config())
    pooled = {k: {} for k in draws}
    for seed in range(n_seeds):
        for key, draw in draws.items():
            sd = draw(seed)
            model.load_state_dict(sd)
            for stat, v in locs_census(encoder_locs(model.encoder,
                                                    u8)).items():
                per_seed[key][stat].append(v)
            if seed < KS_SEEDS:
                for name, t in sd.items():
                    pooled[key].setdefault(name, []).append(t.numpy().ravel())
        if seed % 100 == 99:
            print(f'census: {seed + 1} seeds', flush=True)
    out = {'seeds': n_seeds, 'images': int(len(u8)), 'per_seed': per_seed,
           'statistics': {}, 'tensors': {},
           'ks_seeds': min(KS_SEEDS, n_seeds),
           'statistic_threshold': 0.01 / 3}
    for stat in ('dead', 'active', 'mean'):
        a, b = (np.asarray(per_seed[k][stat]) for k in draws)
        r = stats.ks_2samp(a, b)
        out['statistics'][stat] = {
            'port_mean': float(a.mean()), 'port_sd': float(a.std(ddof=1)),
            'gltvae_mean': float(b.mean()), 'gltvae_sd': float(b.std(ddof=1)),
            'ks_d': float(r.statistic), 'ks_p': float(r.pvalue)}
        print(f'{stat}: port {a.mean():.5f} ± {a.std(ddof=1):.5f}, gltvae '
              f'{b.mean():.5f} ± {b.std(ddof=1):.5f}; KS D '
              f'{r.statistic:.5f}, p {r.pvalue:.4g}', flush=True)
    names = list(pooled['port'])
    out['tensor_threshold'] = 0.001 / len(names)
    for name in names:
        a, b = (np.concatenate(pooled[k][name]) for k in draws)
        d, p = tensor_ks(a, b)
        out['tensors'][name] = {
            'n': int(a.size), 'port_std': float(a.std()),
            'gltvae_std': float(b.std()), 'port_absmax': float(abs(a).max()),
            'gltvae_absmax': float(abs(b).max()), 'ks_d': d, 'ks_p': p}
        print(f'{name}: pooled over seeds 0-{out["ks_seeds"] - 1}, KS D '
              f'{d:.6f}, p {p:.4g}', flush=True)
    out['r2_holds'] = bool(
        all(v['ks_p'] >= out['statistic_threshold']
            for v in out['statistics'].values())
        and all(v['ks_p'] >= out['tensor_threshold']
                for v in out['tensors'].values()))
    print(f'R2 holds: {out["r2_holds"]}')
    return out


def gltvae_death_census(runs_dir, seeds, data_dir, n):
    """Dead dims and per-label test accuracy of gltvae's best checkpoints
    in a seed-panel workdir, with each run's recorded test accuracy."""
    arrays = split_arrays(data_dir, n)
    with open(os.path.join(runs_dir, 'seed_panel.json')) as f:
        panel = json.load(f)
    out = {}
    for seed in seeds:
        r = describe(gltvae_best_params(
            os.path.join(runs_dir, f'models_relu_s{seed}')), arrays)
        r['test_accuracy'] = panel[f'locs=relu/seed={seed}']['test_accuracy']
        out[seed] = r
        print(f'gltvae seed {seed}: test acc {r["test_accuracy"]:.4f}, dead '
              f'z_classify dims {r["dead"]}, stuck labels {r["stuck"]}',
              flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[0, 1, 2, 3, 4])
    p.add_argument('--epochs', type=int, default=12)
    p.add_argument('--n', type=int, default=2100)
    p.add_argument('--json', default=None)
    p.add_argument('--legs', nargs='*', default=['port', 'gltvae'],
                   choices=['port', 'gltvae'])
    p.add_argument('--swap', default=None, choices=sorted(SWAP_GROUPS))
    p.add_argument('--census', type=int, default=None, metavar='N')
    p.add_argument('--gltvae-runs', default=None, metavar='DIR')
    args = p.parse_args(argv)
    logging.getLogger('gltvae_torch').setLevel(logging.WARNING)
    data_dir = os.path.join(args.workdir, 'data')
    if not os.path.exists(os.path.join(data_dir, 'list_attr_celeba.csv')):
        generate_corpus(data_dir, n=args.n, seed=0)
    if args.census is not None:
        out = census(data_dir, args.n, args.census)
    elif args.gltvae_runs is not None:
        out = gltvae_death_census(args.gltvae_runs, args.seeds, data_dir,
                                  args.n)
    else:
        out = train_runs(args, data_dir)
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2)
    return out


def train_runs(args, data_dir):
    """The training legs (or the swap runs) for each seed."""
    arrays = split_arrays(data_dir, args.n)
    if args.swap:
        legs = {f'swap_{args.swap}': (
            f'swap_{args.swap}', lambda s: swapped_init(s, args.swap))}
    else:
        legs = {'port_init': ('own', None), 'gltvae_init': ('gltvae',
                                                            gltvae_init)}
        legs = {k: v for k, v in legs.items()
                if k.split('_')[0] in args.legs}
    out = {}
    for seed in args.seeds:
        print_laws(seed)
        row = {}
        for key, (folder, draw) in legs.items():
            out_dir = os.path.join(args.workdir, f'{folder}_s{seed}')
            row[key] = run(data_dir, out_dir, seed, args.epochs, args.n,
                           None if draw is None else draw(seed))
            d = describe(best_params(out_dir), arrays)
            row[f'{key}_dead'] = d['dead']
            row[f'{key}_stuck'] = d['stuck']
            row[f'{key}_label_accuracy'] = d['label_accuracy']
        out[seed] = row
        print(f'seed {seed}: ' + ', '.join(
            f'{k.replace("_", " ")} {row[k]:.4f}' for k in legs), flush=True)
        print(f'seed {seed}: dead z_classify dims (train split, best '
              'checkpoint): ' + ', '.join(
                  f'{k.replace("_", " ")} {row[k + "_dead"]}' for k in legs)
              + '; stuck labels: ' + ', '.join(
                  f'{k.replace("_", " ")} {row[k + "_stuck"]}' for k in legs),
              flush=True)
    for key in legs:
        vals = [r[key] for r in out.values()]
        print(f'{key}: mean {np.mean(vals):.4f}, sd {np.std(vals):.4f}, '
              f'{sum(v >= 0.68 for v in vals)} of {len(vals)} at or above '
              f'0.68 (the high basin)')
    return out


if __name__ == '__main__':
    main()
