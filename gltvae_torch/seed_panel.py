"""Seed-variance panel with the port (counterpart of tools/seed_panel.py):
fixed/one-one sup=1.0 across training seeds, parity ReLU locs vs
``--posterior-locs linear``.

The reference's one-one seed draw is bimodal (a ~0.57-0.62 plateau basin
vs a ~0.71-0.74 high basin; docs/HEAD2HEAD.md), traced to its ReLU'd
nonnegative posterior means. This tool trains the SAME corpus/config
across seeds in both modes and tabulates the test accuracies. Each run is
a subprocess ``python -m gltvae_torch.cli`` with the JAX tool's train.py
flags (parity loader quirks, PIL decode, n=2100 seed-0 corpus from
``gltvae_torch.parity_corpus``, 12 epochs, bs 64). Results are cached in
``<workdir>/seed_panel.json`` under the JAX tool's tags, and the markdown
table is printed at the end.

    python -m gltvae_torch.seed_panel --workdir /tmp/seed_panel \\
        --seeds 0 1 2 3 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: the folder holding the gltvae_torch package: the runs' working directory
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[0, 1, 2, 3, 4])
    p.add_argument('--locs', nargs='*', default=['relu', 'linear'])
    p.add_argument('--epochs', type=int, default=12)
    p.add_argument('--bs', type=int, default=64)
    p.add_argument('--n', type=int, default=2100)
    p.add_argument('--corpus-seed', type=int, default=0)
    p.add_argument('--gate-type', default='fixed')
    p.add_argument('--gate-subtype', default='one-one')
    p.add_argument('--sup', type=float, default=1.0)
    p.add_argument('--steps-per-dispatch', type=int, default=8)
    p.add_argument('--device', default='cuda',
                   help="device of the runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def run_command(args, data_dir, out_dir, locs, seed):
    """The subprocess command of one panel run (the JAX tool's train.py
    command, through ``python -m gltvae_torch.cli``)."""
    nv = args.n // 7
    n_tr = args.n - 2 * nv
    cmd = [sys.executable, '-m', 'gltvae_torch.cli',
           '--do-train', '--epochs', str(args.epochs),
           '-bs', str(args.bs), '--data-dir', data_dir,
           '--output-dir', out_dir,
           '--gate-type', args.gate_type,
           '--gate-subtype', args.gate_subtype,
           '--sup', str(args.sup),
           '--n-train', str(n_tr), '--n-valid', str(nv),
           '--n-test', str(nv), '--seed', str(seed),
           '--parity', '--decode-backend', 'pil',
           '--posterior-locs', locs,
           '--steps-per-dispatch', str(args.steps_per_dispatch),
           '--device', args.device]
    return cmd


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    data_dir = os.path.join(args.workdir, 'data')
    if not os.path.exists(os.path.join(data_dir, 'list_attr_celeba.csv')):
        print(f'generating corpus ({args.n} images)...', flush=True)
        from gltvae_torch.parity_corpus import generate_corpus
        generate_corpus(data_dir, n=args.n, seed=args.corpus_seed)

    results_path = os.path.join(args.workdir, 'seed_panel.json')
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    # default cell (fixed/one-one sup=1.0) keeps the round-4 tag format so
    # docs/HEAD2HEAD.md's existing panel rows stay reproducible; other
    # cells of the mode grid get a cell prefix (same corpus, same workdir)
    default_cell = (args.gate_type == 'fixed'
                    and args.gate_subtype == 'one-one' and args.sup == 1.0)
    cell = (f'{args.gate_type}-{args.gate_subtype}' if args.gate_type ==
            'fixed' else args.gate_type) + f'_sup{args.sup}'
    for locs in args.locs:
        for seed in args.seeds:
            tag = (f'locs={locs}/seed={seed}' if default_cell
                   else f'cell={cell}/locs={locs}/seed={seed}')
            if tag in results:
                print(f'{tag}: cached {results[tag]["test_accuracy"]:.4f}',
                      flush=True)
                continue
            out_dir = os.path.join(
                args.workdir,
                f'models_{locs}_s{seed}' if default_cell
                else f'models_{cell}_{locs}_s{seed}')
            cmd = run_command(args, data_dir, out_dir, locs, seed)
            print(f'=== {tag} ===', flush=True)
            subprocess.run(cmd, check=True, cwd=ROOT)
            if args.gate_type == 'learnable':
                run_name = f'params_{args.sup}_{args.gate_type}'
            else:
                run_name = (f'params_{args.sup}_{args.gate_type}_'
                            f'{args.gate_subtype}')
            with open(os.path.join(out_dir, run_name, 'result.json')) as f:
                r = json.load(f)
            results[tag] = {
                'locs': locs, 'seed': seed,
                'gate_type': args.gate_type,
                'gate_subtype': args.gate_subtype, 'sup': args.sup,
                'test_accuracy': r['test_accuracy'],
                'val_accuracy': [h['val_accuracy']
                                 for h in r.get('history', [])],
            }
            with open(results_path, 'w') as f:
                json.dump(results, f, indent=2)
            print(f'{tag}: test acc {r["test_accuracy"]:.4f}', flush=True)

    print('\n| seed | ' + ' | '.join(args.locs) + ' |')
    print('|---' * (1 + len(args.locs)) + '|')
    for seed in args.seeds:
        row = [str(seed)]
        for locs in args.locs:
            r = results.get(f'locs={locs}/seed={seed}' if default_cell
                            else f'cell={cell}/locs={locs}/seed={seed}')
            row.append('n/a' if r is None else f"{r['test_accuracy']:.3f}")
        print('| ' + ' | '.join(row) + ' |')
    return results


if __name__ == '__main__':
    main()
