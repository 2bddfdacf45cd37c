"""Full reference-protocol reproduction on real CelebA with the port
(counterpart of tools/repro_reference.py).

Runs the reference's complete experiment matrix (Final_Report Table 1 /
BASELINE.md): {fixed one-one, fixed inferred, learnable} x sup {1.0, 0.5,
0.2}, 75 epochs, bs 256, each cell through ``gltvae_torch.cli.main`` with
the JAX tool's arguments, and prints a Table-1-comparable accuracy
matrix. Requires the CelebA dataset (list_attr_celeba.csv +
img_align_celeba/) under --data-dir.

    python -m gltvae_torch.repro_reference --data-dir /data/celeba \\
        [--epochs 75] [--parity] [--dtype float32] [--device cpu]
    torchrun --nproc-per-node=N -m gltvae_torch.repro_reference \\
        --data-dir /data/celeba --mesh      # data-parallel over N cards

--parity: reference-exact quirks (shuffle-once loader, stochastic eval);
without it every cell evaluates with --deterministic-eval.
"""

from __future__ import annotations

import argparse
import json

BASELINE_TABLE1 = {  # Final_Report.pdf Table 1 (BASELINE.md)
    ('fixed', 'one-one'): {1.0: 0.814, 0.5: 0.748, 0.2: 0.680},
    ('fixed', 'inferred'): {1.0: 0.762, 0.5: 0.746, 0.2: 0.659},
    ('learnable', 'inferred'): {1.0: 0.755, 0.5: 0.740, 0.2: 0.728},
}

SUPS = (1.0, 0.5, 0.2)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data-dir', required=True)
    p.add_argument('--epochs', type=int, default=75)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--mesh', action='store_true')
    p.add_argument('--parity', action='store_true',
                   help='reference-exact quirks: shuffle-once loader, '
                        'stochastic eval')
    p.add_argument('--output-dir', default='./models')
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; the rank's card with --mesh) or "
                        "'cpu'")
    return p.parse_args(argv)


def cell_argvs(args):
    """[(gate_type, gate_subtype, sup, cli argv)] of the 9 cells in the JAX
    tool's order, each argv its train.py arguments (plus ``--device`` when
    it is not the default)."""
    cells = []
    for gate_type, gate_subtype in BASELINE_TABLE1:
        for sup in SUPS:
            argv = ['--do-train', '--epochs', str(args.epochs),
                    '-bs', str(args.batch_size),
                    '--data-dir', args.data_dir,
                    '--output-dir', args.output_dir,
                    '--gate-type', gate_type,
                    '--gate-subtype', gate_subtype,
                    '--compute-dtype', args.dtype,
                    '--sup', str(sup)]
            if args.mesh:
                argv.append('--mesh')
            if args.parity:
                argv.append('--parity')
            else:
                argv.append('--deterministic-eval')
            if args.device != 'cuda':
                argv += ['--device', args.device]
            cells.append((gate_type, gate_subtype, sup, argv))
    return cells


def cell_key(gate_type, gate_subtype, sup):
    return f'{gate_type}/{gate_subtype}/sup={sup}'


def run_matrix(args, extra=()):
    """Each cell through ``cli.main(argv + extra)`` (`extra`: e.g. a mini
    corpus's split file), printing the JSON so far after each, as the JAX
    tool. Returns {cell key: {test_accuracy, reference}}."""
    from gltvae_torch import cli
    results = {}
    for gate_type, gate_subtype, sup, argv in cell_argvs(args):
        key = cell_key(gate_type, gate_subtype, sup)
        acc = cli.main(argv + list(extra))[sup]
        results[key] = {
            'test_accuracy': acc,
            'reference': BASELINE_TABLE1[(gate_type, gate_subtype)][sup],
        }
        print(json.dumps(results, indent=2))
    return results


def main(argv=None):
    args = parse_args(argv)
    results = run_matrix(args)
    print('\n=== Final comparison vs Final_Report Table 1 ===')
    print(json.dumps(results, indent=2))
    return results


if __name__ == '__main__':
    main()
