"""Head-to-head accuracy parity: the TF reference vs the port, end to end
(counterpart of tools/parity_head2head.py).

Both legs train on the IDENTICAL on-disk mini-CelebA corpus
(``gltvae_torch.parity_corpus``, the bytes of tools/parity_corpus.py —
178x218 JPEGs whose 18 easy attributes are visible in the pixels), each
through its own real data path —
- reference: the TF reference's gated_ccvae.py run() unmodified, through
  tools/reference_runner.py run by path (never imported); where the TF
  reference is absent, ``--skip-reference`` reuses its recorded
  ``ref_{tag}.json`` legs;
- port:      ``python -m gltvae_torch.cli`` with train.py's flags (the
  --parity loader quirks, PIL decode, scan dispatch) and ``--device``.
Per gate mode the val-accuracy trajectories and final test accuracy must
agree within stochastic-eval noise, as in the JAX tool.

The files and printed text are the JAX tool's, with the leg under test
named ``port`` where it says ``gltvae``: the results key, the compare keys
``test_port`` / ``val_tail_port``, the model dir ``port_models``, the
report's title, columns and throughput line; the leg's ``framework`` is
``gltvae_torch``. Results land in <workdir>/h2h_results.json and a
markdown report.

    python -m gltvae_torch.parity_head2head --workdir /tmp/h2h --epochs 12 \\
        --n 2100 --skip-reference [--device cpu] [--report h2h.md]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: the folder holding the gltvae_torch package (and tools/reference_runner.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = [('fixed', 'one-one'), ('fixed', 'inferred'),
         ('learnable', 'inferred')]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--workdir', required=True)
    p.add_argument('--epochs', type=int, default=15)
    p.add_argument('--bs', type=int, default=64)
    p.add_argument('--n', type=int, default=2800,
                   help='corpus size (split 5:1:1 train:valid:test)')
    p.add_argument('--sups', type=float, nargs='*', default=[1.0],
                   help='supervision fractions per gate mode')
    p.add_argument('--modes', nargs='*', default=None,
                   help="subset of gate modes, e.g. 'learnable/inferred'")
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--train-seed', type=int, default=None,
                   help='training/eval RNG seed for BOTH legs, leaving the '
                        'corpus at --seed (an existing corpus in --workdir '
                        'is never regenerated). Results are tagged '
                        '.../tseed=N so successive seeds merge into the '
                        'same results file — a seed-variance study on '
                        'identical data.')
    p.add_argument('--tol', type=float, default=0.06,
                   help='max |test-acc delta| counted as parity '
                        '(stochastic eval: the reference itself moved '
                        '0.083 between train-time and re-eval)')
    p.add_argument('--steps-per-dispatch', type=int, default=8)
    p.add_argument('--device', default='cuda',
                   help="device of the port leg: 'cuda' (default) or 'cpu'")
    p.add_argument('--report', default=None,
                   help='markdown report path (e.g. docs/HEAD2HEAD.md)')
    p.add_argument('--skip-reference', action='store_true',
                   help='reuse existing reference result JSONs')
    return p.parse_args(argv)


def splits(n):
    nv = n // 7
    return n - 2 * nv, nv, nv


def train_seed(args):
    return args.seed if args.train_seed is None else args.train_seed


def run_reference(args, gate_type, gate_subtype, sup, root):
    tag = f'{gate_type}_{gate_subtype}_{sup}'
    if args.train_seed is not None:
        tag += f'_s{args.train_seed}'
    out = os.path.join(args.workdir, f'ref_{tag}.json')
    if args.skip_reference and os.path.exists(out):
        with open(out) as f:
            return json.load(f)
    n_tr, n_va, n_te = splits(args.n)
    cmd = [sys.executable, os.path.join(REPO, 'tools/reference_runner.py'),
           '--root', root, '--epochs', str(args.epochs),
           '--bs', str(args.bs), '--gate-type', gate_type,
           '--gate-subtype', gate_subtype, '--sup', str(sup),
           '--n-train', str(n_tr), '--n-valid', str(n_va),
           '--n-test', str(n_te), '--seed', str(train_seed(args)),
           '--out-json', out]
    # the JAX tool's environment: JAX_PLATFORMS=cpu keeps the reference's
    # process off the accelerator
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    subprocess.run(cmd, check=True, env=env)
    with open(out) as f:
        return json.load(f)


def run_port(args, gate_type, gate_subtype, sup, data_dir):
    """The port leg: train.py's command of the JAX tool through
    ``python -m gltvae_torch.cli``, plus ``--device``."""
    n_tr, n_va, n_te = splits(args.n)
    out_dir = os.path.join(args.workdir, 'port_models')
    if args.train_seed is not None:
        # per-seed model dir: the CLI's run_name has no seed component,
        # so successive seeds would clobber each other's checkpoints
        out_dir += f'_s{args.train_seed}'
    cmd = [sys.executable, '-m', 'gltvae_torch.cli',
           '--do-train', '--epochs', str(args.epochs),
           '-bs', str(args.bs), '--data-dir', data_dir,
           '--output-dir', out_dir, '--gate-type', gate_type,
           '--gate-subtype', gate_subtype, '--sup', str(sup),
           '--n-train', str(n_tr), '--n-valid', str(n_va),
           '--n-test', str(n_te), '--seed', str(train_seed(args)),
           '--parity',
           # the reference's PIL decode + default-resample resize: the
           # same input pixels as the reference leg
           '--decode-backend', 'pil',
           '--steps-per-dispatch', str(args.steps_per_dispatch),
           '--device', args.device]
    subprocess.run(cmd, check=True, cwd=REPO)
    if gate_type == 'learnable':
        run_name = f'params_{sup}_{gate_type}'
    else:
        run_name = f'params_{sup}_{gate_type}_{gate_subtype}'
    with open(os.path.join(out_dir, run_name, 'result.json')) as f:
        r = json.load(f)
    return {
        'framework': 'gltvae_torch',
        'gate_type': gate_type, 'gate_subtype': gate_subtype, 'sup': sup,
        'val_accuracy': [h['val_accuracy'] for h in r.get('history', [])],
        'test_accuracy': r['test_accuracy'],
        'images_per_sec': r.get('images_per_sec'),
    }


def compare(ref, port, tol):
    """Parity verdict for one config. A missing test accuracy on either
    leg (e.g. an unparseable reference log) yields parity=None — not a
    bogus delta against 0.0."""
    have_both = (ref['test_accuracy'] is not None
                 and port['test_accuracy'] is not None)
    dt = (abs(ref['test_accuracy'] - port['test_accuracy'])
          if have_both else None)
    k = min(3, len(ref['val_accuracy']), len(port['val_accuracy']))
    tail_ref = ref['val_accuracy'][-k:] if k else []
    tail_port = port['val_accuracy'][-k:] if k else []
    tail_delta = (abs(sum(tail_ref) / k - sum(tail_port) / k)
                  if k else float('nan'))
    return {
        'test_ref': ref['test_accuracy'], 'test_port': port['test_accuracy'],
        'test_delta': dt,
        'val_tail_ref': tail_ref, 'val_tail_port': tail_port,
        'val_tail_delta': tail_delta,
        'parity': bool(dt <= tol) if have_both else None,
    }


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    ref_root = os.path.join(args.workdir, 'ref_root')
    data_dir = os.path.join(ref_root, 'data')

    if not os.path.exists(os.path.join(data_dir, 'list_attr_celeba.csv')):
        print(f'generating corpus ({args.n} images)...')
        from gltvae_torch.parity_corpus import generate_corpus
        generate_corpus(data_dir, n=args.n, seed=args.seed)

    modes = MODES
    if args.modes:
        want = {tuple(m.split('/')) for m in args.modes}
        modes = [m for m in MODES if m in want]

    # successive invocations (e.g. adding a semi-sup config later) merge
    # into the same results file and report
    results_path = os.path.join(args.workdir, 'h2h_results.json')
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    for gate_type, gate_subtype in modes:
        for sup in args.sups:
            tag = f'{gate_type}/{gate_subtype}/sup={sup}'
            if args.train_seed is not None:
                tag += f'/tseed={args.train_seed}'
            print(f'=== {tag}: reference leg ===', flush=True)
            ref = run_reference(args, gate_type, gate_subtype, sup, ref_root)
            print(f'=== {tag}: port leg ===', flush=True)
            port = run_port(args, gate_type, gate_subtype, sup, data_dir)
            results[tag] = {'reference': ref, 'port': port,
                            'compare': compare(ref, port, args.tol)}
            print(json.dumps(results[tag]['compare'], indent=2), flush=True)
            with open(results_path, 'w') as f:
                json.dump(results, f, indent=2)

    if args.report:
        write_report(args, results)
    n_parity = sum(bool(r['compare']['parity']) for r in results.values())
    n_na = sum(r['compare']['parity'] is None for r in results.values())
    print(f'\nparity: {n_parity}/{len(results)} configs within '
          f'tol={args.tol}'
          + (f' ({n_na} n/a: missing test accuracy)' if n_na else ''))
    return results


def write_report(args, results):
    lines = [
        '# Head-to-head: TF reference vs port on an identical corpus',
        '',
        f'Corpus: {args.n} learnable-signal mini-CelebA images '
        f'(tools/parity_corpus.py, seed {args.seed}), splits '
        f'{splits(args.n)}, {args.epochs} epochs, batch {args.bs}. '
        'Both frameworks consumed the SAME JPEG files end-to-end '
        'through their real data paths; eval is the stochastic '
        'reference protocol at gating temp 0.3. Tolerance '
        f'{args.tol} (the reference\'s own checkpoint re-eval moved '
        '0.083 on real CelebA, learnable_results:27).',
        '',
        '| config | ref test acc | port test acc | Δ | '
        'ref val tail | port val tail | parity |',
        '|---|---|---|---|---|---|---|',
    ]
    for tag, r in results.items():
        c = r['compare']

        def fmt(v):
            # a leg can finish training yet yield no parseable test
            # accuracy (aborted eval, log-format drift) — keep the report
            # writable instead of crashing after hours of runs
            if v is None:
                return 'n/a'
            if isinstance(v, (int, float)):
                return f'{v:.3f}'
            return ', '.join('n/a' if x is None else f'{x:.3f}' for x in v)
        lines.append(
            f"| {tag} | {fmt(c['test_ref'])} | {fmt(c['test_port'])} | "
            f"{fmt(c['test_delta'])} | {fmt(c['val_tail_ref'])} | "
            f"{fmt(c['val_tail_port'])} | "
            f"{'n/a' if c['parity'] is None else 'PASS' if c['parity'] else 'FAIL'} |")
    # aggregate throughput over ALL cells in the (merged) results file —
    # successive invocations merge into one json, so a single-cell sample
    # could describe a different config than the runs just completed
    ref_tp = [r['reference'].get('images_per_sec') for r in results.values()]
    port_tp = [r['port'].get('images_per_sec') for r in results.values()]
    ref_tp = [t for t in ref_tp if t]
    port_tp = [t for t in port_tp if t]

    def rng(ts):
        if not ts:
            return 'n/a'
        lo, hi = min(ts), max(ts)
        return f'{lo:.0f}' if lo == hi else f'{lo:.0f}-{hi:.0f}'

    lines += [
        '',
        f'Throughput across the {len(results)} recorded cells: reference '
        f'{rng(ref_tp)} img/s (TF, single CPU core incl. PIL decode) vs '
        f'port {rng(port_tp)} img/s (end-to-end incl. host decode).',
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    print(f'report -> {args.report}')


if __name__ == '__main__':
    main()
