"""Summarize a run's metrics.csv: per-epoch ELBO decomposition + trends
(counterpart of tools/metrics_summary.py; the same text, table and PNGs).

The Trainer writes the full ELBO decomposition (log p(x|z), KL,
log q(y|z,c), log q(y|x), gate mass) per logged step to metrics.csv
(train/metrics.py); this tool folds that into a per-epoch table and
headline trends, and optionally renders a PNG of the curves.

    python -m gltvae_torch.metrics_summary run/params_1.0_learnable/metrics.csv
    python -m gltvae_torch.metrics_summary run/metrics.csv --plot curves.png \\
        --gating-history run/params_1.0_learnable/gating_history.npz

``--plot`` needs matplotlib and raises ImportError before reading anything
where it is not installed. Host-only (numpy).
"""

from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

import numpy as np

COLS = ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'log_qy_x', 'c_sum')


def load(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    # CSVs written before the once-per-file header fix carry a repeated
    # header line at each resume point: drop those rows
    rows = [r for r in rows if r.get('epoch') != 'epoch']
    if not rows:
        raise SystemExit(f'{path} is empty')
    return rows


def per_epoch(rows):
    by_ep = defaultdict(list)
    for r in rows:
        by_ep[int(float(r['epoch']))].append(r)
    out = []
    for ep in sorted(by_ep):
        agg = {'epoch': ep, 'n': len(by_ep[ep]),
               'sup_frac': float(np.mean(
                   [float(r['supervised']) for r in by_ep[ep]]))}
        for c in COLS:
            agg[c] = float(np.mean([float(r[c]) for r in by_ep[ep]]))
        out.append(agg)
    return out


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('--plot needs matplotlib, which is not installed; '
                          'run without --plot for the text summary') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('metrics_csv')
    p.add_argument('--plot', default=None, metavar='PNG',
                   help='render loss/ELBO-decomposition curves')
    p.add_argument('--gating-history', default=None, metavar='NPZ',
                   help='per-epoch gate-evolution summary from the '
                        'gating_history.npz a learnable run writes next '
                        'to its checkpoints (with --plot, also renders '
                        '<PNG stem>_gating.png)')
    args = p.parse_args(argv)
    plt = _pyplot() if args.plot else None

    rows = load(args.metrics_csv)
    epochs = per_epoch(rows)

    hdr = ['epoch', 'loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc',
           'log_qy_x', 'c_sum']
    print('  '.join(f'{h:>10s}' for h in hdr))
    shown = epochs if len(epochs) <= 12 else (
        epochs[:5] + [None] + epochs[-5:])
    for e in shown:
        if e is None:
            print(f'{"...":>10s}')
            continue
        print('  '.join([f'{e["epoch"]:>10d}'] +
                        [f'{e[c]:>10.2f}' for c in hdr[1:]]))

    first, last = epochs[0], epochs[-1]
    print(f'\n{len(rows)} logged steps over {len(epochs)} epochs; '
          f'loss {first["loss"]:.1f} -> {last["loss"]:.1f}, '
          f'recon log p(x|z) {first["log_pxz"]:.1f} -> '
          f'{last["log_pxz"]:.1f}, KL {first["kl"]:.2f} -> '
          f'{last["kl"]:.2f}, gate mass {first["c_sum"]:.1f} -> '
          f'{last["c_sum"]:.1f}')

    if plt is not None:
        eps = [e['epoch'] for e in epochs]
        fig, axes = plt.subplots(2, 2, figsize=(10, 7))
        for ax, (title, cols) in zip(axes.flat, [
                ('loss', ['loss']),
                ('reconstruction log p(x|z)', ['log_pxz']),
                ('KL / classifier terms', ['kl', 'log_qy_zc', 'log_qy_x']),
                ('gate mass Σc', ['c_sum'])]):
            for c in cols:
                ax.plot(eps, [e[c] for e in epochs], label=c)
            ax.set_title(title)
            ax.set_xlabel('epoch')
            if len(cols) > 1:
                ax.legend()
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f'wrote {args.plot}')

    if args.gating_history:
        summarize_gating_history(args.gating_history, args.plot)
    return epochs


def summarize_gating_history(npz_path, plot=None):
    """Gate evolution across epochs: off-diagonal mass, count of strong
    off-diagonal gates (>0.5, Quantitative_analysis.py's top threshold),
    and per-epoch μ movement. Input: the [n, zc, y] stack the Trainer
    snapshots each learnable epoch."""
    with np.load(npz_path) as z:
        eps, mus = z['epochs'], z['mu']
    off = ~np.eye(mus.shape[1], mus.shape[2], dtype=bool)
    print(f'\ngating history: {len(eps)} epochs, μ {mus.shape[1:]}')
    print('  '.join(f'{h:>10s}' for h in
                    ['epoch', 'offd_mean', 'offd>0.5', 'max|Δμ|']))
    prev = None
    rows = []
    for e, m in zip(eps, mus):
        d = 0.0 if prev is None else float(np.abs(m - prev).max())
        rows.append((int(e), float(m[off].mean()),
                     int((m[off] > 0.5).sum()), d))
        prev = m
    shown = rows if len(rows) <= 12 else rows[:5] + [None] + rows[-5:]
    for r in shown:
        if r is None:
            print(f'{"...":>10s}')
            continue
        print(f'{r[0]:>10d}  {r[1]:>10.4f}  {r[2]:>10d}  {r[3]:>10.4f}')
    if plot:
        plt = _pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot([r[0] for r in rows], [r[1] for r in rows])
        axes[0].set_title('mean off-diagonal gate μ')
        axes[1].plot([r[0] for r in rows], [r[3] for r in rows])
        axes[1].set_title('max |Δμ| per epoch')
        for ax in axes:
            ax.set_xlabel('epoch')
        out = os.path.splitext(plot)[0] + '_gating.png'
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        print(f'wrote {out}')
    return rows


if __name__ == '__main__':
    main()
