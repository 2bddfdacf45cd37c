"""The comparison that decides ``correct``: the plain reference worked out
from the benchmark's own inputs, against what the timed path produced.

Training: the reference follows the program's first steps (those of the
first dispatches, three or more) from the same seed-made weights, rows and
draws; compared are each step's loss, the first moments Adam holds after
the first dispatch (the first gradient, as m / (1 - β₁)) by leaf, both
by their norms and element by element, and the parameters' change after
the steps by leaf. Test passes: the reference recomputes a sample of the
passes' accuracies, drawn from the seed.

``control.py`` puts the reference in the program's place, in a lower
precision or with a fault planted, to read what the comparison gives
then.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

import harness as H
from reference import ccvae as R
from reference import streams as S

BETA1 = 0.9


def _f32_only():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def ref_params(cell: H.Cell, seed: int, splits: dict, device) -> dict:
    """The seed's weights and μ from the sup and valid labels."""
    p = H.make_weights(cell, seed, device)
    lab = [splits[k][1] for k in ('sup', 'valid') if len(splits[k][1])]
    if cell.train['perc_supervision'] == 0.0:
        y = cell.model['y_dim']
        mu = np.full((y, y), 0.5, np.float32)
        np.fill_diagonal(mu, 1.0)
    else:
        mu = S.cooccurrence(np.concatenate(lab))
    p['mu'] = torch.from_numpy(mu).to(device)
    return p


def gating_temp(cell: H.Cell) -> float:
    t = cell.train.get('gating_init_temp')
    if t is not None:
        return t
    return 1.0 if cell.model['gate_type'] == 'learnable' else 0.3


def train_reference(cell: H.Cell, seed: int, splits: dict, device,
                    first: int, steps: int, precision: str = 'f32',
                    fault: Optional[str] = None) -> dict:
    """The reference's readout of the first `steps` train steps at the
    global batch: losses, first-gradient and change norms by leaf, and
    Adam's first moments after the `first` steps (``m``, tensors)."""
    _f32_only()
    t, m = cell.train, cell.model
    bs = t['batch_size']
    params = ref_params(cell, seed, splits, device)
    flags = S.schedule(len(splits['sup'][0]), len(splits['unsup'][0]), bs,
                       t['perc_supervision'])[:steps]
    streams = {True: S.batches(len(splits['sup'][0]), bs, seed),
               False: S.batches(len(splits['unsup'][0]), bs, seed)}
    batches, noises = [], []
    for i, f in enumerate(flags):
        rows = next(streams[f])
        x, y = splits['sup' if f else 'unsup']
        batches.append((torch.from_numpy(x[rows]).to(device).float() / 255.0,
                        torch.from_numpy(y[rows]).to(device)))
        noises.append(S.train_noise(seed, i, bs, m,
                                    t['classifier_mc_samples'], f, device))
    out = R.train_steps(params, batches, noises, flags, gating_temp(cell), m,
                        t, first=first, precision=precision, fault=fault,
                        world=cell.chips)
    return {'losses': out['losses'],
            'grad': H.leaf_norms(out['m_first'], 1.0 / (1.0 - BETA1)),
            'update': H.leaf_norms({n: out['params'][n] - params[n]
                                    for n in out['m_first']}),
            'm': out['m_first']}


def test_reference(cell: H.Cell, seed: int, splits: dict, device,
                   passes: List[int], precision: str = 'f32',
                   fault: Optional[str] = None) -> Dict[int, float]:
    """The reference's accuracy of test passes `passes` (0 the first the
    program ran): the eval generator and the test split's index stream
    are advanced through every earlier pass."""
    _f32_only()
    m, bs = cell.model, cell.train['batch_size']
    params = ref_params(cell, seed, splits, device)
    x_all, y_all = splits['test']
    n = len(x_all)
    nb = -(-n // bs)
    rows = S.batches(n, bs, seed)
    g = S.eval_generator(seed, device)
    temp = cell.train.get('eval_gating_temp', 0.3)
    want, out = set(passes), {}
    for j in range(max(passes) + 1):
        idx = [next(rows) for _ in range(nb)]
        noises = [S.eval_noise(g, bs, m, device) for _ in range(nb)]
        if j not in want:
            continue
        bt = [(torch.from_numpy(x_all[r]).to(device).float() / 255.0,
               torch.from_numpy(y_all[r]).to(device)) for r in idx]
        out[j] = R.eval_pass(params, bt, noises, temp, m, precision,
                              fault)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """|‖prog‖ − ‖ref‖| over max(‖ref‖, the median leaf's ‖ref‖), by leaf
    of `names`."""
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names: List[str]) -> Dict[str, float]:
    """‖prog − ref‖ over max(‖ref‖, the median leaf's ‖ref‖), by leaf of
    `names`, in float64 on the tensors' device. A common scale of both
    sides, such as Adam's 1 / (1 − β₁), cancels."""
    norm = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(norm.values())))
    return {n: float((prog[n].double() - ref[n].double()).norm())
            / max(norm[n], med, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]) -> tuple:
    n = max(gaps, key=gaps.get)
    return gaps[n], n


def _median(gaps: Dict[str, float]) -> tuple:
    return float(np.median(list(gaps.values()))), f'of {len(gaps)} leaves'


def train_checks(prog: dict, ref: dict) -> Dict[str, tuple]:
    """The training comparison: each of the first steps' losses, the first
    gradient's norm by leaf, the parameters' change after the steps by
    leaf (leaves whose reference gradient is under a thousandth of the
    median leaf's left out), at the worst leaf, and the gradient's at the
    median leaf too; and the first gradient element by element
    (``leaf_diffs`` of Adam's first moments), at the worst and at the
    median leaf. Values are (gap, detail); a cell compares those its
    limits name."""
    names = sorted(ref['grad'])
    med_g = float(np.median([ref['grad'][n] for n in names]))
    moved = [n for n in names if ref['grad'][n] >= 1e-3 * med_g]
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog['losses'], ref['losses'])]
    if len(prog['losses']) != len(ref['losses']):
        losses.append(float('inf'))
    grad = leaf_gaps(prog['grad'], ref['grad'], names)
    update = leaf_gaps(prog['update'], ref['update'], moved)
    diff = leaf_diffs(prog['m'], ref['m'], names)
    return {'loss': (max(losses), 'steps ' + ' '.join(
                f'{a:.7g}/{b:.7g}' for a, b in
                zip(prog['losses'], ref['losses']))),
            'grad': _worst(grad), 'update': _worst(update),
            'grad_median': _median(grad),
            'grad_diff': _worst(diff), 'grad_diff_median': _median(diff)}


def sample_passes(n_passes: int, seed: int, k: int) -> List[int]:
    """The first and last pass and k others, drawn from the seed."""
    rng = np.random.RandomState(seed % (2 ** 32))
    pick = set(rng.choice(n_passes, size=min(k, n_passes), replace=False))
    return sorted(pick | {0, n_passes - 1})


def test_checks(prog: Dict[int, float], ref: Dict[int, float]) -> dict:
    worst = max(ref, key=lambda j: abs(prog[j] - ref[j]))
    return {'accuracy': (abs(prog[worst] - ref[worst]),
                         f'pass {worst} {prog[worst]:.7g}/{ref[worst]:.7g} '
                         f'of {len(ref)} passes')}


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}, stderr lines) over the numbers
    the cell's limits name."""
    ok, table, lines = True, {}, []
    for name, lim in limits.items():
        value, detail = checks[name]
        good = bool(np.isfinite(value)) and value <= lim
        ok = ok and good
        table[name] = {'value': value, 'limit': lim}
        lines.append(f'check {name}: {value:.6g} (limit {lim:g}) '
                     f'{"ok" if good else "FAILED"} [{detail}]')
    return ok, table, lines
