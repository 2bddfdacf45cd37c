"""The training comparison's arithmetic (``checks.train_checks``): the
norm gaps on a fixed input, the element-wise gaps of the first gradient
on made-up moments, and ``c128.train``'s element-wise limit between the
program in bfloat16 and its float8 control on the CPU at batch 32."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import checks as C  # noqa: E402
import harness as H  # noqa: E402

#: a bfloat16 rounding unit, relative
UNIT = 2.0 ** -9


def _moments(seed=0):
    """Five leaves of different sizes and scales."""
    g = torch.Generator().manual_seed(seed)
    return {'a': torch.randn(400, generator=g) * 3.0,
            'b': torch.randn(60, 50, generator=g),
            'c': torch.randn(70, generator=g) * 0.01,
            'd': torch.randn(2, 30, 40, generator=g) * 0.5,
            'e': torch.randn(32, 3, 4, 4, generator=g) * 0.2}


def _readout(m, losses=(2.0, 1.5, 1.25)):
    return {'losses': list(losses), 'm': m,
            'grad': H.leaf_norms(m, 1.0 / (1.0 - C.BETA1)),
            'update': H.leaf_norms(m)}


def test_the_element_wise_gaps_read_zero_on_identical_moments():
    ref = _moments()
    prog = {n: v.clone() for n, v in ref.items()}
    chk = C.train_checks(_readout(prog), _readout(ref))
    assert chk['grad_diff'][0] == 0.0
    assert chk['grad_diff_median'] == (0.0, 'of 5 leaves')


def test_every_element_moved_by_a_rounding_unit_reads_the_unit():
    """Each element moved by 2^-9 of itself: a leaf at or above the median
    norm reads 2^-9, one below it less; the scale of the moments (Adam's
    1 / (1 - β₁)) cancels."""
    ref = {n: v.double() for n, v in _moments(1).items()}
    prog = {n: v * (1.0 + UNIT) for n, v in ref.items()}
    diffs = C.leaf_diffs(prog, ref, sorted(ref))
    norms = {n: float(v.norm()) for n, v in ref.items()}
    med = sorted(norms.values())[2]
    for n in ref:
        want = UNIT * norms[n] / max(norms[n], med)
        assert diffs[n] == pytest.approx(want, rel=1e-9), n
    chk = C.train_checks(_readout(prog), _readout(ref))
    assert chk['grad_diff'][0] == pytest.approx(UNIT, rel=1e-9)
    assert norms[chk['grad_diff'][1]] >= med
    assert chk['grad_diff_median'][0] == pytest.approx(UNIT, rel=1e-9)
    scaled = {n: v * 10.0 for n, v in prog.items()}
    again = C.leaf_diffs(scaled, {n: v * 10.0 for n, v in ref.items()},
                         sorted(ref))
    assert again == pytest.approx(diffs, rel=1e-9)


def test_an_uncorrelated_error_the_norm_gap_hides_shows_element_wise():
    """Noise of 1% on every element moves a leaf's norm by far less than
    1%; element by element it reads about 1%."""
    ref = _moments(2)
    g = torch.Generator().manual_seed(3)
    prog = {n: v * (1.0 + 0.01 * torch.randn(v.shape, generator=g))
            for n, v in ref.items()}
    chk = C.train_checks(_readout(prog), _readout(ref))
    assert chk['grad_median'][0] < 2e-3
    assert 5e-3 < chk['grad_diff_median'][0] < 1.5e-2


def test_the_norm_gaps_keep_their_values_on_a_fixed_input():
    """loss, grad, update and grad_median on readouts of norms given by
    hand: reference gradients 1, 2, 4 and 1e-4 (median 1.5; the last
    leaf's change is left out, its gradient under a thousandth of the
    median's)."""
    m = {n: v for n, v in _moments().items() if n != 'e'}
    ref = {'losses': [10.0, 9.9, 8.0], 'm': m,
           'grad': {'a': 1.0, 'b': 2.0, 'c': 4.0, 'd': 1e-4},
           'update': {'a': 0.5, 'b': 1.0, 'c': 2.0, 'd': 1.0}}
    prog = {'losses': [10.0, 9.0, 8.4], 'm': m,
            'grad': {'a': 1.3, 'b': 2.0, 'c': 3.0, 'd': 0.0},
            'update': {'a': 0.5, 'b': 1.1, 'c': 2.0, 'd': 9.0}}
    chk = C.train_checks(prog, ref)
    assert chk['loss'][0] == pytest.approx(0.9 / 9.9, rel=1e-12)
    assert chk['loss'][1] == 'steps 10/10 9/9.9 8.4/8'
    assert chk['grad'] == (pytest.approx(0.25, rel=1e-12), 'c')
    # a: 0.3 / 1.5, b: 0, c: 1 / 4, d: 1e-4 / 1.5
    assert chk['grad_median'] == (pytest.approx((0.2 + 1e-4 / 1.5) / 2,
                                                rel=1e-12), 'of 4 leaves')
    # over a, b, c: median 1.0; b reads 0.1 / 1.0
    assert chk['update'] == (pytest.approx(0.1, rel=1e-12), 'b')
    short = dict(prog, losses=[10.0, 9.9])
    assert C.train_checks(short, ref)['loss'][0] == float('inf')


#: c128.train on the CPU: three steps of 32 rows at 128 px
SMALL_128 = {'n_train': 80, 'n_valid': 24, 'n_test': 24, 'batch_size': 32,
             'trace': {'skip': 1, 'count': None}}
SEED = 2 ** 31 + 5151


def test_c128_separates_bfloat16_from_its_float8_control():
    """grad_diff_median of the program in bfloat16 as configured reads
    under the cell's limit; the control and each fault in its place read
    over it."""
    import control
    import run
    cell = H.load_cell('c128.train')
    assert cell.model['compute_dtype'] == 'bfloat16'
    lim = cell.workload['limits']['grad_diff_median']
    r = run.execute('c128.train', SEED, 0.5, 0, device='cpu',
                    sizes=SMALL_128)
    sound = r['checks']['grad_diff_median']['value']
    assert sound < lim
    out = {who: chk['grad_diff_median'][0] for who, chk in
           control.readings('c128.train', SEED, 'cpu', SMALL_128)}
    assert set(out) == {'control fp8', 'fault state_unchanged',
                        'fault half_batch'}
    for who, v in out.items():
        assert v > lim, (who, v, sound)
    assert out['control fp8'] > 3.0 * sound
