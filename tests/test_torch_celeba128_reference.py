"""celeba128's structure against the benchmark's plain reference on the
CPU: the port's Trainer at 128 px with all 40 labels, five encoder stages,
bfloat16, the space-to-depth first conv and last transposed conv and remat
'dots' (``perfbench/configs/celeba128.json``), at narrow widths and batch
8, against ``perfbench/reference/ccvae.py`` in float32 from the same
seed-made weights, rows and draws, as ``perfbench/checks.py`` compares
the ``c128.train`` workload (``perfbench/workloads/c128.train.json``);
and the port in float32 with remat 'none' against 'dots'.
"""

import os
import sys

import numpy as np
import pytest
import torch

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'perfbench')

#: narrow widths of the 128 px model: five stride-2 stages, then the valid
#: 4x4 conv at 1x1
NARROW = {'n_train': 80, 'n_valid': 24, 'n_test': 24, 'batch_size': 8,
          'enc_features': [8, 8, 16, 16, 32], 'enc_hidden': 32,
          'dec_features': [32, 16, 16, 8, 8], 'dec_hidden': 16}
SEED = 2 ** 31 + 12812


@pytest.fixture(scope='module')
def bench():
    """perfbench's harness, session, checks and streams modules."""
    sys.path.insert(0, PERFBENCH)
    try:
        import checks
        import harness
        import session
        from reference import streams
    finally:
        sys.path.remove(PERFBENCH)
    return harness, session, checks, streams


def _readout(bench, tmp, dtype=None, remat=None):
    """The cell at NARROW through the port's Trainer (the warm-up epoch of
    the benchmark's session): (cell, splits, readout of the first steps:
    the comparison's, with the parameters' change as tensors)."""
    H, session, _, _ = bench
    sizes = dict(NARROW)
    if dtype:
        sizes['compute_dtype'] = dtype
    cell = H.load_cell('c128.train', sizes)
    if remat:
        cell.config['train']['remat'] = remat
    torch.manual_seed(0)
    s = session.TrainSession(cell, SEED, 'cpu', str(tmp))
    s.warm_up()
    out = cell, s.splits, dict(s.program_readout(),
                               delta=s.readout['delta'])
    s.close()
    return out


@pytest.fixture(scope='module')
def bf16(bench, tmp_path_factory):
    _, _, C, S = bench
    cell, splits, prog = _readout(bench, tmp_path_factory.mktemp('c128'))
    ref = C.train_reference(cell, SEED, splits, 'cpu', prog['first'],
                            prog['steps'])
    t = cell.train
    flags = S.schedule(len(splits['sup'][0]), len(splits['unsup'][0]),
                       t['batch_size'], t['perc_supervision'])
    return cell, prog, ref, flags[:prog['steps']]


def test_the_cell_is_the_preset(bf16):
    cell = bf16[0]
    m, t = cell.model, cell.train
    assert (m['image_size'], m['y_dim'], m['z_dim']) == (128, 40, 100)
    assert len(m['enc_features']) == 5
    assert m['compute_dtype'] == 'bfloat16'
    assert m['input_s2d'] and m['output_s2d'] and t['remat'] == 'dots'


def test_sup_and_unsup_losses_within_bfloat16_rounding(bf16):
    """Each of the first steps' loss, a supervised one and unsupervised
    ones among them. The loss is a mean over the batch of sums over every
    pixel, label and latent; the bfloat16 products round each term by up
    to 2^-9 of itself, errors that mostly cancel in the sums, so the loss
    stays within one bfloat16 unit (2^-8) of the float32 reference."""
    _, prog, ref, flags = bf16
    assert True in flags and False in flags
    assert len(prog['losses']) == len(ref['losses']) == len(flags)
    for a, b in zip(prog['losses'], ref['losses']):
        assert abs(a - b) <= 2.0 ** -8 * abs(b), (a, b)


def test_the_first_gradient_element_by_element(bench, bf16):
    """The first gradient, element by element at the median leaf, under
    the cell's limit (``grad_diff_median``, set for bfloat16's rounding at
    the card's batch of 256, where it reads about 2^-9)."""
    _, _, C, _ = bench
    cell, prog, ref, _ = bf16
    got, _ = C.train_checks(prog, ref)['grad_diff_median']
    assert 0.0 < got < cell.workload['limits']['grad_diff_median']


def test_remat_dots_equals_none_in_float32(bench, tmp_path):
    """Remat recomputes the forward in the backward, the same ops on the
    same inputs: losses, first moments and the change after the first
    steps agree to float32's rounding."""
    runs = [_readout(bench, tmp_path / r, 'float32', r)[2]
            for r in ('none', 'dots')]
    a, b = runs
    np.testing.assert_allclose(a['losses'], b['losses'], rtol=1e-6)
    for part in ('m', 'delta'):
        for n in a[part]:
            torch.testing.assert_close(a[part][n], b[part][n], rtol=1e-5,
                                       atol=1e-7, msg=lambda m: f'{n}: {m}')
