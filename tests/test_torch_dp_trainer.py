"""Trainer(mesh=) of gltvae_torch: its legs on gloo ranks spawned on the CPU
(tests/torch_dp_workers.py) against the one-process Trainer.

Each run trains the tiny model for 2 epochs at sup 0.5 (8 steps in mixed
chunks, global batch 16) and tests: resident (the default), both splits
shipped, shipped from host-sharded loaders, and augmented (augment_pad 2,
chunks of 2). Held:
- a mesh of one rank (a gloo group) equals no mesh bit for bit: state,
  every metric row, test accuracy and ELBO;
- two ranks: params rtol 2e-4 atol 1e-6 and every metric row rtol 1e-5 of
  the one-process run (tests/test_parallel.py's tolerances); host-sharded
  loaders (local) equal global batches (replicated) bit for bit, and
  mesh-resident equals host-shipped bit for bit, as
  tests/test_resident_train.py holds gltvae; each rank holds ⌈N/D⌉ rows
  of a resident split; the ranks' states are equal;
- each rank's augment crops equal its rows of the one-process crops, bit
  for bit;
- eval from one state: accuracy equal to the one-process value (the
  all-gathered matches), the ELBO rtol 1e-5 (a mean of the ranks' means);
- resume continues training on the mesh (tests/test_trainer_mesh_e2e.py);
- under --debug-nans a NaN on one rank raises on both, and neither hangs.
"""

import csv
import os

import numpy as np
import pytest
import torch

from tests import torch_dp_workers as W

torch.set_num_threads(1)

RUNS = list(W.TRAINER_RUNS)
KEYS = ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'log_qy_x', 'c_sum')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('dp_trainer')
    return {'one': W.trainer_set(None),
            1: W.launch('trainer_set', 1, tmp)[0],
            2: W.launch('trainer_set', 2, tmp)}


def _equal_state(a, b):
    return all(torch.equal(a[g][k], b[g][k])
               for g in ('params', 'adam_m', 'adam_v') for k in a[g]) \
        and a['step'] == b['step'] and a['adam_count'] == b['adam_count']


@pytest.mark.parametrize('name', RUNS)
def test_mesh_of_one_equals_no_mesh(runs, name):
    one, mesh1 = runs['one'][name], runs[1][name]
    assert _equal_state(mesh1['state'], one['state'])
    assert mesh1['rows'] == one['rows'] and len(one['rows']) == 8
    assert (mesh1['test_acc'], mesh1['test_elbo']) == \
        (one['test_acc'], one['test_elbo'])


@pytest.mark.parametrize('name', RUNS)
def test_two_ranks_equal_one_process(runs, name):
    one = runs['one'][name]
    for rank in runs[2]:
        got = rank[name]
        assert got['replicas_agree']
        assert got['state']['step'] == 8
        for k, v in one['state']['params'].items():
            np.testing.assert_allclose(got['state']['params'][k].numpy(),
                                       v.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=k)
        for a, b in zip(got['rows'], one['rows']):
            assert (a['epoch'], a['supervised'], a['step']) == \
                (b['epoch'], b['supervised'], b['step'])
            for k in KEYS:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        assert got['gating_temp'] == one['gating_temp']
    assert _equal_state(runs[2][0][name]['state'],
                        runs[2][1][name]['state'])


def test_host_sharded_loaders_equal_global_batches(runs):
    for rank in runs[2]:
        a, b = rank['shipped_local'], rank['shipped']
        assert _equal_state(a['state'], b['state']) and a['rows'] == b['rows']
        assert (a['test_acc'], a['test_elbo']) == (b['test_acc'],
                                                   b['test_elbo'])


def test_mesh_resident_equals_host_shipped(runs):
    """Bit for bit; a resident split's rows are split over the ranks:
    ⌈32/2⌉ = 16 train rows and ⌈35/2⌉ = 18 eval rows (one of them
    padding) a rank, where one process holds all of them."""
    for rank in runs[2]:
        a, b = rank['resident'], rank['shipped']
        assert _equal_state(a['state'], b['state']) and a['rows'] == b['rows']
        assert (a['test_acc'], a['test_elbo']) == (b['test_acc'],
                                                   b['test_elbo'])
        assert a['resident'] == {'sup': (16, 16, 16, 3),
                                 'unsup': (16, 16, 16, 3),
                                 'valid': (18, 16, 16, 3),
                                 'test': (18, 16, 16, 3)}
        assert b['resident'] == {}
    assert runs['one']['resident']['resident']['valid'] == (35, 16, 16, 3)


def test_augment_crops_are_the_ranks_rows_of_one_draw(runs):
    """Each dispatch's crops [2, 8, 16, 16, 3] on rank r are rows
    [8r, 8r + 8) of the one-process crops [2, 16, ...] (one launch a
    dispatch on each rank)."""
    one = runs['one']['augmented']['crops']
    assert len(one) == 4 and tuple(one[0].shape) == (2, 16, 16, 16, 3)
    for r, rank in enumerate(runs[2]):
        got = rank['augmented']['crops']
        assert len(got) == len(one)
        for a, b in zip(got, one):
            assert torch.equal(a, b[:, 8 * r:8 * r + 8])


def test_eval_equals_one_process(runs):
    """From one state: validation accuracy and test accuracy equal the
    one-process values exactly, resident and shipped; the ELBO rtol
    1e-5."""
    want = runs['one']['evaluate']
    for rank in runs[2]:
        for path in ('resident', 'shipped'):
            acc, elbo, test_acc = rank['evaluate'][path]
            assert (acc, test_acc) == (want[path][0], want[path][2])
            np.testing.assert_allclose(elbo, want[path][1], rtol=1e-5)


def test_resume_on_a_mesh_continues_training(tmp_path):
    """2 epochs on 2 ranks, then a new Trainer on each resumes into a
    4-epoch schedule: the restored state fast-forwards the epoch and the
    temperature and trains 2 epochs more; rank 0 alone wrote metrics.csv
    (8 rows an epoch, no duplicates), and both ranks restored one
    checkpoint."""
    run_dir = str(tmp_path / 'run')
    ranks = W.launch('resume', 2, tmp_path, run_dir=run_dir)
    for rank in ranks:
        assert rank['first']['state']['step'] == 8
        assert rank['second']['state']['step'] == 16
        assert [h['epoch'] for h in rank['second']['history']] == [2, 3]
        np.testing.assert_allclose(rank['second']['gating_temp'], 0.99 ** 4)
    assert _equal_state(ranks[0]['second']['state'],
                        ranks[1]['second']['state'])
    with open(os.path.join(run_dir, 'metrics.csv'), newline='') as f:
        steps = [int(r['step']) for r in csv.DictReader(f)]
    assert steps == list(range(16))
    assert os.listdir(os.path.join(run_dir, 'checkpoints'))


def test_debug_nans_raises_on_every_rank(tmp_path):
    """A NaN encoder weight on rank 0 only: both ranks replay and raise
    FloatingPointError, and no rank hangs in a collective. Rank 0 names
    the conv; rank 1's rows are clean, so its first NaN op comes after
    the gradient all-reduce (the slice of the averaged buffer)."""
    ranks = W.launch('debug_nans', 2, tmp_path, timeout_s=60.0)
    assert 'aten.convolution' in ranks[0]['raised']
    assert ranks[1]['raised'].startswith('invalid value (nan) encountered')
    assert 'aten.convolution' not in ranks[1]['raised']
