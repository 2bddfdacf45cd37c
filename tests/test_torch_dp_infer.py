"""The port's data-parallel entry points on gloo ranks spawned on the CPU
(tests/torch_dp_workers.py): ``infer --mesh`` and the CLI's ``--dist-*``
flags and host-sharded loaders.

- ``infer --mesh`` on 2 ranks writes the one-process CSV: the same
  images and hard labels, probabilities within 1e-6 (the CSV's 4
  decimals hold them equal), deterministic and ``--stochastic``; a
  ``--batch-size`` that is not a multiple of the world size is refused
  with tools/infer.py's message.
- ``cli --dist-coordinator --dist-num-processes --dist-process-id`` on 2
  ranks (each joins the group itself) trains and tests as the
  one-process CLI does: the metric rows within rtol 1e-5, the same test
  accuracy; rank 0 alone writes the run's files. A partial ``--dist-*``
  set raises train.py's message.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from tests import torch_dp_workers as W

from gltvae_torch import cli as tcli
from gltvae_torch import infer as tinfer
from gltvae_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def run_and_photos(tmp_path_factory):
    """A trained tiny run folder (the one-process CLI) and 7 photos, so a
    batch of 4 ends in a wrap-around tail."""
    import PIL.Image
    tmp = tmp_path_factory.mktemp('dp_infer')
    photos = tmp / 'photos'
    photos.mkdir()
    r = np.random.RandomState(0)
    for i in range(7):
        PIL.Image.fromarray(r.randint(0, 256, (218, 178, 3), dtype=np.uint8)
                            ).save(photos / f'im{i}.jpg', quality=95)
    tcli.main(_cli_argv(tmp / 'one'))
    return tmp, tmp / 'one' / 'params_0.5_learnable', photos


def _cli_argv(out):
    return ['--synthetic', '--synthetic-n', '64', '-bs', '16', '--epochs',
            '1', '--sup', '0.5', '--do-train', '--z-dim', '20', '--device',
            'cpu', '--num-workers', '0', '--output-dir', str(out)]


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


@pytest.mark.parametrize('stochastic', [False, True])
def test_infer_mesh_writes_the_one_process_csv(run_and_photos, stochastic):
    tmp, run, photos = run_and_photos
    argv = ['--checkpoint', str(run), '--images', str(photos),
            '--batch-size', '4', '--device', 'cpu', '--num-workers', '0']
    argv += ['--stochastic'] if stochastic else []
    one = tmp / f'one_{stochastic}.csv'
    tinfer.main(argv + ['--output', str(one)])
    two = tmp / f'two_{stochastic}.csv'
    W.launch('infer', 2, tmp / f'infer_{stochastic}',
             argv=argv + ['--mesh', '--output', str(two)])
    a, b = _read(one), _read(two)
    assert len(a) == len(b) == 8 and a[0] == b[0]
    n = (len(a[0]) - 1) // 2
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[:1 + n] == rb[:1 + n]
        np.testing.assert_allclose(np.float64(rb[1 + n:]),
                                   np.float64(ra[1 + n:]), atol=1e-6)


def test_infer_mesh_refuses_a_batch_the_world_does_not_split(
        run_and_photos, monkeypatch):
    _, run, photos = run_and_photos
    monkeypatch.setattr(pmesh, 'create_mesh',
                        lambda device=None: pmesh.Mesh(0, 2,
                                                       torch.device('cpu')))
    with pytest.raises(SystemExit, match='--batch-size 5 must be a '
                                         'multiple of the 2-device mesh'):
        tinfer.main(['--checkpoint', str(run), '--images', str(photos),
                     '--batch-size', '5', '--device', 'cpu', '--mesh'])


def test_cli_dist_flags_train_as_one_process(run_and_photos):
    tmp, run, _ = run_and_photos
    out = tmp / 'two'
    ranks = W.launch('cli', 2, tmp / 'cli', join=False,
                     argv=_cli_argv(out))
    with open(run / 'result.json') as f:
        want = json.load(f)
    assert [r['result'][0.5] for r in ranks] == [want['test_accuracy']] * 2
    two = out / 'params_0.5_learnable'
    with open(two / 'result.json') as f:
        got = json.load(f)
    assert got['history'][0]['val_accuracy'] == \
        want['history'][0]['val_accuracy']
    rows = [_read(d / 'metrics.csv') for d in (run, two)]
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 2
    head = rows[0][0]
    for k in ('loss', 'elbo', 'log_pxz', 'kl'):
        i = head.index(k)
        np.testing.assert_allclose(float(rows[1][1][i]), float(rows[0][1][i]),
                                   rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(two)) == sorted(os.listdir(run))


@pytest.mark.parametrize('given', [
    ['--dist-coordinator', 'localhost:1234'],
    ['--dist-num-processes', '2', '--dist-process-id', '0']])
def test_a_partial_dist_set_raises(given, tmp_path):
    with pytest.raises(SystemExit, match='multi-host runs need all three of '
                                         '--dist-coordinator, '
                                         '--dist-num-processes, '
                                         '--dist-process-id'):
        tcli.main(_cli_argv(tmp_path) + given)
