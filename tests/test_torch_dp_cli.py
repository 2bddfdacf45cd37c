"""The data-parallel CLI on gloo ranks spawned on the CPU
(tests/torch_dp_workers.py), and the pure helpers of chip_smoke.py's
phase 39, which runs the same CLI through torchrun over NCCL on the card.

- ``cli --dist-coordinator --dist-num-processes --dist-process-id`` on 2
  ranks: every rank ends training and restores for test with a state
  bit-equal to rank 0's (params, Adam m and v), and rank 0 alone writes
  result.json, model_config.json, metrics.csv, the checkpoints and the μ
  files. No rank returns before rank 0's result.json is written, nor
  before rank 0's ``infer --mesh`` CSV is whole, even when rank 0 is slow
  to write them.
- A single torchrun process (``RANK``, ``MASTER_ADDR``, ``WORLD_SIZE=1``)
  joins a process group of one, as ``torchrun --nproc-per-node=1 ...
  --mesh`` does on one card.
- Phase 39's helpers: its rank counts a card count allows, its argv
  (``config.dp_sweep()[0]``'s command), its steps and eval batches, the
  state digest, the write log, the torchrun command and the bounds.
"""

import math
import os
import socket

import numpy as np
import pytest
import torch

from tests import torch_dp_workers as W

import chip_smoke
from gltvae_torch.parallel import mesh as pmesh
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(1)

RUN = 'params_0.5_learnable'


def _cli_argv(out):
    return ['--synthetic', '--synthetic-n', '64', '-bs', '16', '--epochs',
            '1', '--sup', '0.5', '--do-train', '--z-dim', '20', '--device',
            'cpu', '--num-workers', '0', '--output-dir', str(out)]


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    """The CLI on 2 gloo ranks with the --dist-* triple, rank 0 slow to
    write result.json."""
    tmp = tmp_path_factory.mktemp('dp_cli')
    out = tmp / 'run'
    ranks = W.launch('cli_files', 2, tmp / 'ranks', join=False,
                     argv=_cli_argv(out), slow_rank0=True)
    return out, ranks


def test_every_rank_ends_with_rank0s_state(two_ranks):
    _, ranks = two_ranks
    r0 = ranks[0]
    assert r0['final']['step'] == 4          # 64 images at 16: 2 + 2 steps
    for r in ranks:
        assert r['final'] == r0['final']
        assert r['restored'] == r0['restored']
        assert r['result'] == r0['result']


def test_rank0_alone_writes_the_run_files(two_ranks):
    out, ranks = two_ranks
    files = ranks[0]['written']
    assert ranks[1]['written'] == []
    for name in ('result.json', 'model_config.json', 'metrics.csv',
                 'learned_gating_matrix_best.npy',
                 'learned_gating_matrix_best.csv',
                 'learned_gating_matrix_last.npy',
                 'learned_gating_matrix_last.csv'):
        assert f'{RUN}/{name}' in files, name
    assert any(f.startswith(f'{RUN}/checkpoints/') for f in files)
    assert os.path.exists(out / RUN / 'result.json')


def test_no_rank_returns_before_rank0s_result_json(two_ranks):
    _, ranks = two_ranks
    assert [r['result_json_on_return'] for r in ranks] == [True, True]


def test_no_rank_returns_before_rank0s_csv_is_whole(two_ranks, tmp_path):
    import PIL.Image
    out, _ = two_ranks
    photos = tmp_path / 'photos'
    photos.mkdir()
    r = np.random.RandomState(0)
    for i in range(7):
        PIL.Image.fromarray(r.randint(0, 256, (218, 178, 3), dtype=np.uint8)
                            ).save(photos / f'im{i}.jpg', quality=95)
    argv = ['--checkpoint', str(out / RUN), '--images', str(photos),
            '--batch-size', '4', '--device', 'cpu', '--num-workers', '0',
            '--mesh', '--output', str(tmp_path / 'preds.csv')]
    ranks = W.launch('infer_slow', 2, tmp_path / 'infer', argv=argv)
    assert [r['rows_on_return'] for r in ranks] == [8, 8]


def test_a_single_torchrun_rank_joins_a_group_of_one(monkeypatch):
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        mesh = pmesh.create_mesh('cpu')
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, 'gloo')
        assert mesh.group is not None
        t = torch.ones(3)
        assert torch.equal(mesh.all_reduce_(t), torch.ones(3))
    finally:
        pmesh.shutdown()


def test_no_torchrun_environment_is_a_world_of_one(monkeypatch):
    for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR'):
        monkeypatch.delenv(k, raising=False)
    mesh = pmesh.create_mesh('cpu')
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)


@pytest.mark.parametrize('cards,sweep,want', [
    (1, False, [1]), (4, False, [1]), (1, True, [1]), (2, True, [1, 2]),
    (3, True, [1, 2, 3]), (4, True, [1, 2, 4]), (8, True, [1, 2, 4])])
def test_phase39_worlds_never_exceed_the_cards(cards, sweep, want):
    assert chip_smoke.dp_cli_worlds(cards, sweep) == want


@pytest.mark.parametrize('given,want', [('4,2', [2, 4]), ('2', [2]),
                                        ('4,4,1', [1, 4]), ('8', None),
                                        ('0,2', None)])
def test_phase39_worlds_as_given_never_exceed_the_cards(given, want):
    """--worlds picks the rank counts of a --sweep-only run, sorted, and
    never more ranks than cards."""
    if want is None:
        with pytest.raises(RuntimeError, match='--worlds'):
            chip_smoke.dp_cli_worlds(4, True, given)
    else:
        assert chip_smoke.dp_cli_worlds(4, True, given) == want


@pytest.mark.parametrize('mesh', [False, True])
def test_phase39_argv_is_the_sweeps_first_command(mesh):
    from gltvae_torch.cli import build_configs, parse_args
    from gltvae_torch.config import dp_sweep
    argv = chip_smoke.dp_cli_argv('out', mesh)
    args = parse_args(argv)
    assert args.mesh is mesh and args.synthetic and args.do_train
    assert (args.synthetic_n, args.epochs, args.device, args.output_dir) \
        == (65536, 2, 'cuda', 'out')
    _, model_want, train_want = dp_sweep()[0]
    model_cfg, train_cfg = build_configs(args, args.sup[0])
    assert args.sup == [train_want.perc_supervision] == [0.2]
    for k in ('gate_type', 'gate_subtype', 'compute_dtype', 'z_dim',
              'y_dim', 'image_size'):
        assert getattr(model_cfg, k) == getattr(model_want, k), k
    assert train_cfg.batch_size == train_want.batch_size == 4096
    small = parse_args(chip_smoke.dp_cli_argv(
        'o', True, 'cpu', n=64, epochs=1, batch=16, dtype='float32'))
    assert (small.synthetic_n, small.epochs, small.batch_size,
            small.compute_dtype, small.device) == (64, 1, 16, 'float32',
                                                   'cpu')


def test_phase39_counts_34_steps_and_6_eval_batches():
    # 65,536 at sup 0.2: 13,107 sup rows (4 batches of 4096, the last
    # wrapping) and 52,429 unsup (13); 8,192 eval rows a split (2 batches)
    assert chip_smoke.dp_cli_steps(chip_smoke.dp_cli_argv('o', True)) == \
        (34, 6)
    assert chip_smoke.dp_cli_steps(chip_smoke.dp_cli_argv(
        'o', True, n=64, epochs=1, batch=16)) == (5, 8)


def _state(seed=0):
    from gltvae_torch.config import ModelConfig, TrainConfig
    torch.manual_seed(seed)
    model_cfg = ModelConfig(**W.SMALL)
    train_cfg = TrainConfig(batch_size=8)
    mu = np.full((model_cfg.z_classify, model_cfg.y_dim), 0.5, np.float32)
    state = create_train_state(init_model(model_cfg, train_cfg, mu, 'cpu'),
                               train_cfg)
    for d in (state.adam_m, state.adam_v):
        for k, v in d.items():
            v.copy_(torch.rand(v.shape))
    return state


@pytest.mark.parametrize('part', ['params', 'adam_m', 'adam_v'])
def test_state_digest_sees_one_ulp(part):
    a, b = _state(), _state()
    assert chip_smoke.state_digest(a) == chip_smoke.state_digest(b)
    tensors = dict(b.model.named_parameters()) if part == 'params' else \
        getattr(b, part)
    t = tensors[sorted(tensors)[-1]]
    with torch.no_grad():
        flat = t.view(-1)
        flat[0] = torch.nextafter(flat[0], torch.tensor(math.inf))
    got, want = chip_smoke.state_digest(b), chip_smoke.state_digest(a)
    assert got[part] != want[part]
    assert {k: v for k, v in got.items() if k != part} == \
        {k: v for k, v in want.items() if k != part}


def test_written_paths_logs_every_writer_and_undoes(tmp_path):
    import builtins
    log = []
    opened = builtins.open
    undo = chip_smoke.written_paths(log)
    try:
        with open(tmp_path / 'a.txt', 'w') as f:
            f.write('x')
        with open(tmp_path / 'a.txt') as f:          # a read: not logged
            f.read()
        torch.save({}, str(tmp_path / 'b.pt'))
        np.save(str(tmp_path / 'c.npy'), np.zeros(2))
        np.savez(str(tmp_path / 'd.npz'), x=np.zeros(2))
        os.replace(tmp_path / 'a.txt', tmp_path / 'e.txt')
    finally:
        undo()
    assert builtins.open is opened
    names = {os.path.basename(p) for p in log}
    assert names >= {'a.txt', 'b.pt', 'c.npy', 'd.npz', 'e.txt'}
    assert all(os.path.isabs(p) for p in log)


def test_torchrun_command_starts_local_ranks():
    assert chip_smoke.torchrun(4, '-m', 'gltvae_torch.infer', '--mesh')[1:] \
        == ['-m', 'torch.distributed.run', '--standalone',
            '--nproc-per-node=4', '-m', 'gltvae_torch.infer', '--mesh']


@pytest.mark.parametrize('dtype,m,v', [('bfloat16', 2e-2, 1e-2),
                                       ('float32', 1e-3, 1e-3)])
def test_phase39_bounds_are_steps_times_phase37s(dtype, m, v):
    params = {'a': torch.full((100,), 0.5), 'b': torch.zeros(300)}
    ref = {'params': params}
    got = chip_smoke.dp_cli_bounds(ref, 34, 1e-4, dtype)
    norm = 0.5 * 10.0                          # |a| = 0.5 * sqrt(100)
    per_step = 2e-4 + (1e-6 + 0.25e-4) * math.sqrt(400) / norm
    assert got['params'] == pytest.approx(34 * per_step)
    assert (got['adam_m'], got['adam_v']) == pytest.approx((34 * m, 34 * v))


def test_rel_l2_is_over_all_tensors_as_one_vector():
    got = {'a': torch.tensor([3.0, 0.0]), 'b': torch.tensor([0.0])}
    want = {'a': torch.tensor([0.0, 0.0]), 'b': torch.tensor([4.0])}
    assert chip_smoke.rel_l2(got, want) == pytest.approx(5.0 / 4.0)


def test_a_hung_or_failed_process_fails_the_phase(tmp_path):
    import sys
    import time
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match='timed out after 1 s'):
        chip_smoke.run_bounded([sys.executable, '-c',
                                'import time; time.sleep(60)'],
                               str(tmp_path / 'hung.log'), 1.0)
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match='exited 3'):
        chip_smoke.run_bounded([sys.executable, '-c',
                                'import sys; sys.exit(3)'],
                               str(tmp_path / 'failed.log'), 60.0)
    assert chip_smoke.run_bounded([sys.executable, '-c', 'print(1)'],
                                  str(tmp_path / 'ok.log'), 60.0) > 0
    assert (tmp_path / 'ok.log').read_text() == '1\n'


def test_csv_gap_counts_rows_labels_and_the_largest_gap():
    head = ['image_id,A,B,p_A,p_B']
    a = head + ['x.jpg,0,1,0.4944,0.6000', 'y.jpg,1,1,0.9000,0.8000']
    b = head + ['x.jpg,0,1,0.4945,0.6000', 'y.jpg,0,1,0.4999,0.8000']
    assert chip_smoke.csv_gap(a, a) == {'rows': 0, 'labels': 0,
                                        'max_p': 0.0}
    got = chip_smoke.csv_gap(a, b)
    assert (got['rows'], got['labels']) == (2, 1)
    assert got['max_p'] == pytest.approx(0.4001)
    assert chip_smoke.csv_gap(a, a[:2])['rows'] == 1
