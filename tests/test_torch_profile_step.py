"""``gltvae_torch.profile_step``'s modes (tools/profile_train.py's
train-scan, train-step, eval-resident and eval-chunked) built and profiled
at a tiny size on the CPU, and the --summary writer."""

import json
from types import SimpleNamespace

import pytest
import torch

from gltvae_torch import profile_step as P

torch.set_num_threads(2)

TINY = ['--device', 'cpu', '--batch-size', '4', '--steps', '1', '--scan',
        '2', '--eval-images', '8', '--top', '3']


@pytest.mark.parametrize('resident', ['auto', 'off'])
@pytest.mark.parametrize('mode', P.MODES)
def test_each_mode_profiles_and_writes_its_summary(tmp_path, capsys, mode,
                                                   resident):
    path = tmp_path / 'summary.json'
    rec = P.main(TINY + ['--mode', mode, '--resident-train', resident,
                         '--out', str(tmp_path), '--summary', str(path)])
    printed = capsys.readouterr().out
    summary = json.loads(path.read_text())
    assert list(summary) == [mode] and summary[mode] == json.loads(
        json.dumps(rec))
    assert rec['launches_per_dispatch'] > 0
    assert rec['device_ms_per_dispatch'] > 0 and rec['device'] == 'cpu'
    assert len(rec['top_kernels']) == 3
    inner = {'train-step': 1, 'train-scan': 2}.get(mode)
    assert rec['steps_per_dispatch'] == inner
    assert rec['eval_batches_per_dispatch'] == (None if inner else 2)
    if mode == 'train-step':
        assert 'per step (mean of 1, sup/unsup alternating, bs 4): wall ' \
            in printed
    else:
        assert f'mode {mode}: per dispatch (' in printed
    assert (tmp_path / f'{mode.replace("-", "_")}_trace.json').exists()


def test_summary_keeps_the_other_modes(tmp_path):
    path = str(tmp_path / 'sub' / 's.json')
    P.write_summary(path, 'train-step', {'a': 1})
    out = P.write_summary(path, 'eval-chunked', {'b': 2})
    assert out == {'train-step': {'a': 1}, 'eval-chunked': {'b': 2}}
    assert P.write_summary(path, 'train-step', {'a': 3})['train-step'] == \
        {'a': 3}


def test_kernel_table_totals_and_order():
    cuda = torch.autograd.DeviceType.CUDA
    ev = [SimpleNamespace(key=k, self_device_time_total=us, count=c,
                          device_type=cuda)
          for k, us, c in (('gemm', 3000.0, 4), ('dequant', 500.0, 2),
                           ('conv', 6000.0, 8))]
    t = P.kernel_table(ev, 2, 2)
    assert t['device_ms_total'] == 9.5 and t['device_ms_per_dispatch'] == 4.75
    assert t['launches_per_dispatch'] == 7.0
    assert [k['name'] for k in t['top_kernels']] == ['conv', 'gemm']
    assert t['top_kernels'][0]['calls_per_dispatch'] == 4.0


def test_eval_modes_need_one_batch():
    with pytest.raises(SystemExit, match='under one batch'):
        P.main(TINY[:-4] + ['--eval-images', '2', '--mode', 'eval-chunked'])
