"""``gltvae_torch.bench_data`` against tools/bench_data.py: the same rows
in the same order (each side's benches stubbed), the corpus byte for
byte, a real run at --n 32 on the CPU, and the ship+step leg at a tiny
batch on the CPU (host-resized and full-resolution batches)."""

import os
import sys

import pytest
import torch

from gltvae_torch import bench_data as T
from tools import bench_data as J

torch.set_num_threads(2)

STUBS = ('bench_pil_sequential', 'bench_cv2_sequential', 'bench_native',
         'bench_training_loader', 'bench_ship_and_step')


def _rows(text):
    return [line[:45].rstrip() for line in text.splitlines()]


@pytest.mark.parametrize('flags', [[], ['--device-resize'],
                                   ['--threads', '3', '--out-size', '128',
                                    '--device-resize']],
                         ids=['defaults', 'device_resize', 'threads3_128'])
def test_rows_equal_the_jax_tool(monkeypatch, capsys, flags):
    for mod in (J, T):
        for name in STUBS:
            monkeypatch.setattr(mod, name, lambda *a, **k: 1000.0)
        monkeypatch.setattr(mod, 'make_corpus', lambda root, n: [])
    monkeypatch.setattr(sys, 'argv', ['bench_data.py'] + flags)
    J.main()
    want = capsys.readouterr().out
    results = T.main(flags + ['--device', 'cpu'])
    got = capsys.readouterr().out
    assert got == want
    assert list(results) == _rows(want)
    assert list(results) == T.row_names(
        128 if '128' in flags else 64,
        3 if '3' in flags else os.cpu_count() or 1,
        '--device-resize' in flags)


def test_corpus_bytes_equal_the_jax_tool(tmp_path):
    a = J.make_corpus(str(tmp_path / 'jax'), 12)
    b = T.make_corpus(str(tmp_path / 'port'), 12)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p)
                                                for p in b]
    for name in ('list_attr_celeba.csv', *(os.path.join(
            'img_align_celeba', os.path.basename(p)) for p in a)):
        assert (tmp_path / 'jax' / name).read_bytes() == \
            (tmp_path / 'port' / name).read_bytes()


def test_a_real_run_at_n_32_on_the_cpu(capsys):
    results = T.main(['--n', '32', '--threads', '2'])
    assert list(results) == T.row_names(64, 2, False)
    for name in ('pil_sequential (reference pattern)', 'cv2_sequential',
                 'train-path cv2 x2',
                 'train-path cv2 + cache_decoded (epoch 2+)'):
        assert results[name] > 0, name
    printed = capsys.readouterr().out
    assert printed.count('img/s') + printed.count('n/a') == len(results)


@pytest.mark.parametrize('full_res', [False, True],
                         ids=['host_resize', 'device_resize'])
def test_ship_and_step_on_the_cpu(full_res):
    rate = T.bench_ship_and_step(64, batch_size=2, iters=2,
                                 full_res=full_res, device='cpu')
    assert rate > 0


def test_ship_and_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('this checks a machine without a CUDA device')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.bench_ship_and_step(64, batch_size=2, iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main(['--n', '8', '--device-resize'])
