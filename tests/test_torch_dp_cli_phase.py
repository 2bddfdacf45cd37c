"""chip_smoke.py's phase 39 rehearsed on the CPU: the data-parallel CLI
through ``python -m torch.distributed.run`` on 1 and 2 gloo ranks (the
card runs NCCL ranks, one a card), against the same command in one
process, then ``infer --mesh`` through torchrun against the one-process
``infer`` (at the rows each card labels at once; the gap at the global
batch printed). The run is cut to 64 synthetic images, 1 epoch at batch
16, f32 (5 steps and 8 eval batches) and 16 JPEGs at batch 4; every check
the card makes is made here (the device times are not measured off the
card)."""

import torch

import chip_smoke


def test_dp_cli_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.setattr(chip_smoke, 'DP_CLI_PHOTOS', (8, 4, 4))
    monkeypatch.setattr(chip_smoke, 'DP_CLI_INFER_BS', 4)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    out = chip_smoke.dp_cli_phase(torch.device('cpu'), 'cpu', [1, 2], n=64,
                                  epochs=1, batch=16, dtype='float32')
    assert (out['steps'], out['eval_batches']) == (5, 8)
    assert out['one_process']['launches'] == 13
    assert {w: r['launches_per_rank'] for w, r in out['worlds'].items()} \
        == {1: [13], 2: [13, 13]}
    assert out['worlds'][1]['shape'] == [16, 64, 64, 3]
    assert out['worlds'][2]['shape'] == [8, 64, 64, 3]
    for r in out['worlds'].values():
        assert all(r['gaps'][k] <= out['bounds'][k] for k in r['gaps'])
        assert r['device_ms_per_step'] is None
        assert r['step_wall_ms'] > 0 and r['spawn_to_first_step_s'] > 0
    assert out['shapes'] == [None, None]
    printed = capsys.readouterr().out
    assert printed.count('[phase 39]') == 5
    assert printed.count('the CSV equals row for row the one process\'s '
                         'at batch') == 2
    assert 'against one process at batch 4: ' in printed
    assert printed.count('slice_dp_cli ') == 3
