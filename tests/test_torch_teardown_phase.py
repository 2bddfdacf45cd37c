"""chip_smoke.py's phase 43 rehearsed on the CPU: ``teardown_rank``
through ``python -m torch.distributed.run`` on 2 gloo ranks, each running
``config.dp_sweep()[0]``'s data-parallel sup step (cut to a global batch
of 16, still bf16) twice, keeping it and leaving its group under the
phase's faulthandler bound. On the CPU nothing is captured (the
static-buffer path runs eagerly), so nothing is registered or released;
the card's checks of the capture and the release are made there.
tests/test_torch_mesh_release.py holds the release itself on the CPU."""

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize('worlds,want', [([1], [1]), ([1, 2, 4], [2, 4]),
                                         ([2], [2])])
def test_phase_43_runs_past_one_rank_or_on_one(worlds, want):
    assert chip_smoke.teardown_worlds(worlds) == want


def test_teardown_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    out = chip_smoke.teardown_phase(torch.device('cpu'), 'cpu', [1, 2],
                                    batch=16)
    assert list(out) == [2]
    r = out[2]
    assert len(r['left_s']) == 2
    assert all(0 <= s < chip_smoke.TEARDOWN_BOUND for s in r['left_s'])
    assert (r['captured'], r['registered'], r['collectives']) == (False, 0,
                                                                  0)
    printed = capsys.readouterr().out
    for rank in (0, 1):
        assert f'rank {rank} of 2: leaving the group' in printed
        assert f'rank {rank} of 2: left the group in' in printed
    assert printed.count('[phase 43] D = 2: 2 rank(s) over gloo') == 1
    log = chip_smoke.kept_log('teardown_d2.log')
    assert log.startswith(str(tmp_path)) and open(log).read().count(
        'left the group in') == 2
