"""``python -m tests.torch_f2_rule --fresh`` (fault F2's rule R1' over the
fresh seeds 40-69) on hand-written panels whose Welch t and verdict are
worked out here by hand, and on the committed artifacts: 30 legs a side.

Each hand panel has four values 0.02 apart, so each side's sample
variance is (0.03² + 0.01² + 0.01² + 0.03²)/3 = 0.002/3 and Welch's
standard error sqrt(2 · (0.002/3)/4) = 0.0182574; a gap of the means d
gives t = d / 0.0182574."""

import json

import numpy as np
import pytest

from tests import torch_f2_rule as rule

SE = (2 * (0.002 / 3) / 4) ** 0.5


def _write(tmp_path, name, values):
    with open(tmp_path / name, 'w') as f:
        json.dump({f'locs=relu/seed={s}': {'locs': 'relu', 'seed': s,
                                           'test_accuracy': v}
                   for s, v in zip(range(40, 40 + len(values)), values)}, f)


@pytest.mark.parametrize('a2,b2,t,holds', [
    # means 0.630 and 0.690: t = -0.06 / SE = -3.286, |t| >= 2: fails
    ([0.60, 0.62, 0.64, 0.66], [0.66, 0.68, 0.70, 0.72], -3.2863, False),
    # means 0.650 and 0.660: t = -0.5477, both within 0.06 of 0.648: holds
    ([0.62, 0.64, 0.66, 0.68], [0.63, 0.65, 0.67, 0.69], -0.5477, True),
    # t = -0.5477, but A2's mean 0.530 is 0.118 under 0.648: fails
    ([0.50, 0.52, 0.54, 0.56], [0.51, 0.53, 0.55, 0.57], -0.5477, False),
], ids=['gap', 'seed_variance', 'off_reference'])
def test_fresh_rule_on_hand_panels(monkeypatch, tmp_path, capsys, a2, b2, t,
                                   holds):
    monkeypatch.setattr(rule, 'ART', str(tmp_path))
    monkeypatch.setattr(rule, 'FRESH_SEEDS', range(40, 44))
    _write(tmp_path, 'one_one_seed_panel_torch_fresh.json', a2)
    _write(tmp_path, 'one_one_seed_panel_gltvae_cpu_fresh.json', b2)
    out = rule.main(['--fresh', '--json', str(tmp_path / 'r.json')])
    r = out['R1_fresh']
    assert r['welch_t'] == pytest.approx(t, abs=1e-4)
    assert r['welch_t'] == pytest.approx((np.mean(a2) - np.mean(b2)) / SE)
    assert r['sd_a'] == pytest.approx((0.002 / 3) ** 0.5)
    assert r['holds'] is holds
    assert out['verdict'] == (
        "closed as seed variance (R1' holds)" if holds else
        "open: R1' failed, a gap of the whole pipeline confirmed on fresh "
        "seeds")
    printed = capsys.readouterr().out
    assert f"Welch t {t:.3f}" in printed and f"F2: {out['verdict']}" in \
        printed
    with open(tmp_path / 'r.json') as f:
        assert json.load(f)['verdict'] == out['verdict']


def test_fresh_artifacts_hold_thirty_legs_a_side():
    a2, b2 = rule.fresh_records()
    assert len(a2) == len(b2) == 30
    assert np.isfinite(a2).all() and np.isfinite(b2).all()
    for name in ('one_one_seed_panel_torch_fresh.json',
                 'one_one_seed_panel_gltvae_cpu_fresh.json'):
        with open(f'{rule.ART}/{name}') as f:
            d = json.load(f)
        assert sorted(v['seed'] for v in d.values()) == list(range(40, 70))
        assert {(v['gate_type'], v['gate_subtype'], v['sup'], v['locs'])
                for v in d.values()} == {('fixed', 'one-one', 1.0, 'relu')}
        assert all(len(v['val_accuracy']) == 12 for v in d.values())
