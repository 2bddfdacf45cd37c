"""gltvae_torch.eval.analysis against gltvae.eval.analysis on random μ:
equal results (tolerance 0)."""

import numpy as np
import pytest

from gltvae.eval import analysis as ja

from gltvae_torch.eval import analysis as ta


@pytest.mark.parametrize('shape,seed', [((18, 18), 0), ((40, 40), 1),
                                        ((18, 40), 2)])
def test_analysis_equals_gltvae(shape, seed):
    r = np.random.RandomState(seed)
    mu = r.rand(*shape)
    mu[r.rand(*shape) < 0.1] = 0.6          # ties at a threshold
    init = r.rand(*shape).astype(np.float32)
    for t in (0.0, 0.5, 0.6, 0.95):
        assert ta.off_diagonal_gates(mu, t) == ja.off_diagonal_gates(mu, t)
    assert ta.gating_threshold_analysis(mu) == \
        ja.gating_threshold_analysis(mu)
    assert ta.gating_threshold_analysis(mu, (0.25, 0.6)) == \
        ja.gating_threshold_analysis(mu, (0.25, 0.6))
    assert ta.compare_init_vs_learned(init, mu) == \
        ja.compare_init_vs_learned(init, mu)
    assert ta.DEFAULT_THRESHOLDS == ja.DEFAULT_THRESHOLDS


def test_off_diagonal_gates_skip_the_diagonal():
    mu = np.eye(4) + 0.7 * np.eye(4, k=1)
    assert ta.off_diagonal_gates(mu) == [(0, 1, 0.7), (1, 2, 0.7),
                                         (2, 3, 0.7)]
    assert ta.gating_threshold_analysis(mu, (0.5, 0.8)) == [(0.5, 3),
                                                            (0.8, 0)]
