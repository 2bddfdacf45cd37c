"""``gltvae_torch.config.dp_sweep`` against gltvae's ``v5p8_sweep``
(BASELINE config 5): the same 9 (name, ModelConfig, TrainConfig) triples
field by field; its first entry at global batch 32 (f32, as gltvae's own
test compiles it on the CPU) for one sup and one unsup step on 2 gloo
ranks against one process, by chip_smoke phase 31's rules; and the
dequant kernel's launch plan at the sweep's (4096, 64, 64, 3) batch."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import gltvae.config as jcfg
import gltvae_torch.config as tcfg
from gltvae_torch.ops import preprocess
from gltvae_torch.train.state import keras_alpha
from tests import torch_dp_workers as W

torch.set_num_threads(2)


@pytest.mark.parametrize('i', range(9))
def test_dp_sweep_entry_equals_v5p8_sweep(i):
    (jn, jm, jt), (tn, tm, tt) = jcfg.v5p8_sweep()[i], tcfg.dp_sweep()[i]
    assert tn == jn
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert tt.batch_size == 4096 and tm.compute_dtype == 'bfloat16'


def test_dp_sweep_overrides_equal_v5p8_sweep():
    kw = dict(n_epochs=3, lr=3e-4, seed=5)
    for (jn, jm, jt), (tn, tm, tt) in zip(jcfg.v5p8_sweep(**kw),
                                          tcfg.dp_sweep(**kw)):
        assert (tn, dataclasses.asdict(tm), dataclasses.asdict(tt)) == \
            (jn, dataclasses.asdict(jm), dataclasses.asdict(jt))


@pytest.mark.parametrize('offset', [0, 4, 13])
def test_dequant_plan_covers_the_sweep_batch(offset):
    """(4096, 64, 64, 3) is 50,331,648 bytes: 12,288 whole 4 KB tiles from
    an aligned base, every byte covered once from an unaligned one."""
    n = 4096 * 64 * 64 * 3
    plan = preprocess.dequant_plan(0x10000 + offset, 0x7f0000000000, n)
    assert plan.head + plan.tiles * preprocess.DEQUANT_TILE + plan.tail == n
    assert plan.grid == max(plan.tiles, math.ceil(
        (plan.head + plan.tail) / preprocess.THREADS))
    assert plan.grid < 2 ** 31 - 1
    if offset == 0:
        assert (plan.head, plan.tiles, plan.tail) == (0, 12288, 0)


def test_sweep_entry_on_two_gloo_ranks_equals_one_process(tmp_path):
    B = 32
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8),
                (rng.rand(B, 18) > 0.5).astype(np.float32))
               for _ in range(2)]
    one = W.sweep(None, B, batches)
    ranks = W.launch('sweep', 2, tmp_path, timeout_s=240.0, batch=B,
                     batches=batches)
    lr, eps = 1e-4, 1e-7
    for got in ranks:
        for mine, ref in zip(got, one):
            for k, v in ref['metrics'].items():
                assert abs(mine['metrics'][k] - v) <= 1e-5 * max(abs(v),
                                                                 1e-6), k
            for g in ('adam_m', 'adam_v'):
                for k, v in ref['state'][g].items():
                    gap = float((mine['state'][g][k] - v).abs().max())
                    assert gap <= 2e-4 * max(float(v.abs().max()), 1e-30), k
            alpha = keras_alpha(mine['state']['adam_count'], lr)
            for k, p in ref['state']['params'].items():
                q = mine['state']['params'][k]
                out = (q - p).abs() > 1e-6 + 2e-4 * p.abs()
                if out.any():               # the Adam step of its moments
                    m = mine['state']['adam_m'][k]
                    v = mine['state']['adam_v'][k]
                    step = mine['p0'][k] - alpha * m / (v.sqrt() + eps)
                    assert float((q - step)[out].abs().max()) <= lr / 4, k
    assert ranks[0][0]['state']['adam_count'] == 1
