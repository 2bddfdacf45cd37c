"""chip_smoke.py phase 40 (the captured train step) rehearsed on the CPU.

On the CPU the captured path runs its static buffers eagerly; a stand-in
graph (tests/test_torch_graphs.py's ``fake_capture``) replays by running
the device part again. The dequant wrapper counts a launch here where the
card would launch. Small widths (16 px, batch 8; the sweep's stand-in at
64 px with 18 labels, as phase 37's inputs).
"""

import dataclasses

import pytest
import torch

import chip_smoke
import gltvae_torch.config as tcfg
from gltvae_torch.ops import preprocess
from gltvae_torch.train import graphs
from tests.test_torch_graphs import (B, CPU, batches, configs,
                                     counted,  # noqa: F401 (a fixture)
                                     fake_capture, fresh, mu_init)

torch.set_num_threads(2)


def test_replays_count_the_launches_their_capture_recorded(monkeypatch,
                                                          counted):
    """The warm-up's launches and the capture's recording are left out of
    the dequant count; each replay adds the one launch its capture
    recorded, and a second step kind captures its own."""
    model_cfg, train_cfg = configs()
    state, (sup, unsup) = fresh(model_cfg, train_cfg, True)
    monkeypatch.setattr(graphs, 'graph_capture',
                        lambda dev: fake_capture(state))
    data = batches(5)
    for i, (x, y) in enumerate(data[:3]):
        sup(state, x, y, 1.0)
        assert preprocess.launches == i + 1
    cs, = sup.steps.values()
    assert cs.dequant_launches == 1 and cs.graph.replays == 3
    unsup(state, *data[3], 1.0)
    assert preprocess.launches == 4
    sup(state, *data[4], 1.0)
    assert preprocess.launches == 5 and state.step == 5


def test_eager_vs_captured_is_bit_equal_on_the_cpu(counted):
    """Phase 40's comparison: 16 steps of the interleave from one state,
    eager and captured (static buffers): bit-equal, 16 launches each."""
    model_cfg, train_cfg = configs()
    kinds = [i % 2 == 0 for i in range(16)]
    temps = [1.0] * 8 + [0.99] * 8
    res = chip_smoke.eager_vs_captured(model_cfg, train_cfg, mu_init(),
                                       batches(16), kinds, temps, CPU)
    assert res['equal'] and res['launches'] == (16, 16)
    assert all(v == 0.0 for v, _ in res['worst'].values())
    assert chip_smoke.hold_captured('tiny', res, chip_smoke.F32_TOL) \
        .startswith('bit-equal')


@pytest.mark.parametrize('size,caught', [(1e-9, False), (1.0, True)])
def test_the_bounds_catch_a_captured_step_gone_wrong(monkeypatch, capsys,
                                                     size, caught):
    """A planted error in the captured run's Adam moments: found and named
    (not bit-equal, its leaf printed), held to F32_TOL: one far under the
    tolerance passes, one far over it fails the phase."""
    model_cfg, train_cfg = configs()
    call = graphs.CapturedStep.__call__

    def planted(self, state):
        out = call(self, state)
        with torch.no_grad():
            state.adam_m['classifier.kernel'].add_(
                size * state.adam_m['classifier.kernel'].abs().max())
        return out
    monkeypatch.setattr(graphs.CapturedStep, '__call__', planted)
    res = chip_smoke.eager_vs_captured(
        model_cfg, train_cfg, mu_init(), batches(4), [True, False] * 2,
        [1.0] * 4, CPU)
    assert not res['equal']
    assert res['worst']['adam_m'][1] == 'classifier.kernel'
    if caught:
        with pytest.raises(RuntimeError, match='beyond the tolerance'):
            chip_smoke.hold_captured('planted', res, chip_smoke.F32_TOL)
    else:
        assert chip_smoke.hold_captured('planted', res, chip_smoke.F32_TOL) \
            .startswith('within tolerance')
    assert 'classifier.kernel' in capsys.readouterr().out


def test_graphs_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys,
                                           counted):
    """Phase 40 whole at batch 8: (a) and (b) bit-equal with 16 launches
    each, (c) the Trainer's metrics.csv equal with 22 launches (16 steps +
    6 eval batches), (d) four graphs_speed lines naming the card."""
    def small(image_size, y_dim):
        return tcfg.ModelConfig(
            image_size=image_size, z_dim=24 if y_dim == 18 else 8,
            y_dim=y_dim, enc_features=(8,) * (4 if image_size == 64 else 2),
            enc_hidden=16, dec_features=(16, 8, 8, 8)[:4 if image_size == 64
                                                      else 2])

    def train(sup, **kw):
        return tcfg.TrainConfig(perc_supervision=sup, classifier_mc_samples=4,
                                **kw)
    monkeypatch.setattr(chip_smoke, 'BATCH', B)
    monkeypatch.setattr(chip_smoke, 'SWEEP_BATCH', B)
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.setattr(chip_smoke, 'SPEED_STEPS', 6)
    monkeypatch.setattr(chip_smoke, 'SPEED_PROFILED', 2)
    monkeypatch.setattr(tcfg, 'default_celeba64', lambda sup, **kw: (
        small(16, 4), train(sup, **kw)))
    monkeypatch.setattr(tcfg, 'celeba128', lambda sup, **kw: (
        dataclasses.replace(small(64, 18), input_s2d=True, output_s2d=True),
        train(sup, **kw)))
    monkeypatch.setattr(tcfg, 'dp_sweep', lambda: [(
        'tiny', dataclasses.replace(small(64, 18), compute_dtype='bfloat16'),
        train(0.2, batch_size=B))])
    out = chip_smoke.graphs_phase(CPU, 'cpu')
    assert (out['plain'], out['128'], out['trainer']) == (16, 16, 22)
    assert set(out['speed']) == {'plain_eager', 'plain_captured',
                                 'sweep_eager', 'sweep_captured'}
    printed = capsys.readouterr().out
    assert printed.count('[phase 40]') == 4
    assert printed.count('bit-equal') == 2
    assert printed.count('graphs_speed: ') == 4 and '"card": "cpu"' in printed


def test_phase_11_records_what_reaches_the_captured_steps(monkeypatch,
                                                          tmp_path):
    """Phase 11's record on the captured path: each train step's u8 batch
    as its static input holds it (gathered from the resident split, or
    copied in from the host), each eval batch where it is dequantized,
    and nothing from a step's device part itself: 16 steps + 6 eval
    batches a run, bit-equal between the two runs."""
    from gltvae_torch.data.synthetic import synthetic_splits
    from tests.test_torch_chip_smoke import _on_the_cpu
    _on_the_cpu(monkeypatch, tmp_path)
    model_cfg = tcfg.ModelConfig(image_size=16, z_dim=8, y_dim=4,
                                 enc_features=(8, 8), enc_hidden=16,
                                 dec_features=(16, 8))
    train_cfg = tcfg.TrainConfig(perc_supervision=0.5, n_epochs=2,
                                 batch_size=B, classifier_mc_samples=4)
    splits = synthetic_splits(n_train=8 * B, n_valid=2 * B, n_test=2 * B,
                              sup_frac=0.5, image_size=16, y_dim=4)
    recs = {}
    for how, kw in (('resident', {}), ('shipped', dict(
            resident_train='off', resident_eval='off'))):
        recs[how] = []
        run = chip_smoke.train_and_test(how, model_cfg, train_cfg, splits,
                                        CPU, f'phase11_{how}',
                                        record=recs[how], **kw)
        trainer = run['trainer']
        assert trainer._jit
        assert bool(trainer._resident_data) == (how == 'resident')
    assert len(recs['resident']) == len(recs['shipped']) == 22
    assert all(a.dtype == torch.uint8 and torch.equal(a, b)
               for a, b in zip(recs['resident'], recs['shipped']))


@pytest.mark.parametrize('nodes', [1, 0])
def test_the_graph_audit_holds_each_capture_to_its_count(monkeypatch,
                                                         tmp_path, counted,
                                                         nodes):
    """audit_graphs reads a captured graph's node dump at its capture: a
    graph holding the dequant and augment kernels as often as the capture
    counted (one dequant launch and no augment here) is tallied; a graph
    without it fails the capture. The stand-in graph's dump lists `nodes`
    dequant kernel nodes."""
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    # audit_graphs patches these for the rest of its process
    monkeypatch.setattr(graphs, '_cuda_capture', graphs._cuda_capture)
    monkeypatch.setattr(graphs.Captured, '_capture',
                        graphs.Captured._capture)
    tally = chip_smoke.audit_graphs()
    model_cfg, train_cfg = configs()
    state, (sup, _) = fresh(model_cfg, train_cfg, True)
    stand_in = fake_capture(state)

    def capture(fn, pool):
        graph, out = stand_in(fn, pool)

        def dump(path):
            with open(path, 'w') as f:
                f.write('"node"[label="{KERNEL | dequant_kernel}"]\n' * nodes
                        + '"node"[label="{KERNEL | reduce_kernel}"]\n')
        graph.debug_dump = dump
        return graph, out
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: capture)
    (x, y), = batches(1)
    if nodes:
        sup(state, x, y, 1.0)
        counts = {k: tally[k] for k in ('graphs', 'dequant_nodes',
                                        'augment_nodes', 'kinds')}
        assert counts == {'graphs': 1, 'dequant_nodes': 1,
                          'augment_nodes': 0, 'kinds': {'CapturedStep': 1}}
        assert list(tally['capture_s']) == ['CapturedStep']
        assert tally['capture_s']['CapturedStep'] > 0
    else:
        with pytest.raises(RuntimeError, match='holds 0 dequant and 0 '
                           'augment kernel'):
            sup(state, x, y, 1.0)
        assert tally == {'graphs': 0, 'dequant_nodes': 0,
                         'augment_nodes': 0, 'nccl_nodes': 0,
                         'collectives': 0, 'mesh_graphs': 0, 'kinds': {},
                         'capture_s': {}, 'dump_s': 0.0}


def _tiny_configs(monkeypatch, tmp_path):
    """Phase 41's configurations at batch 8 (the sweep's stand-in at 64 px
    with 18 labels, as phase 37's inputs)."""
    def small(image_size, y_dim):
        return tcfg.ModelConfig(
            image_size=image_size, z_dim=24 if y_dim == 18 else 8,
            y_dim=y_dim, enc_features=(8,) * (4 if image_size == 64 else 2),
            enc_hidden=16, dec_features=(16, 8, 8, 8)[:4 if image_size == 64
                                                      else 2])

    def train(sup, **kw):
        return tcfg.TrainConfig(perc_supervision=sup, classifier_mc_samples=4,
                                **kw)
    monkeypatch.setattr(chip_smoke, 'BATCH', B)
    monkeypatch.setattr(chip_smoke, 'SWEEP_BATCH', B)
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    monkeypatch.setattr(tcfg, 'default_celeba64', lambda sup, **kw: (
        small(16, 4), train(sup, **kw)))
    # the 128 px model's stand-in at 16 px (the phase sets bf16 and s2d)
    monkeypatch.setattr(tcfg, 'celeba128', lambda sup, **kw: (
        small(16, 4), train(sup, **kw)))
    monkeypatch.setattr(tcfg, 'dp_sweep', lambda: [(
        'tiny', dataclasses.replace(small(64, 18), compute_dtype='bfloat16'),
        train(0.2, batch_size=B))])


def test_dispatch_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys,
                                             counted):
    """Phase 41 whole at batch 8: (a) eval and ELBO captured bit-equal to
    eager for both models, stochastic and deterministic, one dequant
    launch a batch; (b) the chunks, resident chunks and single captured
    steps bit-equal to eager, 16 launches each; (c) the augmented legs
    bit-equal with 8, 8 and 2 augment launches; (d) both Trainer runs
    equal both ways; (e) 5 x 3 speed lines, 1 for the bench twin's large
    resident pass and 2 meter lines."""
    _tiny_configs(monkeypatch, tmp_path)
    aug = preprocess._augment

    def counted_augment(*a, **k):       # where the card would launch
        preprocess.augment_launches += 1
        return aug(*a, **k)
    monkeypatch.setattr(preprocess, '_augment', counted_augment)
    monkeypatch.setattr(preprocess, 'augment_launches', 0)
    monkeypatch.setattr(chip_smoke, 'EVAL_SPLIT', 2 * B)
    monkeypatch.setattr(chip_smoke, 'SPEED_EVAL_IMAGES', 8 * B)
    monkeypatch.setattr(chip_smoke, 'DISPATCH_UNITS', 2)
    monkeypatch.setattr(chip_smoke, 'DISPATCH_PROFILED', 1)
    monkeypatch.setattr(chip_smoke, 'BENCH_EVAL_BATCHES', 3)
    out = chip_smoke.dispatch_phase(CPU, 'cpu')
    # (a) per model and mode: 2 rounds of (2 splits x 2 batches x eval
    # and ELBO + 4 stacked batches x eval and ELBO)
    assert out['eval'] == {f'{m}_{d}': 32 for m in ('64', '128')
                           for d in ('stochastic', 'det')}
    assert out['chunks'] == {'64': 16, '128': 16}
    assert out['augment'] == {'eager': 8, 'steps': 8, 'chunks': 2}
    assert out['trainer'] == (22, 22)
    assert out['trainer_augment'] == ((4, 6), (4, 6))
    assert len(out['speed']) == 18
    printed = capsys.readouterr().out
    assert printed.count('[phase 41]') == 4 + 2 + 1 + 1 + 1
    assert printed.count('graphs_speed: ') == 18
    assert 'not bit-equal' not in printed


def test_eval_legs_catch_a_draw_out_of_order(monkeypatch):
    """A captured ELBO pass whose host part drew the batches' Gumbels in
    another order than the eager pass: (a) finds the values and the eval
    generator's state unequal."""
    from gltvae_torch.train import steps as ts
    model_cfg, train_cfg = configs()
    monkeypatch.setattr(chip_smoke, 'BATCH', B)
    draw = ts.draw_noise

    def swapped(model, b, supervised, k, gen, out=None):
        noise = draw(model, b, supervised, k, gen, out=out)
        noise['g1'], noise['g2'] = noise['g2'], noise['g1']
        return noise
    monkeypatch.setattr(ts, 'draw_noise', swapped)
    splits = chip_smoke.eval_splits(model_cfg, CPU, rows=2 * B)
    res = chip_smoke.eval_legs(model_cfg, train_cfg, mu_init(), splits, CPU)
    assert not res['equal'] and res['gap'] > 0
