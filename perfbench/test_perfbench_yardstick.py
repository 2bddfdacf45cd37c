"""The yardstick's own arithmetic and the benchmark's description: FLOP
counts against hand counts at small shapes, the peaks and the dequant
bytes, the per-layer readers on made-up records, and BENCHMARK.json
against the rules its checker applies."""

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import flops  # noqa: E402
import harness as H  # noqa: E402
import roofline  # noqa: E402

TINY = {'image_size': 16, 'channels': 3, 'z_dim': 5, 'y_dim': 2,
        'enc_features': [4, 8], 'enc_hidden': 6, 'dec_features': [8, 4],
        'dec_hidden': None}


def test_layer_flops_by_hand():
    # 16 -> 8: 2*64*3*4*16; 8 -> 4: 2*16*4*8*16; 4x4 valid: 2*8*6*16;
    # heads 2*2*6*5; fc1 2*5*5; 1 -> 4: 2*5*8*16; 4 -> 8: 2*16*8*4*16;
    # 8 -> 16: 2*64*4*3*16
    want = [24576, 16384, 1536, 120, 50, 1280, 16384, 24576]
    assert [f for _, f in flops.layers(TINY)] == want


def test_step_flops_by_hand():
    fwd = 24576 + 16384 + 1536 + 120 + 50 + 1280 + 16384 + 24576
    heads_unsup = 2 * 4 * 1 + 4 * 2 * 4
    heads_sup = 2 * 4 * (2 + 10) + 4 * 2 * 4
    assert flops.train_step(TINY, 3, False, 10) == \
        3 * (3 * (fwd + heads_unsup) - 24576)
    assert flops.train_step(TINY, 3, True, 10) == \
        3 * (3 * (fwd + heads_sup) - 24576)
    assert flops.eval_image(TINY) == 24576 + 16384 + 1536 + 120 + 8


def test_s2d_and_remat_do_not_change_the_count():
    a = dict(TINY, input_s2d=True, output_s2d=True)
    assert flops.train_step(a, 4, True, 3) == flops.train_step(TINY, 4,
                                                               True, 3)


def test_celeba64_step():
    m = H.load_cell('c64.train').model
    assert flops.train_step(m, 256, True, 100) / 1e9 == \
        pytest.approx(30.834, abs=1e-3)


def test_peaks_and_dequant_bytes():
    assert roofline.peak_flops('float32') == 67e12
    assert roofline.peak_flops('bfloat16') == 989e12
    n = 256 * 64 * 64 * 3
    # the float32 written; the uint8 read comes back from L2
    assert roofline.dequant_bytes(n) == 4 * n
    assert roofline.dequant_floor_s(n) == pytest.approx(4 * n / 3.35e12)


def _reader(name):
    return H.load_module(os.path.join(HERE, 'metrics', f'{name}.py'),
                         'm_' + name.replace('.', '_'))


def _train_rec(**kw):
    m = H.load_cell('c64.train')
    rec = {'kind': 'train', 'model': m.model, 'train': m.train, 'chips': 1,
           'window_s': 10.0, 'steps': {'sup': 1000, 'unsup': 3000},
           'images': 4000 * 256, 'eval_batches': 78, 'complete': True,
           'traces': [{'window_ns': 10**9, 'busy_ns': 8 * 10**8,
                       'h2d_ns': 5 * 10**6, 'nccl_ns': 0, 'launches': 1800,
                       'steps': 100, 'validation': False,
                       'dequant_ns': [6000] * 100,
                       'dequant_elements': 100 * 256 * 64 * 64 * 3}]}
    rec.update(kw)
    return rec


def test_readers_on_a_made_up_record():
    rec = _train_rec()
    mfu = _reader('mfu.train').read(rec)
    work = 1000 * flops.train_step(rec['model'], 256, True, 100) + \
        3000 * flops.train_step(rec['model'], 256, False, 100)
    assert mfu == pytest.approx(100 * work / (10.0 * 67e12))
    assert _reader('device_idle_pct.train').read(rec) == pytest.approx(20.0)
    assert _reader('host_launches_per_step.train').read(rec) == 18.0
    assert _reader('h2d_ms_per_step.train').read(rec) == pytest.approx(0.05)
    # 4 B an element at 3.35 TB/s: 3.756 us of the 6 us a launch took
    assert _reader('dequant_roofline').read(rec) == pytest.approx(
        100 * 4 * 256 * 64 * 64 * 3 / 3.35e12 / 6e-6)
    assert _reader('mfu.eval').read(rec) is None


def test_dequant_elements_count_each_launch_as_it_ran():
    """A traced segment's train steps at the images the meter counted,
    a validation pass at its batches, each rank its share."""
    from types import SimpleNamespace
    from session import TrainSession
    cell = H.load_cell('c64.train')
    px = 64 * 64 * 3
    one = SimpleNamespace(mesh=None, batch=256, cell=cell,
                          eval_batches=lambda: 78)
    assert TrainSession.dequant_elements(one, 128 * 256, False) == \
        128 * 256 * px
    assert TrainSession.dequant_elements(one, 40 * 256, True) == \
        (40 + 78) * 256 * px
    four = SimpleNamespace(mesh=SimpleNamespace(world=4), batch=4096,
                           cell=cell, eval_batches=lambda: 5)
    assert TrainSession.dequant_elements(four, 40 * 4096, True) == \
        (40 + 5) * 1024 * px


@pytest.mark.parametrize('name', ['device_idle_pct.train', 'dequant_roofline'])
def test_a_trace_that_missed_kernels_reads_nothing(name):
    assert _reader(name).read(_train_rec(complete=False, chips=4)) is None


NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_benchmark_json_keeps_the_rules():
    b = json.load(open(os.path.join(H.ROOT, 'BENCHMARK.json')))
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['perfbench']
    assert 1 <= b['run_seconds'] <= 51
    cfgs = {c['name']: c for c in b['configs']}
    cells = {w['name']: w for w in b['workloads']}
    metrics = b['end_to_end'] + b['per_layer']
    for n in list(cfgs) + list(cells) + [m['name'] for m in metrics]:
        assert NAME.match(n), n
    assert len({m['name'] for m in metrics}) == len(metrics)
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        f = json.load(open(os.path.join(H.ROOT, c['file'])))
        assert f['name'] == c['name'] and f['reduced'] == c['reduced']
        assert any(w['config'] == c['name'] for w in b['workloads'])
    four = sum(w['chips'] == 4 for w in b['workloads'])
    assert four <= max(1, len(cells) // 4)
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in cfgs and w['chips'] in (1, 4)
        assert 1 <= len(w['why']) <= 200
        assert os.path.exists(os.path.join(HERE, 'workloads',
                                           f'{w["traffic"]}.json'))
    e2e = {m['name']: m for m in b['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in b['end_to_end']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in b['per_layer']:
        assert UNIT.match(m['unit']) and m['moves'] in e2e
        assert os.path.exists(os.path.join(HERE, 'metrics',
                                           f'{m["name"]}.py'))
        for c in m['workloads']:
            assert c in e2e[m['moves']].get('workloads', cells), (m, c)
    for c in cells:
        mine = [m for m in b['end_to_end']
                if c in m.get('workloads', cells)]
        assert 'setup_s' in [m['name'] for m in mine] and len(mine) >= 2
        assert H.per_layer_names(c, [m['name'] for m in mine]), c
    assert len(json.dumps(b)) < 64 * 1024
