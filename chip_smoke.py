#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gltvae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:
1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build every CUDA kernel of the port from csrc/ (one nvcc per source);
3. each kernel against its plain torch version on the card, bit for bit,
   at the main path's shape, a ragged size and an unaligned base pointer;
4. kernel timing with CUDA events beside its bound, the plain version and
   one PyTorch call computing the same function;
5. the main path: the Trainer trains the full-width CelebA-64 gated CCVAE
   (z=45, y=18, learnable/inferred, k=100, f32, batch 256) at sup 0.5 for
   2 epochs on synthetic data, then tests; launch counts prove the path
   went through the kernels;
6. one sup and one unsup step on the card and on the CPU from the same
   state and noise must agree.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Run artifacts go to build/chip_smoke/.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

BATCH = 256
# Peak device-memory rate by card (NVIDIA data sheets), bytes/s.
MEM_RATE = (('H100 PCIe', 2.0e12), ('H100 NVL', 3.9e12), ('H200', 4.8e12),
            ('H100', 3.35e12))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def phase(n, text):
    print(f'[phase {n}] {text}', flush=True)


def cuda_ms(fn, reps, warmup=10):
    """(device ms, host ms) per call of fn() on the current stream.

    The device time is taken with CUDA events while a sleep kernel holds
    the stream, so the host enqueues all `reps` calls before the first
    runs: the events then see the calls back to back, without the host's
    launch overhead between them. The host time is the wall time per call
    of the enqueue loop (what a caller that waits on nothing pays)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device time
    ev[1].record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    check(host_ms < ev[0].elapsed_time(ev[1]),
          'the sleep kernel ended before the host enqueued every call')
    return ev[1].elapsed_time(ev[2]) / reps, host_ms / reps


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script only runs on a GPU',
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gltvae_torch
    check(os.path.dirname(os.path.abspath(gltvae_torch.__file__))
          == os.path.join(ROOT, 'gltvae_torch'),
          f'gltvae_torch imported from outside this checkout: '
          f'{gltvae_torch.__file__}')
    from gltvae_torch.config import apply_precision, default_celeba64
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops import _build, preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import draw_noise, make_train_steps

    # ------------------------------------------------------------- 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    rate = next((r for name, r in MEM_RATE if name in kind), 3.35e12)
    phase(1, f'torch {torch.__version__} cuda {torch.version.cuda} '
             f'device {kind!r} x{count}; memory rate for bounds '
             f'{rate / 1e12:.2f} TB/s')
    print(smi, flush=True)
    dev = torch.device('cuda', 0)

    # ------------------------------------------------------------- 2
    build_s = _build.build_all()
    phase(2, f'built {list(_build.KERNEL_SOURCES)} in {build_s:.1f} s')
    for name in _build.KERNEL_SOURCES:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {name}: {line.strip()}')

    # ------------------------------------------------------------- 3
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 64, 64, 3)
    n_main = math.prod(shape)
    buf = torch.randint(0, 256, (n_main + 64,), dtype=torch.uint8,
                        device=dev, generator=gen)
    cases = {
        'bs256': buf[:n_main].view(shape),
        'ragged': buf[:3 * 5 * 7 * 3].view(3, 5, 7, 3),            # %16 = 11
        'unaligned': buf[1:1 + 5 * 33 * 17 * 3].view(5, 33, 17, 3),
        'all_bytes': torch.arange(256, dtype=torch.uint8,
                                  device=dev).view(1, 16, 16, 1),
    }
    check(cases['unaligned'].data_ptr() % 16 != 0, 'unaligned case aligned')
    max_err = 0.0
    for label, u8 in cases.items():
        for mode in ('div', 'mul'):
            got = preprocess.dequant(u8, mode)
            want = preprocess.dequant_reference(u8, mode)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f'dequant {mode} {label}: kernel != plain (max {err})')
            check(torch.equal(got.cpu(), preprocess.dequant_reference(
                u8.cpu(), mode)), f'dequant {mode} {label}: card != CPU')
    ab = cases['all_bytes']
    lib_vs_div = int((ab.float() / 255.0 != preprocess.dequant(ab)).sum())
    lib_vs_mul = int((ab.float() / 255.0
                      != preprocess.dequant(ab, 'mul')).sum())
    phase(3, f'dequant div+mul bit-equal to plain on {list(cases)} '
             f'(max_abs_err {max_err}); u8.float()/255.0 on the card '
             f'differs from the divide form on {lib_vs_div} byte values '
             f'and from the multiply form on {lib_vs_mul}')

    # ------------------------------------------------------------- 4
    # 16 distinct inputs (50 MB) cycled so that the 50 MB L2 holds no
    # input between launches, as in a train step that gets a fresh batch
    ins = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=gen) for _ in range(16)]
    it = {'i': 0}

    def nxt():
        it['i'] = (it['i'] + 1) % len(ins)
        return ins[it['i']]

    launches0 = preprocess.launches
    kernel_ms, kernel_call_ms = cuda_ms(lambda: preprocess.dequant(nxt()),
                                        100)
    timing_launches = preprocess.launches - launches0
    plain_ms, plain_call_ms = cuda_ms(
        lambda: preprocess.dequant_reference(nxt()), 100)
    library_ms, library_call_ms = cuda_ms(lambda: nxt().float() / 255.0,
                                          100)
    warm_ms, _ = cuda_ms(lambda: preprocess.dequant(ins[0]), 100)
    bytes_moved = n_main * (1 + 4)
    bound_ms = bytes_moved / rate * 1e3
    phase(4, 'timed dequant at (256, 64, 64, 3): device ms per call '
             '(host ms per call)')
    print(f'kernels dequant: kernel_ms {kernel_ms:.5f} ({kernel_call_ms:.5f})'
          f' L2-warm {warm_ms:.5f}; plain_ms {plain_ms:.5f} '
          f'({plain_call_ms:.5f}); library_ms {library_ms:.5f} '
          f'({library_call_ms:.5f}); bound_ms {bound_ms:.5f} '
          f'({bytes_moved} B at {rate / 1e12:.2f} TB/s, '
          f'{bound_ms / kernel_ms:.1%} of it); {timing_launches} timing '
          f'launches; card {smi}', flush=True)

    # ------------------------------------------------------------- 5
    model_cfg, train_cfg = default_celeba64(sup=0.5, n_epochs=2,
                                            batch_size=BATCH)
    splits = synthetic_splits(n_train=2048, n_valid=512, n_test=512,
                              sup_frac=0.5, learnable_signal=True)
    mu = cooccurrence_gating_matrix(splits['sup'].labels)
    loaders = {k: BatchLoader(v, BATCH, seed=0) for k, v in splits.items()}
    run_dir = os.path.join(ROOT, 'build', 'chip_smoke')
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu,
                      checkpoint_dir=os.path.join(run_dir, 'checkpoints'),
                      metrics_path=os.path.join(run_dir, 'metrics.csv'),
                      device=dev)
    p0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    temp0 = trainer.gating_temp
    step_s = []

    def timed(step):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out
        return run
    trainer._sup_step = timed(trainer._sup_step)
    trainer._unsup_step = timed(trainer._unsup_step)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    preprocess.launches = 0                         # the main path starts
    t0 = time.perf_counter()
    result = trainer.train(loaders, param_dir=run_dir, log_every=1)
    test_acc = trainer.test(loaders['test'])
    torch.cuda.synchronize()
    main_launches = preprocess.launches             # ... and ends
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    steps = trainer.state.step
    eval_batches = 2 * loaders['valid'].epoch_batches \
        + loaders['test'].epoch_batches
    check(steps == 16, f'expected 16 train steps, ran {steps}')
    check(main_launches == steps + eval_batches == 22,
          f'dequant launches {main_launches} != {steps} steps + '
          f'{eval_batches} eval batches')
    rows = trainer.metrics.rows
    check(len(rows) == steps and all(
        math.isfinite(r[k]) for r in rows
        for k in ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'c_sum')),
        'a train loss or metric is not finite')
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, p0[k])]
    check(len(moved) == len(p0), f'params that did not move: '
          f'{sorted(set(p0) - set(moved))}')
    check('mu' in moved, 'mu did not move')
    check(abs(trainer.gating_temp - temp0 * 0.99 ** 2) < 1e-12,
          f'temperature {trainer.gating_temp} != {temp0} * 0.99^2')
    check(0.0 <= test_acc <= 1.0 and math.isfinite(test_acc),
          f'test accuracy {test_acc}')
    step_med = statistics.median(step_s[1:])
    phase(5, f'trained {steps} steps (2 epochs, sup 0.5, bs {BATCH}) + '
             f'{eval_batches} eval batches in {wall:.2f} s; dequant '
             f'launches {main_launches}; best val acc '
             f'{result["best_val_accuracy"]:.4f}, test acc {test_acc:.4f}')
    print(f'slice: step_ms median {step_med * 1e3:.3f} (steps 2-{steps}, '
          f'synchronized; first {step_s[0] * 1e3:.1f}), '
          f'{BATCH / step_med:.0f} img/s, trainer meter '
          f'{result["images_per_sec"]:.0f} img/s, peak memory '
          f'{peak / 2**20:.1f} MiB; card {smi}', flush=True)

    # ------------------------------------------------------------- 6
    # An Adam step moves a parameter by lr·m/(√v+ε); for a gradient near
    # ε/√(1-β₂) ≈ 3e-6 that ratio is ill-conditioned, and the float noise of
    # a cancelling f32 gradient sum (cuDNN and the CPU reduce in different
    # orders) can move such a parameter by a fraction of lr.
    lr = train_cfg.lr
    apply_precision(model_cfg)
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    cpu_model = init_model(model_cfg, train_cfg, mu)
    g = torch.Generator().manual_seed(1)
    noise = [draw_noise(cpu_model, BATCH, True, 100, g),
             draw_noise(cpu_model, BATCH, False, 100, g)]
    batches = [(splits['sup'].images[:BATCH], splits['sup'].labels[:BATCH]),
               (splits['unsup'].images[:BATCH],
                splits['unsup'].labels[:BATCH])]

    def two_steps(device):
        model = init_model(model_cfg, train_cfg, mu, device)
        state = create_train_state(model, train_cfg)
        sup, unsup = make_train_steps(model, train_cfg)
        mets = []
        for fn, (x, y), nz in zip((sup, unsup), batches, noise):
            state, m = fn(state, torch.from_numpy(x).to(device),
                          torch.from_numpy(y).to(device), 1.0,
                          noise={k: v.to(device) for k, v in nz.items()})
            mets.append({k: float(v) for k, v in m.items()})
        return mets, {k: v.cpu() for k, v in model.state_dict().items()}, \
            {k: v.cpu() for k, v in state.adam_m.items()}

    launches0 = preprocess.launches
    gpu_m, gpu_p, gpu_adam = two_steps(dev)
    check(preprocess.launches == launches0 + 2, 'card steps did not launch')
    cpu_m, cpu_p, cpu_adam = two_steps(torch.device('cpu'))
    metric_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                     for a, b in zip(gpu_m, cpu_m) for k in a)
    p_diff = {k: float((gpu_p[k] - cpu_p[k]).abs().max()) for k in cpu_p}
    m_rel = {k: float((gpu_adam[k] - cpu_adam[k]).abs().max())
             / max(float(cpu_adam[k].abs().max()), 1e-30) for k in cpu_adam}
    n_far = sum(int(((gpu_p[k] - cpu_p[k]).abs() > 1e-3 * lr).sum())
                for k in cpu_p)
    n_par = sum(v.numel() for v in cpu_p.values())
    worst = lambda d: ', '.join(f'{k} {d[k]:.2e}' for k in
                                sorted(d, key=d.get, reverse=True)[:3])
    phase(6, f'card vs CPU, sup+unsup step at B={BATCH}, same state and '
             f'noise: metrics max rel {metric_rel:.3e} (tol 1e-4); params '
             f'max abs {max(p_diff.values()):.3e} (tol {0.25 * lr:.1e} = '
             f'lr/4), {n_far} of {n_par} elements off by > lr/1000; Adam m '
             f'max abs / leaf max {max(m_rel.values()):.3e} (tol 1e-2)')
    print(f'  worst params: {worst(p_diff)}; worst Adam m: {worst(m_rel)}')
    check(metric_rel <= 1e-4, 'card and CPU metrics disagree')
    check(max(p_diff.values()) <= 0.25 * lr, 'card and CPU params disagree')
    check(max(m_rel.values()) <= 1e-2, 'card and CPU Adam moments disagree')

    # ------------------------------------------------------------- out
    record = {'kernels': [{
        'name': 'dequant',
        'route': 'cuda',
        'source': 'gltvae_torch/csrc/dequant.cu',
        'replaces': 'gltvae/ops/pallas/preprocess.py:52',
        'launches': main_launches,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'bytes',
        'library_ms': library_ms,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': kind,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
