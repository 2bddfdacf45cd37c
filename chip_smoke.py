#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gltvae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero with no result:
1. environment: the card (nvidia-smi name and power limit), torch, CUDA;
2. build every CUDA kernel of the port from csrc/ (one nvcc per source)
   and print ptxas's registers, shared memory and spills per kernel;
3. the dequant kernel against its plain torch version on the card and on
   the CPU, bit for bit, at the main path's shape, ragged sizes, sizes
   around whole 4 KB tiles (k*tile +- 1, one tile less one) and every
   unaligned base pointer (offsets 1..15);
4. dequant timing with CUDA events beside its bound, the plain version and
   one PyTorch call computing the same function (and, for information,
   u8.float(): one call moving the same bytes);
5. the main path: the Trainer trains the full-width CelebA-64 gated CCVAE
   (z=45, y=18, learnable/inferred, k=100, f32, batch 256) at sup 0.5 for
   2 epochs on synthetic data, then tests; launch counts prove the path
   went through the kernels;
6. one sup and one unsup step on the card and on the CPU from the same
   state and noise must agree;
7. the augment kernel (crop + flip + scale) against its plain version on
   the card and on the CPU, bit for bit: drawn, extreme and flip cases at
   the main path's shape, 128 px, one channel (also at 128 px), five
   channels, an odd batch at an unaligned base, the last image of the
   tensor cropped at dy = H - S at unaligned bases, source rows too wide
   for 48 KB of shared memory, and the stacked form against per-step
   launches;
8. augment timing at (256, 72, 72, 3) -> 64 and stacked (4, 256, ...),
   beside its byte bound and the plain version;
9. the augmented path: the Trainer trains the same model with
   augment_pad 4 and steps_per_dispatch 4 for 2 epochs, then tests;
   4 augment launches of 1,024 images and 6 dequant launches (eval only);
10. one augmented sup and one augmented unsup step, card vs CPU.

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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def phase(n, text):
    print(f'[phase {n}] {text}', flush=True)


def card_vs_cpu(n, label, model_cfg, train_cfg, mu, batches, dev,
                check_launches, draws=None):
    """One sup and one unsup step on the card and on the CPU must agree.

    Each step starts from the same state on both devices (the CPU's state
    before it, loaded on the card) and takes the same noise, drawn once on
    the CPU. With `draws`, the padded batches are first augmented with
    those (dy, dx, fl).

    Held to: metrics rel 1e-4; Adam m and v (the gradients), per leaf, max
    abs within 1e-2 of the leaf's largest value; and the card's params
    within lr/4 of the Keras Adam step of the card's own moments from the
    shared state. The card's params are not held to the CPU's: card and
    CPU reduce their f32 sums in different orders, and from zero moments
    Adam moves a parameter by lr·g/(|g| + 3e-6), close to lr·sign(g), so a
    gradient within rounding of zero moves it by up to lr either way on
    either device. Their largest gap is printed with the moments at that
    element. Returns the worst value of each measure."""
    import torch
    from gltvae_torch.ops import preprocess
    from gltvae_torch.train.state import (create_train_state, init_model,
                                          keras_alpha)
    from gltvae_torch.train.steps import draw_noise, make_train_steps
    lr, eps = train_cfg.lr, train_cfg.adam_eps
    runs = []
    for device in (dev, torch.device('cpu')):
        model = init_model(model_cfg, train_cfg, mu, device)
        runs.append((device, create_train_state(model, train_cfg),
                     make_train_steps(model, train_cfg)))
    g = torch.Generator().manual_seed(1)
    noise = [draw_noise(runs[1][1].model, BATCH, sup, 100, g)
             for sup in (True, False)]
    worst = {k: (0.0, '') for k in ('metrics', 'adam_m', 'adam_v',
                                    'adam_step', 'params')}

    def note(key, val, where):
        if val > worst[key][0]:
            worst[key] = (val, where)

    for i, ((x, y), nz) in enumerate(zip(batches, noise)):
        before = runs[1][1].state_dict()
        p0 = {k: v.clone() for k, v in before['params'].items()}
        runs[0][1].load_state_dict(before)
        out = []
        for device, state, steps in runs:
            xd = torch.from_numpy(x).to(device)
            if draws is not None:
                xd = preprocess.fused_augment_given(
                    xd, *(d[i].to(device) for d in draws),
                    model_cfg.image_size)
            _, m = steps[i](state, xd, torch.from_numpy(y).to(device), 1.0,
                            noise={k: v.to(device) for k, v in nz.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        state.state_dict()))
        (card_met, card), (cpu_met, cpu) = out
        step = ('sup', 'unsup')[i]
        for k in cpu_met:
            note('metrics', abs(card_met[k] - cpu_met[k])
                 / max(abs(cpu_met[k]), 1e-6), f'{step} {k}')
        for key in ('adam_m', 'adam_v'):
            for k, ref in cpu[key].items():
                note(key, float((card[key][k] - ref).abs().max())
                     / max(float(ref.abs().max()), 1e-30), f'{step} {k}')
        alpha = keras_alpha(card['adam_count'], lr)
        for k, p in p0.items():
            want, info = p, ''
            if k in card['adam_m']:           # a frozen μ has no moments
                want = p - alpha * card['adam_m'][k] / (
                    card['adam_v'][k].sqrt() + eps)
            note('adam_step', float((card['params'][k] - want).abs().max()),
                 f'{step} {k}')
            gap = (card['params'][k] - cpu['params'][k]).abs().flatten()
            j = int(gap.argmax())
            if k in card['adam_m']:
                mc, mp = (float(s['adam_m'][k].flatten()[j])
                          for s in (card, cpu))
                vc, vp = (float(s['adam_v'][k].flatten()[j]) ** 0.5
                          for s in (card, cpu))
                info = (f', m {mc:.2e} on the card, {mp:.2e} on the CPU, '
                        f'√v {vc:.2e} and {vp:.2e}')
            note('params', float(gap[j]), f'{step} {k}{info}')
    check_launches()
    phase(n, f'card vs CPU, {label} at B={BATCH}, each step from the same '
             f'state and noise: metrics max rel {worst["metrics"][0]:.3e} '
             f'(tol 1e-4); Adam max abs / leaf max m '
             f'{worst["adam_m"][0]:.3e}, v {worst["adam_v"][0]:.3e} (tol '
             f'1e-2); card params vs the Adam step of its moments max abs '
             f'{worst["adam_step"][0]:.3e} (tol {0.25 * lr:.1e} = lr/4)')
    print(f'  card vs CPU params max abs {worst["params"][0]:.3e} at '
          f'{worst["params"][1]}', flush=True)
    print('  worst at: ' + '; '.join(f'{k} {w}' for k, (_, w)
                                     in worst.items() if k != 'params'),
          flush=True)
    check(worst['metrics'][0] <= 1e-4, f'{label}: card and CPU metrics '
          'disagree')
    check(max(worst['adam_m'][0], worst['adam_v'][0]) <= 1e-2,
          f'{label}: card and CPU Adam moments disagree')
    check(worst['adam_step'][0] <= 0.25 * lr, f'{label}: card params are '
          'not the Adam step of its moments')
    return {k: v for k, (v, _) in worst.items()}


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
    from gltvae_torch.time_kernels import (augment_bound_ms, cuda_ms, cycler,
                                           dequant_bound_ms, memory_rate)
    from gltvae_torch.train.loop import Trainer

    # ------------------------------------------------------------- 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    rate = memory_rate(kind)
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
            if any(w in line for w in ('Compiling entry', 'registers',
                                       'spill')):
                print(f'  ptxas {name}: {line.strip()}')

    # ------------------------------------------------------------- 3
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 64, 64, 3)
    n_main = math.prod(shape)
    buf = torch.randint(0, 256, (n_main + 64,), dtype=torch.uint8,
                        device=dev, generator=gen)
    tile = preprocess.DEQUANT_TILE
    cases = {
        'bs256': buf[:n_main].view(shape),
        'ragged': buf[:3 * 5 * 7 * 3].view(3, 5, 7, 3),            # %16 = 11
        'unaligned': buf[1:1 + 5 * 33 * 17 * 3].view(5, 33, 17, 3),
        'all_bytes': torch.arange(256, dtype=torch.uint8,
                                  device=dev).view(1, 16, 16, 1),
    }
    for k in (1, 3):                    # whole tiles, one byte more or less
        cases[f'{k}tile-1'] = buf[:k * tile - 1]
        cases[f'{k}tile+1'] = buf[:k * tile + 1]
    for off in range(1, 16):            # every unaligned base: head + tiles
        cases[f'off{off}'] = buf[off:off + 2 * tile + 1]
    cases['off5_3tile-1'] = buf[5:5 + 3 * tile - 1]
    check(all(u8.data_ptr() % 16 != 0 for label, u8 in cases.items()
              if label.startswith(('unaligned', 'off'))),
          'unaligned case aligned')
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
    # phase 3's tensors must not count in the main path's peak memory
    # (phase 5)
    del cases, u8, got, want

    # ------------------------------------------------------------- 4
    # 16 distinct inputs (50 MB) cycled so that the 50 MB L2 holds no
    # input between launches, as in a train step that gets a fresh batch
    ins = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=gen) for _ in range(16)]
    nxt = cycler(ins)
    launches0 = preprocess.launches
    kernel_ms, kernel_call_ms = cuda_ms(lambda: preprocess.dequant(nxt()),
                                        100)
    timing_launches = preprocess.launches - launches0
    plain_ms, plain_call_ms = cuda_ms(
        lambda: preprocess.dequant_reference(nxt()), 100)
    library_ms, library_call_ms = cuda_ms(lambda: nxt().float() / 255.0,
                                          100)
    same_bytes_ms, _ = cuda_ms(lambda: nxt().float(), 100)
    warm_ms, _ = cuda_ms(lambda: preprocess.dequant(ins[0]), 100)
    bytes_moved = n_main * (1 + 4)
    bound_ms = dequant_bound_ms(n_main, rate)
    phase(4, 'timed dequant at (256, 64, 64, 3): device ms per call '
             '(host ms per call)')
    print(f'kernels dequant: kernel_ms {kernel_ms:.5f} ({kernel_call_ms:.5f})'
          f' L2-warm {warm_ms:.5f}; plain_ms {plain_ms:.5f} '
          f'({plain_call_ms:.5f}); library_ms {library_ms:.5f} '
          f'({library_call_ms:.5f}); bound_ms {bound_ms:.5f} '
          f'({bytes_moved} B at {rate / 1e12:.2f} TB/s, '
          f'{bound_ms / kernel_ms:.1%} of it); {timing_launches} timing '
          f'launches; card {smi}', flush=True)
    print(f'  information: u8.float() (one call, the same bytes, scale 1) '
          f'{same_bytes_ms:.5f} ms, {bound_ms / same_bytes_ms:.1%} of the '
          f'bound', flush=True)

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

    def synced(fn, times, shapes=None):
        """fn, timed between device synchronizations into `times` (and
        the shape of its result into `shapes`)."""
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if shapes is not None:
                shapes.append(tuple(out.shape))
            return out
        return run
    trainer._sup_step = synced(trainer._sup_step, step_s)
    trainer._unsup_step = synced(trainer._unsup_step, step_s)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    preprocess.launches = preprocess.augment_launches = 0   # path starts
    t0 = time.perf_counter()
    result = trainer.train(loaders, param_dir=run_dir, log_every=1)
    test_acc = trainer.test(loaders['test'])
    torch.cuda.synchronize()
    main_launches = preprocess.launches             # ... and ends
    check(preprocess.augment_launches == 0,
          'the unaugmented path launched the augment kernel')
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
    apply_precision(model_cfg)
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, 'TF32 is on')
    batches = [(splits['sup'].images[:BATCH], splits['sup'].labels[:BATCH]),
               (splits['unsup'].images[:BATCH],
                splits['unsup'].labels[:BATCH])]
    launches0 = preprocess.launches
    card_vs_cpu(6, 'sup+unsup step', model_cfg, train_cfg, mu, batches,
                dev, lambda: check(preprocess.launches == launches0 + 2,
                                   'card steps did not launch'))

    # ------------------------------------------------------------- 7
    P, S = 4, 64
    PS = S + 2 * P

    def aug_case(shape, size, how='drawn', base_off=0):
        """A u8 batch on the card (at a byte offset into its buffer) and
        its int32 (dy, dx, fl), drawn on the card, then set by `how`."""
        buf = torch.randint(0, 256, (math.prod(shape) + base_off,),
                            dtype=torch.uint8, device=dev, generator=gen)
        lead, (H, W) = shape[:-3], shape[-3:-1]
        dy, dx, fl = (v.view(lead) for v in preprocess.draw_crop_flip(
            gen, math.prod(lead), H, W, size))
        if how == 'origin':
            dy.zero_()
            dx.zero_()
        elif how == 'far':
            dy.fill_(H - size)
            dx.fill_(W - size)
        elif how in ('flip', 'no_flip'):
            fl.fill_(int(how == 'flip'))
        return buf[base_off:].view(shape), dy, dx, fl

    aug_cases = {
        'bs256': ((BATCH, PS, PS, 3), S, 'drawn', 0),
        'all_flip': ((BATCH, PS, PS, 3), S, 'flip', 0),
        'no_flip': ((BATCH, PS, PS, 3), S, 'no_flip', 0),
        'dy=dx=0': ((BATCH, PS, PS, 3), S, 'origin', 0),
        f'dy=dx={2 * P}': ((BATCH, PS, PS, 3), S, 'far', 0),
        f'dy=dx={2 * P}_unaligned': ((BATCH, PS, PS, 3), S, 'far', 5),
        '128px': ((2, 136, 136, 3), 128, 'drawn', 0),
        '128px_one_channel': ((2, 136, 136, 1), 128, 'drawn', 0),
        '128px_one_channel_far_unaligned': ((2, 136, 136, 1), 128, 'far',
                                            7),
        'one_channel': ((4, 20, 20, 1), 16, 'drawn', 0),
        'five_channels': ((3, 12, 11, 5), 8, 'drawn', 2),
        'odd_b_unaligned_scalar': ((5, 21, 19, 3), 15, 'drawn', 1),
        'last_far_unaligned_scalar': ((3, 21, 19, 3), 15, 'far', 3),
        'rows_over_48k': ((2, 20, 20000, 3), 16, 'drawn', 0),
        'stacked': ((4, BATCH, PS, PS, 3), S, 'drawn', 0),
    }
    aug_max_err = 0.0
    for label, (shape, size, how, off) in aug_cases.items():
        u8, dy, dx, fl = aug_case(shape, size, how, off)
        check((u8.data_ptr() % 16 != 0) == bool(off),
              f'augment {label}: base alignment not as meant')
        fn = (preprocess.fused_augment_stacked_given if u8.dim() == 5
              else preprocess.fused_augment_given)
        got = fn(u8, dy, dx, fl, size)
        want = preprocess.augment_reference(u8, dy, dx, fl, size)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        aug_max_err = max(aug_max_err, err)
        check(torch.equal(got, want),
              f'augment {label}: kernel != plain (max {err})')
        check(torch.equal(got.cpu(), preprocess.augment_reference(
            u8.cpu(), dy.cpu(), dx.cpu(), fl.cpu(), size)),
            f'augment {label}: card != CPU')
        if u8.dim() == 5:
            per_step = torch.stack([preprocess.fused_augment_given(
                u8[i], dy[i], dx[i], fl[i], size) for i in range(len(u8))])
            check(torch.equal(got, per_step),
                  f'augment {label}: stacked != per-step launches')
    phase(7, f'augment bit-equal to plain on the card and the CPU on '
             f'{list(aug_cases)} (max_abs_err {aug_max_err}); stacked == '
             f'per-step launches')

    # ------------------------------------------------------------- 8
    # 16 distinct padded batches (64 MB; stacked: 4 of 4 x 16 MB) cycled so
    # that L2 holds no input between launches; offsets drawn beforehand
    def aug_inputs(lead, count):
        B = math.prod(lead)
        return [(torch.randint(0, 256, (*lead, PS, PS, 3), dtype=torch.uint8,
                               device=dev, generator=gen),
                 *(v.view(lead) for v in preprocess.draw_crop_flip(
                     gen, B, PS, PS, S))) for _ in range(count)]

    step_in = cycler(aug_inputs((BATCH,), 16))
    stack_in = cycler(aug_inputs((4, BATCH), 4))
    launches0 = preprocess.augment_launches
    aug_ms, aug_call_ms = cuda_ms(
        lambda: preprocess.fused_augment_given(*step_in(), S), 100)
    # the plain version is ~18 launches a call: 30 calls fill the queue
    # half way
    aug_plain_ms, aug_plain_call_ms = cuda_ms(
        lambda: preprocess.augment_reference(*step_in(), S), 30)
    stk_ms, stk_call_ms = cuda_ms(
        lambda: preprocess.fused_augment_stacked_given(*stack_in(), S), 50)
    stk_plain_ms, _ = cuda_ms(
        lambda: preprocess.augment_reference(*stack_in(), S), 30)
    aug_timing_launches = preprocess.augment_launches - launches0
    # information only, not a library call: the fewest torch calls that
    # compute the same function (index gather, .float(), * scale)
    idx = []
    for u8, dy, dx, fl in [step_in() for _ in range(16)]:
        ar = torch.arange(S, device=dev)
        rows = (dy[:, None] + ar)[:, :, None]
        cols = (dx[:, None] + torch.where(fl[:, None] > 0, S - 1 - ar,
                                          ar))[:, None, :]
        idx.append((u8, torch.arange(BATCH, device=dev)[:, None, None],
                    rows, cols))
    scale_t = torch.full((), 1.0 / 255.0, device=dev)
    idx_in = cycler(idx)

    def composed():
        u8, b, r, c = idx_in()
        return u8[b, r, c].float() * scale_t
    comp_ms, _ = cuda_ms(composed, 100)
    step_bound = augment_bound_ms(BATCH, S, 3, rate)
    stk_bound = augment_bound_ms(4 * BATCH, S, 3, rate)
    phase(8, f'timed augment at ({BATCH}, {PS}, {PS}, 3) -> {S} and '
             f'stacked (4, {BATCH}, ...): device ms per call (host ms per '
             f'call)')
    print(f'kernels augment: per-step kernel_ms {aug_ms:.5f} '
          f'({aug_call_ms:.5f}), plain_ms {aug_plain_ms:.5f} '
          f'({aug_plain_call_ms:.5f}), bound_ms {step_bound:.5f} '
          f'({step_bound / aug_ms:.1%} of it); stacked n=4 kernel_ms '
          f'{stk_ms:.5f} ({stk_call_ms:.5f}), plain_ms {stk_plain_ms:.5f}, '
          f'bound_ms {stk_bound:.5f} ({stk_bound / stk_ms:.1%} of it); '
          f'library_ms null (no single torch call crops, flips and scales '
          f'per image); {aug_timing_launches} timing launches; card {smi}',
          flush=True)
    print(f'  information: index gather + .float() + * scale (3 calls) '
          f'{comp_ms:.5f} ms per step batch', flush=True)

    # ------------------------------------------------------------- 9
    model_a, train_a = default_celeba64(sup=0.5, n_epochs=2,
                                        batch_size=BATCH, augment_pad=P)
    splits_a = synthetic_splits(n_train=2048, n_valid=512, n_test=512,
                                sup_frac=0.5, learnable_signal=True,
                                train_pad=P)
    mu_a = cooccurrence_gating_matrix(splits_a['sup'].labels)
    loaders_a = {k: BatchLoader(v, BATCH, seed=0)
                 for k, v in splits_a.items()}
    run_a = os.path.join(ROOT, 'build', 'chip_smoke_augment')
    shutil.rmtree(run_a, ignore_errors=True)
    trainer_a = Trainer(model_a, train_a, mu_init=mu_a,
                        checkpoint_dir=os.path.join(run_a, 'checkpoints'),
                        metrics_path=os.path.join(run_a, 'metrics.csv'),
                        steps_per_dispatch=4, device=dev)
    p0 = {k: v.clone() for k, v in trainer_a.model.state_dict().items()}
    temp0 = trainer_a.gating_temp
    aug_s, chunk_s, aug_shapes = [], [], []
    trainer_a._augment = synced(trainer_a._augment, aug_s, aug_shapes)
    trainer_a._chunk_step = synced(trainer_a._chunk_step, chunk_s)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    preprocess.launches = preprocess.augment_launches = 0   # path starts
    t0 = time.perf_counter()
    result_a = trainer_a.train(loaders_a, param_dir=run_a, log_every=1)
    test_acc_a = trainer_a.test(loaders_a['test'])
    torch.cuda.synchronize()
    aug_launches = preprocess.augment_launches      # ... and ends
    aug_path_dequant = preprocess.launches
    wall_a = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated(dev)

    steps_a = trainer_a.state.step
    eval_a = 2 * loaders_a['valid'].epoch_batches \
        + loaders_a['test'].epoch_batches
    check(steps_a == 16, f'augmented: expected 16 train steps, ran {steps_a}')
    check(aug_launches == 4 and aug_shapes == [(4, BATCH, S, S, 3)] * 4,
          f'augmented: {aug_launches} augment launches of {aug_shapes}, '
          f'expected 4 of 4 x {BATCH} images')
    check(aug_path_dequant == eval_a == 6,
          f'augmented: dequant launches {aug_path_dequant} != {eval_a} '
          f'eval batches')
    rows_a = trainer_a.metrics.rows
    check(len(rows_a) == steps_a and all(
        math.isfinite(r[k]) for r in rows_a
        for k in ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'c_sum')),
        'augmented: a train loss or metric is not finite')
    moved = [k for k, v in trainer_a.model.state_dict().items()
             if not torch.equal(v, p0[k])]
    check(len(moved) == len(p0), f'augmented: params that did not move: '
          f'{sorted(set(p0) - set(moved))}')
    check('mu' in moved, 'augmented: mu did not move')
    check(abs(trainer_a.gating_temp - temp0 * 0.99 ** 2) < 1e-12,
          f'augmented: temperature {trainer_a.gating_temp} != '
          f'{temp0} * 0.99^2')
    check(0.0 <= test_acc_a <= 1.0 and math.isfinite(test_acc_a),
          f'augmented: test accuracy {test_acc_a}')
    chunk_med = statistics.median(
        [a + c for a, c in zip(aug_s[1:], chunk_s[1:])])
    phase(9, f'augmented: trained {steps_a} steps (2 epochs, sup 0.5, bs '
             f'{BATCH}, augment_pad {P}, steps_per_dispatch 4) + {eval_a} '
             f'eval batches in {wall_a:.2f} s; augment launches '
             f'{aug_launches} of {aug_shapes[0][0] * aug_shapes[0][1]} '
             f'images, dequant launches {aug_path_dequant}; best val acc '
             f'{result_a["best_val_accuracy"]:.4f}, test acc '
             f'{test_acc_a:.4f}')
    print(f'slice_augment: chunk_ms median {chunk_med * 1e3:.3f} (chunks '
          f'2-{len(chunk_s)}, augment + 4 steps, synchronized; first '
          f'{(aug_s[0] + chunk_s[0]) * 1e3:.1f}), augment_ms median '
          f'{statistics.median(aug_s[1:]) * 1e3:.3f}, step_ms '
          f'{chunk_med / 4 * 1e3:.3f}, {4 * BATCH / chunk_med:.0f} img/s, '
          f'trainer meter {result_a["images_per_sec"]:.0f} img/s, peak '
          f'memory {peak_a / 2**20:.1f} MiB; card {smi}', flush=True)

    # ------------------------------------------------------------- 10
    g = torch.Generator().manual_seed(2)
    draws = [torch.stack(v) for v in zip(*(
        preprocess.draw_crop_flip(g, BATCH, PS, PS, S) for _ in range(2)))]
    batches_a = [(splits_a[k].images[:BATCH], splits_a[k].labels[:BATCH])
                 for k in ('sup', 'unsup')]
    launches0 = (preprocess.launches, preprocess.augment_launches)
    card_vs_cpu(10, 'augmented sup+unsup step', model_a, train_a, mu_a,
                batches_a, dev, lambda: check(
                    (preprocess.launches, preprocess.augment_launches)
                    == (launches0[0], launches0[1] + 2),
                    'augmented card steps: expected 2 augment launches '
                    'and no dequant'), draws=draws)

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
    }, {
        'name': 'augment',
        'route': 'cuda',
        'source': 'gltvae_torch/csrc/augment.cu',
        'replaces': 'gltvae/ops/pallas/preprocess.py:198',
        'launches': aug_launches,
        'max_abs_err': aug_max_err,
        'ms': stk_ms,                   # the main path's stacked shape
        'plain_ms': stk_plain_ms,
        'bound_ms': stk_bound,
        'bound_by': 'bytes',
        'library_ms': None,             # no single torch call computes it
        # the per-step form (steps_per_dispatch 1, the default)
        'per_step_ms': aug_ms,
        'per_step_plain_ms': aug_plain_ms,
        'per_step_bound_ms': step_bound,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': kind,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
