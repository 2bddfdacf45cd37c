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
   2 epochs on synthetic data from device-resident splits (the Trainer's
   default), then tests; launch counts prove the path went through the
   kernels;
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
10. one augmented sup and one augmented unsup step, card vs CPU;
11. phase 5's run again, resident and with both splits shipped from the
    host: every u8 batch bit-equal, metrics within phase 6's tolerance,
    both step medians;
12. dequant bit-equal to its plain version at (256, 128, 128, 3) and
    (256, 218, 178, 3) (a partial last tile), timed beside its bound;
13. the 128 px path: celeba128 (z=100, y=40) at bf16 with input and
    output s2d, remat 'dots' and resident splits, sup 0.5, batch 256, 2
    epochs on synthetic 128 px data, then tests;
14. that model's sup and unsup steps, card vs CPU, with the batch gathered
    from a device-resident split: at f32 to phase 6's tolerances, at bf16
    to ``BF16_TOL``;
15. one sup step on a full-resolution (256, 218, 178, 3) u8 batch (the
    device resize to 64 px), card vs CPU;
16. a CelebA-shaped corpus written from the seed under
    build/chip_smoke_celeba/ (2,048/512/512 JPEGs of 218x178 at quality
    95, the 40-column attribute CSV, a partition CSV); CelebAReader's
    splits and its gating cache (.npy, .sha256, .csv, read back
    bit-equal);
17. the threaded BatchLoader (8 workers) bit-equal to the synchronous one
    over 2 epochs; a filled DiskCachedDataset serves rows bit-equal to a
    fresh decode without decoding; the decode rate of each backend found;
18. ``cli.main`` trains the CelebA-64 model from the files (split file,
    sup 0.5, bs 256, 2 epochs, resident): dequant launches 22;
19. the same with augment_pad 4 and steps_per_dispatch 4 (72x72 train
    decode, shipped): augment launches 4 of 1,024 images, dequant 6;
20. the library Trainer with DataConfig(device_resize=True), 1 epoch:
    full-resolution rows resident, 12 dequant launches at (256, 218, 178,
    3) then the resize; each flag that conflicts with device_resize raises
    first;
21. where g++ and jpeglib.h exist, the native decode pool builds and
    trains 1 epoch;
22. ``gltvae_torch.infer`` labels the 512 test images from phase 18's run
    folder on the card (2 dequant launches) and on the CPU: probabilities
    within 1e-4, a second card run writes the same CSV.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. Run artifacts go to build/chip_smoke*/.
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


#: phase 6's tolerances: metrics rel, Adam m and v (max abs / the leaf's
#: largest value), card params vs the Adam step of its moments (x lr)
F32_TOL = {'metrics': 1e-4, 'adam_m': 1e-2, 'adam_v': 1e-2,
           'adam_step': 0.25}


#: The bf16 step's tolerances, card vs CPU (phase 14). Measured on an
#: NVIDIA H100 80GB HBM3 (700 W, torch 2.11.0+cu128), celeba128 with both
#: s2d flags and remat 'dots', B=256: metrics 6.1e-6 rel; Adam m and v as
#: one vector 4.8e-3 and 2.4e-3 rel L2; single leaves up to 8.5e-2 (m) and
#: 5.0e-2 (v) of their largest value, so those are not held: cuDNN and the
#: CPU round different bf16 partial sums, and a bias gradient sums a whole
#: layer's bf16 cotangents. Held at about 16x (metrics) and 4x (moments)
#: those values. The f32 step of the same model is 2.1e-2 rel L2 from the
#: bf16 step's gradient on the CPU (tests/test_torch_bf16.py, 64 px);
#: tests/test_torch_chip_smoke.py plants a dropped bias, which this check
#: catches.
BF16_TOL = {'metrics': 1e-4, 'adam_m_l2': 2e-2, 'adam_v_l2': 1e-2,
            'adam_step': 0.25}


def card_vs_cpu(n, label, model_cfg, train_cfg, mu, batches, dev,
                check_launches, draws=None, kinds=(True, False),
                resident=False, tol=F32_TOL):
    """One step of each of `kinds` (True: sup) on the card and on the CPU
    must agree.

    Each step starts from the same state on both devices (the CPU's state
    before it, loaded on the card) and takes the same noise, drawn once on
    the CPU. With `draws`, the padded batches are first augmented with
    those (dy, dx, fl). With `resident`, each batch is first copied to the
    device as a split and the step's batch gathered from it by a drawn
    permutation of its rows, as resident training gathers.

    Held to `tol`: metrics rel; Adam m and v (the gradients), per leaf, max
    abs over the leaf's largest value, or, under 'adam_m_l2' and
    'adam_v_l2', as one vector's relative L2 distance; and the card's
    params within tol['adam_step'] * lr of the Keras Adam step of the
    card's own moments from the shared state. A key missing from `tol` is
    printed, not held. The card's params are not held to the CPU's: card
    and CPU reduce their sums in different orders, and from zero moments
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
    B = len(batches[0][0])
    noise = [draw_noise(runs[1][1].model, B, sup,
                        train_cfg.classifier_mc_samples, g) for sup in kinds]
    perms = [torch.randperm(B, generator=g) for _ in kinds]
    worst = {k: (0.0, '') for k in ('metrics', 'adam_m', 'adam_v',
                                    'adam_m_l2', 'adam_v_l2', 'adam_step',
                                    'params')}

    def note(key, val, where):
        if val > worst[key][0]:
            worst[key] = (val, where)

    for i, ((x, y), nz, sup) in enumerate(zip(batches, noise, kinds)):
        before = runs[1][1].state_dict()
        p0 = {k: v.clone() for k, v in before['params'].items()}
        runs[0][1].load_state_dict(before)
        out = []
        for device, state, steps in runs:
            xd = torch.from_numpy(x).to(device)
            yd = torch.from_numpy(y).to(device)
            if resident:
                idx = perms[i].to(device)
                xd, yd = xd.index_select(0, idx), yd.index_select(0, idx)
            if draws is not None:
                xd = preprocess.fused_augment_given(
                    xd, *(d[i].to(device) for d in draws),
                    model_cfg.image_size)
            _, m = steps[0 if sup else 1](
                state, xd, yd, 1.0,
                noise={k: v.to(device) for k, v in nz.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        state.state_dict()))
        (card_met, card), (cpu_met, cpu) = out
        step = 'sup' if sup else 'unsup'
        check(all(math.isfinite(v) for m in (card_met, cpu_met)
                  for v in m.values()), f'{label}: {step} metrics not finite')
        for k in cpu_met:
            note('metrics', abs(card_met[k] - cpu_met[k])
                 / max(abs(cpu_met[k]), 1e-6), f'{step} {k}')
        for key in ('adam_m', 'adam_v'):
            for k, ref in cpu[key].items():
                note(key, float((card[key][k] - ref).abs().max())
                     / max(float(ref.abs().max()), 1e-30), f'{step} {k}')
            got, ref = (torch.cat([d[key][k].flatten() for k in cpu[key]])
                        for d in (card, cpu))
            note(f'{key}_l2', float((got - ref).norm() / ref.norm()), step)
        alpha = keras_alpha(card['adam_count'], lr)
        for k, p in p0.items():
            want, info = p, ''
            if k in card['adam_m']:           # a frozen μ has no moments
                want = p - alpha * card['adam_m'][k] / (
                    card['adam_v'][k].sqrt() + eps)
            note('adam_step', float((card['params'][k] - want).abs().max())
                 / lr, f'{step} {k}')
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
    held = lambda k: (f'(tol {tol[k]:.1e})' if k in tol else '(not held)')
    phase(n, f'card vs CPU, {label} at B={B}, each step from the same '
             f'state and noise: metrics max rel {worst["metrics"][0]:.3e} '
             f'{held("metrics")}; Adam max abs / leaf max m '
             f'{worst["adam_m"][0]:.3e} {held("adam_m")}, v '
             f'{worst["adam_v"][0]:.3e} {held("adam_v")}; rel L2 m '
             f'{worst["adam_m_l2"][0]:.3e} {held("adam_m_l2")}, v '
             f'{worst["adam_v_l2"][0]:.3e} {held("adam_v_l2")}; card params '
             f'vs the Adam step of its moments max abs '
             f'{worst["adam_step"][0]:.3e} x lr {held("adam_step")}')
    print(f'  card vs CPU params max abs {worst["params"][0]:.3e} at '
          f'{worst["params"][1]}', flush=True)
    print('  worst at: ' + '; '.join(f'{k} {w}' for k, (_, w)
                                     in worst.items() if k != 'params'),
          flush=True)
    over = lambda keys: [k for k in keys if k in tol and worst[k][0] > tol[k]]
    check(not over(['metrics']), f'{label}: card and CPU metrics disagree')
    bad = over(['adam_m', 'adam_v', 'adam_m_l2', 'adam_v_l2'])
    check(not bad, f'{label}: card and CPU Adam moments disagree ({bad})')
    check(worst['adam_step'][0] <= tol['adam_step'],
          f'{label}: card params are not the Adam step of its moments')
    return {k: v for k, (v, _) in worst.items()}


def synced(fn, times, shapes=None):
    """fn, timed between device synchronizations into `times` (and the
    shape of its result into `shapes`)."""
    import torch

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


def train_and_test(label, model_cfg, train_cfg, splits, dev, run_name,
                   record=None, **trainer_kw):
    """Train 2 epochs through the Trainer and test, as a user would, with
    the kernels' launch counts set to 0 just before and read just after;
    then check the run: 16 steps, dequant launched once per train step and
    eval batch and augment never, finite metrics, every parameter moved,
    the temperature decayed twice, a test accuracy in [0, 1]. `record`
    gets a copy of every uint8 batch a step dequantizes. Returns what the
    run measured."""
    import torch
    import gltvae_torch.train.steps as tsteps
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    mu = cooccurrence_gating_matrix(splits['sup'].labels)
    loaders = {k: BatchLoader(v, BATCH, seed=0) for k, v in splits.items()}
    run_dir = os.path.join(ROOT, 'build', run_name)
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = Trainer(model_cfg, train_cfg, mu_init=mu,
                      checkpoint_dir=os.path.join(run_dir, 'checkpoints'),
                      metrics_path=os.path.join(run_dir, 'metrics.csv'),
                      device=dev, **trainer_kw)
    p0 = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    temp0 = trainer.gating_temp
    step_s = []
    # one dispatch is one step here (steps_per_dispatch 1), resident or not
    trainer._resident_chunk = synced(trainer._resident_chunk, step_s)
    trainer._sup_step = synced(trainer._sup_step, step_s)
    trainer._unsup_step = synced(trainer._unsup_step, step_s)
    prep = tsteps._prep_image
    if record is not None:
        tsteps._prep_image = lambda x, size: (
            record.append(x.clone()) if x.dtype == torch.uint8 else None,
            prep(x, size))[1]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        preprocess.launches = preprocess.augment_launches = 0  # path starts
        t0 = time.perf_counter()
        result = trainer.train(loaders, param_dir=run_dir, log_every=1)
        test_acc = trainer.test(loaders['test'])
        torch.cuda.synchronize()
        launches = preprocess.launches                      # ... and ends
        augment_launches = preprocess.augment_launches
        wall = time.perf_counter() - t0
    finally:
        tsteps._prep_image = prep
    peak = torch.cuda.max_memory_allocated(dev)
    steps = trainer.state.step
    eval_batches = 2 * loaders['valid'].epoch_batches \
        + loaders['test'].epoch_batches
    check(augment_launches == 0,
          f'{label}: the unaugmented path launched the augment kernel')
    check(steps == 16, f'{label}: expected 16 train steps, ran {steps}')
    check(launches == steps + eval_batches == 22,
          f'{label}: dequant launches {launches} != {steps} steps + '
          f'{eval_batches} eval batches')
    rows = trainer.metrics.rows
    check(len(rows) == steps and all(
        math.isfinite(r[k]) for r in rows
        for k in ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'c_sum')),
        f'{label}: a train loss or metric is not finite')
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, p0[k])]
    check(len(moved) == len(p0), f'{label}: params that did not move: '
          f'{sorted(set(p0) - set(moved))}')
    check(abs(trainer.gating_temp - temp0 * 0.99 ** 2) < 1e-12,
          f'{label}: temperature {trainer.gating_temp} != {temp0} * 0.99^2')
    check(0.0 <= test_acc <= 1.0 and math.isfinite(test_acc),
          f'{label}: test accuracy {test_acc}')
    resident = {k for k, ld in loaders.items()
                if id(ld) in trainer._resident_data}
    want = set(loaders) if trainer_kw.get('resident_train') != 'off' \
        else set()
    check(resident == want, f'{label}: resident splits {sorted(resident)}, '
          f'expected {sorted(want)}')
    return dict(trainer=trainer, result=result, test_acc=test_acc,
                steps=steps, eval_batches=eval_batches, launches=launches,
                wall=wall, peak=peak, step_s=step_s, rows=rows,
                resident=sorted(resident))


#: phase 16's corpus: the synthetic path's split sizes, so the walls compare
CORPUS = (2048, 512, 512)


def sync(dev):
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def jpeg_toolchain():
    """(g++ path or None, jpeglib.h path or None): what the native decode
    pool needs to build."""
    inc = [os.path.join(d, 'jpeglib.h')
           for d in ('/usr/include', '/usr/local/include',
                     '/usr/include/x86_64-linux-gnu')]
    return shutil.which('g++'), next((p for p in inc if os.path.exists(p)),
                                     None)


def patched(obj, name, wrap):
    """Replace obj.name with wrap(obj.name); returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


def recorder(log):
    """A wrapper factory: each call's (positional arguments, seconds) goes
    to `log`."""
    def wrap(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            log.append((a, time.perf_counter() - t))
            return out
        return run
    return wrap


def celeba_phases(dev, smi):
    """Phases 16-22: CelebA-shaped JPEG files through the port's data layer,
    its CLI, the device resize, the native pool and batch inference.
    Returns the kernels' launches on these paths."""
    import csv
    import numpy as np
    import torch
    import gltvae_torch.data.celeba as tc
    import gltvae_torch.train.steps as tsteps
    from gltvae_torch import cli, infer
    from gltvae_torch.config import DataConfig, default_celeba64
    from gltvae_torch.data import native_loader
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.data.synthetic import write_celeba_corpus
    from gltvae_torch.ops import preprocess
    from gltvae_torch.train.loop import Trainer
    n_train, n_valid, n_test = CORPUS
    build = os.path.join(ROOT, 'build')
    out = {}

    # ------------------------------------------------------------- 16
    backends = []
    for name, mod in (('pil', 'PIL.Image'), ('cv2', 'cv2')):
        try:
            __import__(mod)
            backends.append(name)
        except ImportError:
            pass
    gxx, jpeglib = jpeg_toolchain()
    phase(16, f'JPEG codecs: {backends or "none"}; native pool toolchain: '
              f'g++ {gxx}, jpeglib.h {jpeglib}')
    check('pil' in backends, 'PIL is needed to write the JPEG corpus')
    corpus = os.path.join(build, 'chip_smoke_celeba')
    shutil.rmtree(corpus, ignore_errors=True)
    t0 = time.perf_counter()
    made = write_celeba_corpus(corpus, n_train, n_valid, n_test, seed=0,
                               quality=95)
    corpus_s = time.perf_counter() - t0
    split = dict(split_file='list_eval_partition.csv')
    cfg = DataConfig(data_dir=corpus, num_workers=8, **split)
    reader = tc.CelebAReader(cfg, 0.5, BATCH)
    sizes = {m: len(s) for m, s in reader.splits.items()}
    check(sizes == {'train': n_train, 'valid': n_valid, 'test': n_test,
                    'sup': n_train // 2, 'unsup': n_train // 2},
          f'reader splits {sizes}')
    stem = os.path.join(corpus, 'gating_matrix_0.5')
    check(all(os.path.exists(stem + e) for e in ('.npy', '.npy.sha256',
                                                 '.csv')),
          'the gating cache wrote no .npy, .sha256 or .csv')
    npy = open(stem + '.npy', 'rb').read()
    again = tc.CelebAReader(cfg, 0.5, BATCH).init_gating_prob
    check(again.tobytes() == reader.init_gating_prob.tobytes()
          and open(stem + '.npy', 'rb').read() == npy,
          'a second reader did not read the gating cache back bit-equal')
    phase(16, f'corpus of {n_train}/{n_valid}/{n_test} 218x178 JPEGs (q95) '
              f'in {corpus_s:.2f} s (encode {made["encode_s"]:.2f} s); '
              f'reader splits {sizes}; gating cache .npy/.sha256/.csv, read '
              f'back bit-equal')

    # ------------------------------------------------------------- 17
    image_dir = os.path.join(corpus, 'img_align_celeba')
    auto = tc.resolve_backend('auto')
    loaders = {w: BatchLoader(tc.ImageFolderDataset(
        image_dir, reader.splits['sup'], 64, backend=auto), BATCH, seed=0,
        num_workers=w) for w in (0, 8)}
    batches, walls = {}, {}
    for w, ld in loaders.items():
        it = iter(ld)
        t0 = time.perf_counter()
        batches[w] = [next(it) for _ in range(2 * ld.epoch_batches)]
        walls[w] = time.perf_counter() - t0
        it.close()
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(batches[0], batches[8])),
          'threaded loader batches differ from the synchronous ones')
    n_loaded = sum(len(x) for x, _ in batches[8])
    del batches
    valid = reader.splits['valid']
    cache_dir = os.path.join(build, 'chip_smoke_cache')
    shutil.rmtree(cache_dir, ignore_errors=True)
    fresh = tc.ImageFolderDataset(image_dir, valid, 64, backend=auto)
    fill = tc.DiskCachedDataset(fresh, cache_dir, 'valid')
    for lo in range(0, len(valid), BATCH):
        fill.fetch(np.arange(lo, min(lo + BATCH, len(valid))))
    calls = []
    inner = tc.ImageFolderDataset(image_dir, valid, 64, backend=auto)
    inner.fetch = lambda idxs: calls.append(len(idxs))
    served = tc.DiskCachedDataset(inner, cache_dir, 'valid')
    idx = np.random.RandomState(0).permutation(len(valid))
    check(fill.complete and served.complete, 'disk cache not complete')
    check(np.array_equal(served.fetch(idx)[0], fresh.fetch(idx)[0])
          and not calls, 'disk cache rows differ from a fresh decode or '
          'called the decoder')
    rates = {}
    idx = np.arange(len(valid))
    for b in backends:
        for res, kw in (('64px', {}), ('full', dict(host_resize=False))):
            ds = tc.ImageFolderDataset(image_dir, valid, 64, backend=b, **kw)
            t0 = time.perf_counter()
            ds.fetch(idx)
            rates[f'{b} {res} 1 thread'] = len(idx) / (time.perf_counter()
                                                       - t0)
    native_ok = gxx is not None and jpeglib is not None
    if native_ok:
        check(native_loader.is_available(), 'the native pool did not build')
        for threads in (1, 8):
            ds = native_loader.NativeImageFolderDataset(
                image_dir, valid, 64, num_threads=threads)
            t0 = time.perf_counter()
            ds.fetch(idx)
            rates[f'native 64px {threads} threads'] = len(idx) / (
                time.perf_counter() - t0)
    rates[f'{auto} 64px BatchLoader 8 workers'] = n_loaded / walls[8]
    phase(17, f'threaded BatchLoader (8 workers, {auto}) == synchronous on '
              f'{2 * loaders[8].epoch_batches} u8 batches of {BATCH} (2 '
              f'epochs), bit for bit; DiskCachedDataset complete, rows '
              f'bit-equal to a fresh decode with no decoder call')
    print('decode_rates: ' + '; '.join(f'{k} {v:.1f} img/s'
                                       for k, v in rates.items())
          + f'; card {smi}', flush=True)
    out['decode_rates'] = rates

    # ------------------------------------------------------------- 18
    def run_cli(run_name, *extra):
        """cli.main on the corpus with the counts set to 0 just before and
        read just after; step, fetch and augment calls recorded."""
        run_dir = os.path.join(build, run_name)
        shutil.rmtree(run_dir, ignore_errors=True)
        rec = {'steps': [], 'fetch': [], 'augment': [], 'shapes': []}

        def init(f):            # the chunk step is built per Trainer
            def run(self, *a, **kw):
                f(self, *a, **kw)
                if self._chunk_step is not None:
                    self._chunk_step = synced(self._chunk_step,
                                              rec['steps'])
            return run
        undo = [patched(Trainer, '__init__', init),
                patched(Trainer, '_resident_chunk',
                        lambda f: synced(f, rec['steps'])),
                patched(Trainer, '_augment',
                        lambda f: synced(f, rec['augment'], rec['shapes'])),
                patched(tc.ImageFolderDataset, 'fetch',
                        recorder(rec['fetch']))]
        held = 0
        try:
            sync(dev)
            if dev.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            preprocess.launches = preprocess.augment_launches = 0
            t0 = time.perf_counter()
            res = cli.main(['--data-dir', corpus, '--split-file',
                            'list_eval_partition.csv', '--do-train',
                            '--epochs', '2', '--sup', '0.5', '-bs',
                            str(BATCH), '--output-dir', run_dir,
                            '--device', str(dev), *extra])
            sync(dev)
            rec['launches'] = (preprocess.launches,
                               preprocess.augment_launches)
            rec['wall'] = time.perf_counter() - t0
        finally:
            for u in undo:
                u()
        # above what earlier phases still hold on the card
        rec['peak'] = (torch.cuda.max_memory_allocated(dev) - held
                       if dev.type == 'cuda' else 0)
        rec['dir'] = os.path.join(run_dir, 'params_0.5_learnable')
        with open(os.path.join(rec['dir'], 'result.json')) as f:
            rec['result'] = json.load(f)
        check(res[0.5] == rec['result']['test_accuracy']
              and math.isfinite(res[0.5]), f'{run_name}: test accuracy '
              f'{res[0.5]}')
        for name in ('metrics.csv', 'learned_gating_matrix_best.npy',
                     'learned_gating_matrix_best.csv', 'result.json',
                     'model_config.json'):
            check(os.path.exists(os.path.join(rec['dir'], name)),
                  f'{run_name}: {name} not written')
        return rec

    r18 = run_cli('chip_smoke_celeba_run')
    whole = [(len(a[1]), s) for a, s in r18['fetch'] if len(a[1]) > 1]
    check(sorted(n for n, _ in whole) == sorted(
        [n_train // 2, n_train // 2, n_valid, n_test]),
        f'resident splits decoded as {sorted(n for n, _ in whole)}, '
        f'expected each split once')
    check(r18['launches'] == (22, 0), f'CelebA-64 from files: dequant, '
          f'augment launches {r18["launches"]}, expected (22, 0)')
    hist = r18['result']['history']
    step_med = statistics.median(r18['steps'][1:])
    phase(18, f'cli.main from {n_train} JPEGs (split file, sup 0.5, bs '
              f'{BATCH}, 2 epochs, f32, resident): dequant launches '
              f'{r18["launches"][0]}, augment {r18["launches"][1]}; '
              f'metrics.csv, mu export, result.json, model_config.json '
              f'written; best val acc '
              f'{r18["result"]["best_val_accuracy"]:.4f}, test acc '
              f'{r18["result"]["test_accuracy"]:.4f}')
    print(f'slice_celeba: step_ms median {step_med * 1e3:.3f} (steps 2-16, '
          f'synchronized; first {r18["steps"][0] * 1e3:.1f}), '
          f'{BATCH / step_med:.0f} img/s, trainer meter '
          f'{r18["result"]["images_per_sec"]:.0f} img/s; epoch walls '
          f'{hist[0]["epoch_time"]:.3f} s / {hist[1]["epoch_time"]:.3f} s; '
          f'whole-split decode ({auto}, 1 thread) '
          f'{sum(s for _, s in whole):.3f} s for {sum(n for n, _ in whole)} '
          f'images; cli wall {r18["wall"]:.2f} s; peak memory '
          f'{r18["peak"] / 2**20:.1f} MiB above the start; card {smi}',
          flush=True)
    out['celeba'] = r18['launches']

    # ------------------------------------------------------------- 19
    r19 = run_cli('chip_smoke_celeba_augment', '--augment-pad', '4',
                  '--steps-per-dispatch', '4')
    shapes = r19['shapes']
    check(r19['launches'] == (6, 4)
          and shapes == [(4, BATCH, 64, 64, 3)] * 4,
          f'augmented from files: dequant, augment launches '
          f'{r19["launches"]} of {shapes}, expected (6, 4) of 4 x {BATCH}')
    sizes = sorted(len(a[1]) for a, _ in r19['fetch'])
    check(sizes.count(BATCH) >= 16 and [n for n in sizes if n > BATCH]
          == sorted([n_valid, n_test]), f'augmented: fetches of {sizes} '
          f'rows; expected >= 16 shipped train batches and the eval splits '
          f'once each')
    chunk_med = statistics.median(
        [a + c for a, c in zip(r19['augment'][1:], r19['steps'][1:])])
    hist = r19['result']['history']
    phase(19, f'augmented from files (augment_pad 4 -> 72x72 train decode, '
              f'steps_per_dispatch 4): augment launches {r19["launches"][1]} '
              f'of {shapes[0][0] * shapes[0][1]} images, dequant launches '
              f'{r19["launches"][0]}; test acc '
              f'{r19["result"]["test_accuracy"]:.4f}')
    print(f'slice_celeba_augment: chunk_ms median {chunk_med * 1e3:.3f} '
          f'(augment + 4 steps, chunks 2-4), {4 * BATCH / chunk_med:.0f} '
          f'img/s, trainer meter {r19["result"]["images_per_sec"]:.0f} '
          f'img/s; epoch walls {hist[0]["epoch_time"]:.3f} s / '
          f'{hist[1]["epoch_time"]:.3f} s; cli wall {r19["wall"]:.2f} s; '
          f'peak memory {r19["peak"] / 2**20:.1f} MiB above the start; '
          f'card {smi}', flush=True)
    out['celeba_augment'] = r19['launches']

    # ------------------------------------------------------------- 20
    base = dict(data_dir=corpus, num_workers=8, **split)
    conflicts = {'cache_dir': dict(cache_dir=cache_dir),
                 'cache_decoded': dict(cache_decoded=True),
                 'native': dict(decode_backend='native'),
                 'augment_pad': dict(augment_pad=4)}
    preprocess.launches = 0
    for name, kw in conflicts.items():
        try:
            tc.CelebAReader(DataConfig(device_resize=True, **base, **kw),
                            0.5, BATCH).setup_data_loaders()
        except ValueError:
            continue
        check(False, f'device_resize with {name} did not raise')
    check(preprocess.launches == 0, 'a refused configuration launched')
    model_cfg, train_cfg = default_celeba64(sup=0.5, n_epochs=1,
                                            batch_size=BATCH)
    dr_backend = 'cv2' if 'cv2' in backends else 'pil'
    rd = tc.CelebAReader(DataConfig(device_resize=True,
                                    decode_backend=dr_backend, **base),
                         0.5, BATCH)
    trainer = Trainer(model_cfg, train_cfg, mu_init=rd.init_gating_prob,
                      device=dev)
    dr_loaders = rd.setup_data_loaders()
    seen, resized = [], []
    undo = [patched(tsteps, 'dequant', lambda f: lambda x, *a: (
                seen.append(tuple(x.shape)), f(x, *a))[1]),
            patched(tsteps, 'resize_bilinear', lambda f: lambda x, *a: (
                resized.append(tuple(x.shape)), f(x, *a))[1])]
    try:
        sync(dev)
        preprocess.launches = preprocess.augment_launches = 0
        t0 = time.perf_counter()
        result = trainer.train(dr_loaders)
        acc = trainer.test(dr_loaders['test'])
        sync(dev)
        dr_launches = (preprocess.launches, preprocess.augment_launches)
        dr_wall = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    full = (BATCH, 218, 178, 3)
    check(set(dr_loaders) == {k for k, ld in dr_loaders.items()
                              if id(ld) in trainer._resident_data},
          'device resize: a split did not go resident')
    check(dr_launches == (12, 0) and seen == [full] * 12
          and resized == [(BATCH, 218, 178, 3)] * 12,
          f'device resize: launches {dr_launches}, dequant shapes {seen}, '
          f'resize inputs {resized}; expected 12 (8 steps, 2 valid, 2 '
          f'test) at {full}')
    check(math.isfinite(acc), f'device resize: test accuracy {acc}')
    phase(20, f'device resize from files ({dr_backend}, full-resolution '
              f'rows resident): dequant launches {dr_launches[0]} at '
              f'{full} then the bilinear resize, in {dr_wall:.2f} s; val '
              f'acc {result["best_val_accuracy"]:.4f}, test acc {acc:.4f}; '
              f'device_resize with {list(conflicts)} each raised before any '
              f'launch')
    out['device_resize'] = dr_launches
    del trainer, dr_loaders

    # ------------------------------------------------------------- 21
    if native_ok:
        r21 = run_cli('chip_smoke_celeba_native', '--decode-backend',
                      'native', '--epochs', '1')
        check(r21['launches'] == (12, 0) and not r21['fetch'],
              f'native: launches {r21["launches"]}, '
              f'{len(r21["fetch"])} cv2/PIL fetches')
        phase(21, f'native pool built ({native_loader.LIB_PATH}) and '
                  f'trained 1 epoch: dequant launches {r21["launches"][0]}')
    else:
        phase(21, f'skipped: the native pool needs g++ and jpeglib.h (g++ '
                  f'{gxx}, jpeglib.h {jpeglib})')

    # ------------------------------------------------------------- 22
    test_dir = os.path.join(build, 'chip_smoke_celeba_test')
    shutil.rmtree(test_dir, ignore_errors=True)
    os.makedirs(test_dir)
    for name in reader.splits['test'].ids:
        os.symlink(os.path.join(image_dir, name),
                   os.path.join(test_dir, name))

    def run_infer(device, tag):
        probs = []
        path = os.path.join(build, f'chip_smoke_infer_{tag}.csv')
        undo = patched(infer, 'write_rows', lambda f: lambda w, n, p: (
            probs.append(p), f(w, n, p))[1])
        try:
            sync(dev)
            preprocess.launches = 0
            t0 = time.perf_counter()
            infer.main(['--checkpoint', r18['dir'], '--images', test_dir,
                        '--output', path, '--batch-size', str(BATCH),
                        '--num-workers', '8',
                        '--device', str(device)])
            sync(dev)
            wall = time.perf_counter() - t0
        finally:
            undo()
        with open(path, newline='') as f:
            rows = list(csv.reader(f))
        return dict(launches=preprocess.launches, wall=wall, rows=rows,
                    probs=np.concatenate(probs), bytes=open(path, 'rb').read())

    card = run_infer(dev, 'card')
    cpu = run_infer(torch.device('cpu'), 'cpu')
    card2 = run_infer(dev, 'card2')
    check(card['launches'] == 2, f'inference: {card["launches"]} dequant '
          f'launches on the card, expected 2')
    check(len(card['rows']) == n_test + 1 and len(card['probs']) == n_test,
          f'inference CSV has {len(card["rows"]) - 1} rows')
    gap = float(np.abs(card['probs'] - cpu['probs']).max())
    sure = np.abs(cpu['probs'] - 0.5) > 1e-4
    y = card['probs'].shape[1]
    hard = [np.array([r[1:1 + y] for r in d['rows'][1:]], int)
            for d in (card, cpu)]
    check(gap <= 1e-4 and np.array_equal(hard[0][sure], hard[1][sure]),
          f'inference card vs CPU: probabilities max abs {gap:.3e} (tol '
          f'1e-4) or hard labels differ')
    check(card2['bytes'] == card['bytes'], 'a second card run gave another '
          'CSV')
    phase(22, f'python -m gltvae_torch.infer on the phase-18 run over '
              f'{n_test} test images: dequant launches {card["launches"]}; '
              f'card vs CPU probabilities max abs {gap:.3e} (tol 1e-4), '
              f'hard labels equal where |p - 0.5| > 1e-4; a second card '
              f'run wrote the same CSV')
    print(f'slice_infer: card {n_test / card["wall"]:.1f} img/s, again '
          f'{n_test / card2["wall"]:.1f} img/s, CPU '
          f'{n_test / cpu["wall"]:.1f} img/s (decode, 8 threads, '
          f'included); card {smi}', flush=True)
    out['infer'] = card['launches']
    return out


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
    import dataclasses

    import numpy as np
    from gltvae_torch.config import (apply_precision, celeba128,
                                     default_celeba64)
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
    card_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    rate = memory_rate(card_name)
    phase(1, f'torch {torch.__version__} cuda {torch.version.cuda} '
             f'device {card_name!r} x{count}; memory rate for bounds '
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
    main_run = train_and_test('main path', model_cfg, train_cfg, splits,
                              dev, 'chip_smoke')
    main_launches = main_run['launches']
    step_med = statistics.median(main_run['step_s'][1:])
    phase(5, f'trained {main_run["steps"]} steps (2 epochs, sup 0.5, bs '
             f'{BATCH}, resident {"+".join(main_run["resident"])}) + '
             f'{main_run["eval_batches"]} eval batches in '
             f'{main_run["wall"]:.2f} s; dequant launches {main_launches}; '
             f'best val acc {main_run["result"]["best_val_accuracy"]:.4f}, '
             f'test acc {main_run["test_acc"]:.4f}')
    print(f'slice: step_ms median {step_med * 1e3:.3f} (steps 2-16, '
          f'synchronized; first {main_run["step_s"][0] * 1e3:.1f}), '
          f'{BATCH / step_med:.0f} img/s, trainer meter '
          f'{main_run["result"]["images_per_sec"]:.0f} img/s, peak memory '
          f'{main_run["peak"] / 2**20:.1f} MiB; card {smi}', flush=True)
    del main_run

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

    # ------------------------------------------------------------- 11
    # the same run with both splits shipped from the host: the same bytes
    # must reach every step and eval batch
    recs, runs = {}, {}
    for how, kw in (('resident', {}), ('shipped', dict(
            resident_train='off', resident_eval='off'))):
        recs[how] = []
        runs[how] = train_and_test(f'{how} run', model_cfg, train_cfg,
                                   splits, dev, f'chip_smoke_{how}',
                                   record=recs[how], **kw)
    check(len(recs['resident']) == len(recs['shipped']) == 22,
          f'recorded {len(recs["resident"])} resident and '
          f'{len(recs["shipped"])} shipped batches, expected 22 each')
    differ = [i for i, (a, b) in enumerate(zip(recs['resident'],
                                               recs['shipped']))
              if not torch.equal(a, b)]
    check(not differ, f'resident batches {differ} differ from the shipped '
          'ones')
    del recs
    keys = ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'log_qy_x',
            'c_sum')
    met_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                  for a, b in zip(runs['resident']['rows'],
                                  runs['shipped']['rows']) for k in keys)
    sd = [r['trainer'].model.state_dict() for r in runs.values()]
    param_gap = max(float((sd[0][k] - sd[1][k]).abs().max()) for k in sd[0])
    med = {k: statistics.median(r['step_s'][1:]) for k, r in runs.items()}
    phase(11, f'resident vs shipped, 2 epochs each from one seed: 22 u8 '
              f'batches (16 steps + 6 eval) bit-equal; metrics of all 16 '
              f'steps max rel {met_rel:.3e} (tol 1e-4); params max abs '
              f'{param_gap:.3e} (not held)')
    print(f'slice: resident step_ms median {med["resident"] * 1e3:.3f}, '
          f'shipped step_ms median {med["shipped"] * 1e3:.3f} (steps 2-16, '
          f'synchronized, each step also copies its u8 batch for the '
          f'comparison); peak memory {runs["resident"]["peak"] / 2**20:.1f}'
          f' / {runs["shipped"]["peak"] / 2**20:.1f} MiB; card {smi}',
          flush=True)
    check(met_rel <= 1e-4, 'resident and shipped metrics disagree')
    del runs, sd

    # ------------------------------------------------------------- 12
    dq_shapes = []
    for shp in ((BATCH, 128, 128, 3), (BATCH, 218, 178, 3)):
        n = math.prod(shp)
        batches_u8 = [torch.randint(0, 256, shp, dtype=torch.uint8,
                                    device=dev, generator=gen)
                      for _ in range(3)]
        u8 = batches_u8[0]
        plan = preprocess.dequant_plan(u8.data_ptr(), 0, n)
        for mode in ('div', 'mul'):
            got = preprocess.dequant(u8, mode)
            check(torch.equal(got, preprocess.dequant_reference(u8, mode)),
                  f'dequant {mode} {shp}: kernel != plain')
            check(torch.equal(got.cpu(), preprocess.dequant_reference(
                u8.cpu(), mode)), f'dequant {mode} {shp}: card != CPU')
        del got
        nxt = cycler(batches_u8)
        ms, call_ms = cuda_ms(lambda: preprocess.dequant(nxt()), 50)
        plain, _ = cuda_ms(lambda: preprocess.dequant_reference(nxt()), 30)
        lib, _ = cuda_ms(lambda: nxt().float() / 255.0, 30)
        bound = dequant_bound_ms(n, rate)
        dq_shapes.append({'shape': list(shp), 'ms': ms, 'plain_ms': plain,
                          'library_ms': lib, 'bound_ms': bound})
        print(f'kernels dequant {shp}: kernel_ms {ms:.5f} ({call_ms:.5f}); '
              f'plain_ms {plain:.5f}; library_ms {lib:.5f}; bound_ms '
              f'{bound:.5f} ({n * 5} B at {rate / 1e12:.2f} TB/s, '
              f'{bound / ms:.1%} of it); plan {plan.tiles} tiles + '
              f'{plan.tail} B tail; card {smi}', flush=True)
        del batches_u8, u8, nxt
    check(dq_shapes[1]['shape'][1:3] == [218, 178]
          and math.prod(dq_shapes[1]['shape']) % preprocess.DEQUANT_TILE,
          'the 218x178 batch is a whole number of tiles')
    phase(12, 'dequant div+mul bit-equal to plain on the card and the CPU '
              f'at {[tuple(d["shape"]) for d in dq_shapes]} (the second '
              'ends in a partial tile); timed above')

    # ------------------------------------------------------------- 13
    model_128, train_128 = celeba128(sup=0.5, n_epochs=2, batch_size=BATCH,
                                     remat='dots')
    model_128 = dataclasses.replace(model_128, compute_dtype='bfloat16',
                                    input_s2d=True, output_s2d=True)
    splits_128 = synthetic_splits(n_train=2048, n_valid=512, n_test=512,
                                  sup_frac=0.5, image_size=128, y_dim=40,
                                  learnable_signal=True)
    run_128 = train_and_test('128 px path', model_128, train_128, splits_128,
                             dev, 'chip_smoke_128')
    launches_128 = run_128['launches']
    med_128 = statistics.median(run_128['step_s'][1:])
    phase(13, f'celeba128 (z 100, y 40), bf16, input+output s2d, remat '
              f'dots, resident {"+".join(run_128["resident"])}: trained '
              f'{run_128["steps"]} steps (2 epochs, sup 0.5, bs {BATCH}) + '
              f'{run_128["eval_batches"]} eval batches in '
              f'{run_128["wall"]:.2f} s; dequant launches {launches_128}; '
              f'best val acc {run_128["result"]["best_val_accuracy"]:.4f}, '
              f'test acc {run_128["test_acc"]:.4f}')
    print(f'slice_128: step_ms median {med_128 * 1e3:.3f} (steps 2-16, '
          f'synchronized; first {run_128["step_s"][0] * 1e3:.1f}), '
          f'{BATCH / med_128:.0f} img/s, trainer meter '
          f'{run_128["result"]["images_per_sec"]:.0f} img/s, dequant '
          f'launches {launches_128}, peak memory '
          f'{run_128["peak"] / 2**20:.1f} MiB; card {smi}', flush=True)
    del run_128

    # ------------------------------------------------------------- 14
    mu_128 = cooccurrence_gating_matrix(splits_128['sup'].labels)
    batches_128 = [(splits_128[k].images[:BATCH],
                    splits_128[k].labels[:BATCH]) for k in ('sup', 'unsup')]
    for label, cfg, tol in (
            ('128 px f32 + s2d + remat dots + resident gather',
             dataclasses.replace(model_128, compute_dtype='float32'),
             F32_TOL),
            ('128 px bf16 + s2d + remat dots + resident gather', model_128,
             BF16_TOL)):
        launches0 = preprocess.launches
        card_vs_cpu(14, label, cfg, train_128, mu_128, batches_128, dev,
                    lambda: check(preprocess.launches == launches0 + 2,
                                  f'{label}: card steps did not launch'),
                    resident=True, tol=tol)

    # ------------------------------------------------------------- 15
    full_res = np.random.RandomState(3).randint(
        0, 256, (BATCH, 218, 178, 3), dtype=np.uint8)
    launches0 = preprocess.launches
    card_vs_cpu(15, 'device-resize sup step, (256, 218, 178, 3) u8 -> '
                    '64 px', model_cfg, train_cfg, mu,
                [(full_res, splits['sup'].labels[:BATCH])], dev,
                lambda: check(preprocess.launches == launches0 + 1,
                              'device-resize step: expected one dequant '
                              'launch'), kinds=(True,))

    # ---------------------------------------------------------- 16-22
    celeba = celeba_phases(dev, smi)

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
        # the 128 px path's launches (phase 13) and dequant at the new
        # paths' shapes (phase 12)
        'launches_128': launches_128,
        'shapes': dq_shapes,
        # phases 18-22: CelebA-64 from files, the augmented path from
        # files (eval only), the device resize, inference
        'launches_celeba': celeba['celeba'][0],
        'launches_celeba_augment': celeba['celeba_augment'][0],
        'launches_device_resize': celeba['device_resize'][0],
        'launches_infer': celeba['infer'],
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
        'launches_celeba_augment': celeba['celeba_augment'][1],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': card_name,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
