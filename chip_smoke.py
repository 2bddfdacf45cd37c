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
    within 1e-4, a second card run writes the same CSV;
23. the latent traversal of phase 18's model, every latent dim (45 x 8
    images) from z = 0 and the render CLI's z_classify grid from the prior
    anchor, card vs CPU within 1e-5, each timed; the render CLI's PNG;
24. where h5py exists: ``export_h5`` of phase 18's run, ``infer`` from the
    .h5 folder (2 dequant launches, phase 22's CSV byte for byte), and
    ``cli --init-from-h5`` test-only (the checkpoint's params bit for bit,
    2 dequant launches);
25. ``export_serving --with-reconstruct``; the reloaded program within
    1e-5 of ``predict_probs`` at b = 256 and 7, the reconstruct program's
    shape; program and eager rates at b = 256;
26. ``preprocess_batch`` at (256, 64, 64, 3) and (256, 128, 128, 3) with
    mean/std and a flip mask: card bit-equal to the CPU, one multiply-form
    dequant launch a call;
27. ``cli.main`` on the synthetic path for 2 epochs, once plain and once
    with ``--tensorboard DIR --debug-nans``: the same dequant launches,
    the event file's tags, steps and values equal to metrics.csv's rows as
    f32, both step medians; then one step with a NaN encoder weight under
    the flag must raise FloatingPointError naming an aten op;
28. ``cli.main --decode-backend grain`` from phase 16's corpus for 1 epoch
    (the port's own permutation): dequant launches, the epoch wall, each
    loader's first epoch a permutation of its split;
29. ``python -m gltvae_torch.bench`` at reduced sizes (10 chunks of 4
    steps, eval over 2,048 images, e2e over 512 JPEGs): its JSON line
    (printed as ``bench: ...``) with every key bench.py fills set;
30. a mesh of one rank over NCCL (``parallel.mesh.initialize_multihost``
    with a TCP coordinator and one process): phase 5's run through
    ``Trainer(mesh=)`` equals phase 5's run without a mesh bit for bit
    (params, Adam moments, every metric row) with its 22 dequant
    launches, both on cuDNN's deterministic algorithms (the default ones
    do not repeat a run bit for bit);
31. two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU), spawned with a file:// store under build/chip_smoke_dp/, each
    running phase 5's resident path and phase 9's augmented path
    (augment_pad 4, steps_per_dispatch 4) at global batch 256 (128 a rank)
    for 2 epochs: 22 dequant launches a rank on the first, 4 augment
    launches of 512 images and 6 dequant on the second; both kernels
    bit-equal to their plain versions at the ranks' shapes; each rank's
    crops bit-equal to its rows of the one-process run's; the ranks' states
    equal; every metric row within 1e-4 rel of the one-process run; then
    one sup and one unsup step from one state on 2 ranks vs 1 process:
    metrics rel 1e-5, params rtol 2e-4 atol 1e-6, each element outside
    that within lr/4 of the Adam step of its rank's own moments (the rule
    of phases 6 and 10), Adam moments 2e-4 of their leaf's largest value;
32. the gating and metrics tools on phase 18's run and corpus:
    ``gen_gating_matrix`` (18 and 40 labels; its .npy bit-equal to
    ``ops/gating.py``'s matrix, its .csv to ``save_labeled_csv``'s bytes),
    ``analyze_gating``, ``metrics_summary --gating-history``, and
    ``--plot``, which writes its PNG or raises ImportError without
    matplotlib;
33. the Table-1 matrix: ``repro_reference``'s 9 cells (``cell_argvs``,
    ``cli.main``) on phase 16's corpus, 1 epoch each at the tool's bf16,
    with the split file and one shared ``--cache-dir``: dequant launches
    steps + 4 eval batches per cell, the accuracy JSON beside
    BASELINE_TABLE1 and the seconds per cell;
34. ``parity_corpus`` (350 images, the same bytes written twice) and
    ``seed_panel`` for 1 seed x relu/linear posterior locs, 1 epoch each,
    through ``python -m gltvae_torch.cli`` subprocesses on the card;
35. ``bench_data --device-resize``: every row on the card's host, the
    ship+step rows (one host->device copy a step, 64 px and 218x178 with
    the device resize) 2 x 21 dequant launches;
36. ``profile_step``'s four modes at bs 256 (train-step, train-scan of 8,
    eval-resident and eval-chunked over 4,096 images): device ms,
    launches and top kernels per dispatch, the summary JSON under
    build/chip_smoke_profile/;
37. ``config.dp_sweep()[0]`` (bf16, global batch 4096) in one process: a
    sup and an unsup step timed, profiled and their peak memory, 6 dequant
    launches at (4096, 64, 64, 3), dequant timed there beside its bound;
    then with 2 or more cards, min(cards, 4) NCCL ranks spawned one a
    card (1024 rows each) and as many gloo ranks sharing cuda:0, all on
    cuDNN's deterministic algorithms: dequant bit-equal to plain at their
    shape; one sup and one unsup step from one state at bf16 and f32,
    NCCL against gloo by phase 31's rules (the same per-rank arithmetic)
    and against the one process by metrics 1e-4 rel, the Adam moments'
    rel L2 (1e-3 at f32, BF16_TOL at bf16) and the Adam-step rule (the
    4096-row and 1024-row steps sum in different orders); a 5,099-row
    eval resident (the row exchange) and shipped, equal on every rank and
    in both legs, within 1e-3 of the one process, through
    all_gather_into_tensor on NCCL. On one card it says that NCCL across
    cards did not run and runs nothing in its place;
38. ``parity_head2head`` on the 2,100-image parity corpus (seed 0, written
    under build/chip_smoke_h2h/), learnable/inferred sup=0.2 for 12 epochs
    at bs 64, its reference leg the recorded one
    (docs/artifacts/h2h_results.json, reused through --skip-reference),
    its port leg ``cli.main`` in this process on the card: the harness's
    files and tags, result.json's device, 12 val accuracies and a finite
    test accuracy, dequant launches (steps + eval batches), every one at
    (64, 64, 64, 3) (the loaders wrap around, so the last eval batch is
    whole too), dequant bit-equal to plain there and timed beside its
    bound, and the learning floor (test accuracy at
    least the test split's majority-class accuracy + 0.03); the deltas
    against the recorded reference and gltvae legs, the verdict at tol
    0.06, the wall and the img/s are printed, not held.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. ``--sweep-only`` runs phases 1-2 and 37
alone (the check to run on four cards). ``--h2h-only`` runs phases 1-2,
then the recorded head-to-head matrix through the harness in one workdir
(9 cells at 12 epochs but fixed/one-one sup=1.0 at 30, and that cell at
12 epochs with training seeds 1-4), one line a cell, and ``--h2h-out DIR``
copies its results, report and walls to DIR. Run artifacts go to
build/chip_smoke*/.
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

    wait = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)

    def run(*a, **kw):
        wait()
        t = time.perf_counter()
        out = fn(*a, **kw)
        wait()
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
    cuda = dev.type == 'cuda'
    try:
        sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        preprocess.launches = preprocess.augment_launches = 0  # path starts
        t0 = time.perf_counter()
        result = trainer.train(loaders, param_dir=run_dir, log_every=1)
        test_acc = trainer.test(loaders['test'])
        sync(dev)
        launches = preprocess.launches                      # ... and ends
        augment_launches = preprocess.augment_launches
        wall = time.perf_counter() - t0
    finally:
        tsteps._prep_image = prep
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
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
    # what phases 23-26 take from these
    out.update(corpus=corpus, test_dir=test_dir, run_dir=r18['dir'],
               infer_csv=card['bytes'],
               test_acc=r18['result']['test_accuracy'])
    return out


def median_ms(fn, dev, warmup=3, calls=20):
    """Median synchronized wall of `calls` calls of fn after `warmup`."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        sync(dev)
        t = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def serving_phases(dev, smi, celeba):
    """Phases 23-26 on phase 18's run folder (the CelebA-64 model trained
    from files): the latent traversal, the .h5 interchange and warm start,
    the serving artifacts and preprocess_batch. Returns the dequant
    launches of the .h5 inference, the warm start and preprocess_batch."""
    import numpy as np
    import torch
    from gltvae_torch import cli, export_h5, export_serving, infer, render
    from gltvae_torch.eval.traversal import make_traversal_fn
    from gltvae_torch.ops import preprocess
    from gltvae_torch.train.checkpoint import CheckpointManager
    from gltvae_torch.train.loop import Trainer
    from gltvae_torch.utils import serving
    build = os.path.join(ROOT, 'build')
    run_dir, cpu = celeba['run_dir'], torch.device('cpu')
    out = {}

    # ------------------------------------------------------------- 23
    ns = infer.parse_args(['--checkpoint', run_dir, '--images', '.'])
    cfg = infer.resolve_model_config(ns)
    models = {d: infer.load_model(ns, cfg, d) for d in (dev, cpu)}
    fns = {}
    for d, m in models.items():
        full = make_traversal_fn(m)                 # every latent dim
        z0 = torch.zeros(cfg.z_dim, device=d)
        fns[d] = {'all dims, z=0': lambda f=full, z=z0: f(z),
                  'z_classify, prior': lambda m=m: render.traversal(
                      m, anchor='prior')}
    gaps, ms = {}, {}
    for name, fn in fns[dev].items():
        got, want = fn().cpu(), fns[cpu][name]()
        check(got.shape == want.shape and torch.isfinite(got).all()
              and got.shape[2:] == (cfg.image_size, cfg.image_size, 3),
              f'traversal {name}: shape {tuple(got.shape)}')
        gaps[name] = (tuple(got.shape), float((got - want).abs().max()))
        ms[name] = median_ms(fn, dev)
    check(gaps['all dims, z=0'][0][:2] == (cfg.z_dim, 8)
          and gaps['z_classify, prior'][0][:2] == (cfg.z_classify, 8),
          f'traversal grids {gaps}')
    check(all(g <= 1e-5 for _, g in gaps.values()),
          f'traversal card vs CPU over 1e-5: {gaps}')
    png = os.path.join(build, 'chip_smoke_traversal.png')
    render.main(['--mode', 'traversal', '--anchor', 'prior', '--checkpoint',
                 run_dir, '--out', png, '--device', str(dev)])
    from PIL import Image
    png_shape = np.asarray(Image.open(png)).shape
    check(png_shape == (cfg.z_classify * cfg.image_size,
                        8 * cfg.image_size, 3), f'render PNG {png_shape}')
    phase(23, f'traversal on the card and the CPU from the phase-18 '
              f'weights: ' + '; '.join(
                  f'{k} {s[0] * s[1]} images, max abs {g:.3e}'
                  for k, (s, g) in gaps.items())
          + f' (tol 1e-5); render PNG {png_shape}')
    print('slice_traversal: ' + '; '.join(
        f'{k} {gaps[k][0][0] * gaps[k][0][1]} images {v:.3f} ms per grid'
        for k, v in ms.items())
        + f' (median of 20 synchronized calls after 3); card {smi}',
        flush=True)

    # ------------------------------------------------------------- 24
    try:
        import h5py
        has_h5py = f'h5py {h5py.__version__}'
    except ImportError:
        has_h5py = None
    out['infer_h5'] = out['warm_start'] = None
    if has_h5py is None:
        phase(24, 'skipped: no h5py')
    else:
        h5_dir = os.path.join(build, 'chip_smoke_h5')
        shutil.rmtree(h5_dir, ignore_errors=True)
        export_h5.main(['--checkpoint', run_dir, '--out', h5_dir,
                        '--device', str(dev)])
        csv_path = os.path.join(build, 'chip_smoke_infer_h5.csv')
        sync(dev)
        preprocess.launches = 0
        infer.main(['--checkpoint', h5_dir, '--images', celeba['test_dir'],
                    '--output', csv_path, '--batch-size', str(BATCH),
                    '--num-workers', '8', '--device', str(dev)])
        sync(dev)
        out['infer_h5'] = preprocess.launches
        check(out['infer_h5'] == 2, f'.h5 inference: {out["infer_h5"]} '
              'dequant launches, expected 2')
        check(open(csv_path, 'rb').read() == celeba['infer_csv'],
              'inference from the .h5 folder wrote another CSV than '
              'phase 22')
        seen = []
        undo = patched(Trainer, 'test', lambda f: lambda self, loader: (
            seen.append({k: v.detach().cpu().clone() for k, v in
                         self.model.state_dict().items()}),
            f(self, loader))[1])
        warm_dir = os.path.join(build, 'chip_smoke_warm_start')
        shutil.rmtree(warm_dir, ignore_errors=True)
        try:
            sync(dev)
            preprocess.launches = 0
            res = cli.main(['--data-dir', celeba['corpus'], '--split-file',
                            'list_eval_partition.csv', '--sup', '0.5', '-bs',
                            str(BATCH), '--num-workers', '8', '--output-dir',
                            warm_dir, '--init-from-h5', h5_dir,
                            '--device', str(dev)])
            sync(dev)
            out['warm_start'] = preprocess.launches
        finally:
            undo()
        best = CheckpointManager(os.path.join(run_dir, 'checkpoints')
                                 ).load()['params']
        check(len(seen) == 1 and seen[0].keys() == best.keys()
              and all(torch.equal(seen[0][k], v) for k, v in best.items()),
              'the warm start did not test the checkpoint\'s params '
              'bit for bit')
        check(out['warm_start'] == 2, f'warm start test-only: '
              f'{out["warm_start"]} dequant launches, expected 2')
        check(math.isfinite(res[0.5]), f'warm start test acc {res[0.5]}')
        phase(24, f'{has_h5py}: export_h5 of the phase-18 run; infer from '
                  f'the .h5 folder: dequant launches {out["infer_h5"]}, CSV '
                  f'byte-equal to phase 22\'s; cli --init-from-h5 '
                  f'test-only: params bit-equal to the checkpoint, dequant '
                  f'launches {out["warm_start"]}, test acc {res[0.5]:.4f} '
                  f'(phase 18 {celeba["test_acc"]:.4f}; other eval draws)')

    # ------------------------------------------------------------- 25
    art = os.path.join(build, 'chip_smoke_serving.pt2')
    export_serving.main(['--checkpoint', run_dir, '--output', art,
                         '--with-reconstruct', '--device', str(dev)])
    program = serving.load_serving(art)
    recon = serving.load_serving(art + '.recon')
    predict = infer.make_predict(models[dev], stochastic=False, temp=1.0)
    gen = torch.Generator(device=dev).manual_seed(25)
    S = cfg.image_size
    errs, inputs = {}, {}
    for b in (BATCH, 7):
        u8 = torch.randint(0, 256, (b, S, S, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
        inputs[b] = u8
        got, want = program(u8), predict(u8)
        check(got.shape == want.shape == (b, cfg.y_dim),
              f'serving b={b}: {tuple(got.shape)}')
        errs[b] = float((got - want).abs().max())
        rec = recon(u8)
        check(rec.shape == u8.shape, f'reconstruct program gave '
              f'{tuple(rec.shape)} for {tuple(u8.shape)}')
    check(all(e <= 1e-5 for e in errs.values()),
          f'serving program vs predict_probs over 1e-5: {errs}')
    prog_ms = median_ms(lambda: program(inputs[BATCH]), dev)
    eager_ms = median_ms(lambda: predict(inputs[BATCH]), dev)
    phase(25, f'export_serving --with-reconstruct; the reloaded program vs '
              f'predict_probs(deterministic) over the divide-form dequant: '
              + ', '.join(f'b={b} max abs {e:.3e}' for b, e in errs.items())
              + ' (tol 1e-5); reconstruct output shape = input shape')
    print(f'slice_serving: loaded program {BATCH / prog_ms * 1e3:.0f} img/s '
          f'({prog_ms:.3f} ms), eager predict_probs '
          f'{BATCH / eager_ms * 1e3:.0f} img/s ({eager_ms:.3f} ms) at '
          f'b={BATCH} (median of 20 synchronized calls after 3); card {smi}',
          flush=True)

    # ------------------------------------------------------------- 26
    norm = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    g = torch.Generator().manual_seed(26)
    cases = []
    for size in (64, 128):
        u8 = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                           generator=g)
        cases.append((u8, torch.rand(BATCH, generator=g) < 0.5))
    modes = []
    undo = patched(preprocess, 'dequant', lambda f: lambda u8, mode='div',
                   *a: (modes.append(mode), f(u8, mode, *a))[1])
    try:
        on_card = [(u8.to(dev), m.to(dev)) for u8, m in cases]
        sync(dev)
        preprocess.launches = 0
        got = [preprocess.preprocess_batch(u8, flip=True, flip_mask=m,
                                           **norm) for u8, m in on_card]
        sync(dev)
        out['preprocess_batch'] = preprocess.launches
        card_modes = list(modes)
        want = [preprocess.preprocess_batch(u8, flip=True, flip_mask=m,
                                            **norm) for u8, m in cases]
    finally:
        undo()
    check(out['preprocess_batch'] == 2 and card_modes == ['mul', 'mul'],
          f'preprocess_batch: {out["preprocess_batch"]} dequant launches in '
          f'modes {card_modes}, expected 2 multiply-form')
    for (u8, m), a, b in zip(cases, got, want):
        check(torch.equal(a.cpu(), b), f'preprocess_batch {tuple(u8.shape)}: '
              f'card != CPU (max {float((a.cpu() - b).abs().max())})')
        check(0 < int(m.sum()) < BATCH, 'the flip mask has one kind')
    phase(26, f'preprocess_batch (mul-form dequant, ImageNet mean/std, '
              f'injected flip mask) at {[tuple(u8.shape) for u8, _ in cases]}'
              f': card bit-equal to the CPU, dequant launches '
              f'{out["preprocess_batch"]} (one a call)')
    return out


def host_phases(dev, smi, celeba):
    """Phases 27-29: TensorBoard events and --debug-nans through the CLI,
    the grain backend from phase 16's corpus, and the bench twin at
    reduced sizes. Returns the dequant launches of each path."""
    import contextlib
    import csv
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from gltvae_torch import bench, cli
    from gltvae_torch.config import default_celeba64
    from gltvae_torch.data import grain_loader
    from gltvae_torch.ops import preprocess
    from gltvae_torch.train.loop import Trainer
    from gltvae_torch.utils import tb_events
    build = os.path.join(ROOT, 'build')
    out = {}

    def run(argv, run_name):
        """cli.main with the dequant count set to 0 just before and read
        just after; each dispatch's synchronized wall recorded."""
        steps = []
        out_dir = os.path.join(build, run_name)
        shutil.rmtree(out_dir, ignore_errors=True)
        undo = patched(Trainer, '_resident_chunk',
                       lambda f: synced(f, steps))
        try:
            sync(dev)
            preprocess.launches = 0
            t0 = time.perf_counter()
            res = cli.main([*argv, '-bs', str(BATCH), '--output-dir',
                            out_dir, '--device', str(dev)])
            sync(dev)
            wall = time.perf_counter() - t0
        finally:
            undo()
        return dict(res=res, launches=preprocess.launches, steps=steps,
                    wall=wall, dir=os.path.join(out_dir,
                                                'params_0.5_learnable'))

    # ------------------------------------------------------------- 27
    n = 8 * BATCH
    n_eval = max(64, n // 8)
    synthetic = ['--synthetic', '--synthetic-n', str(n), '--do-train',
                 '--epochs', '2', '--sup', '0.5']
    tb_dir = os.path.join(build, 'chip_smoke_tb')
    shutil.rmtree(tb_dir, ignore_errors=True)
    plain = run(synthetic, 'chip_smoke_plain_cli')
    flagged = run(synthetic + ['--tensorboard', tb_dir, '--debug-nans'],
                  'chip_smoke_debug_nans')
    want = 2 * (n // BATCH) + 3 * math.ceil(n_eval / BATCH)
    check(plain['launches'] == flagged['launches'] == want,
          f'synthetic cli: dequant launches {plain["launches"]} and '
          f'{flagged["launches"]} under --debug-nans, expected {want}')
    with open(os.path.join(flagged['dir'], 'metrics.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    events = tb_events.read_scalars(os.path.join(tb_dir,
                                                 'params_0.5_learnable'))
    tags = set(rows[0]) - {'step', 'time'}
    want_events = {t: [(int(r['step']), float(np.float32(float(r[t]))))
                       for r in rows] for t in tags}
    check(len(rows) == 2 and events == want_events,
          f'TensorBoard events {events} != metrics.csv rows as f32 '
          f'{want_events}')
    model_cfg, train_cfg = default_celeba64(sup=0.5, batch_size=BATCH)
    rng = np.random.RandomState(27)
    trainer = Trainer(model_cfg, train_cfg,
                      mu_init=np.full((18, 18), 0.5, np.float32),
                      device=dev, debug_nans=True)
    with torch.no_grad():
        trainer.model.encoder.conv1.weight[0, 0, 0, 0] = float('nan')
    x = torch.from_numpy(rng.randint(0, 256, (BATCH, 64, 64, 3))
                         .astype(np.uint8)).to(dev)
    y = torch.from_numpy((rng.rand(BATCH, 18) > 0.5)
                         .astype(np.float32)).to(dev)
    try:
        trainer._sup_step(trainer.state, x, y, 1.0)
        named = None
    except FloatingPointError as e:     # the one expected outcome
        named = str(e)
    check(named is not None and 'aten.' in named,
          f'a NaN weight under --debug-nans raised no FloatingPointError '
          f'naming an aten op ({named})')
    del trainer
    med = {k: statistics.median(r['steps'][1:]) * 1e3
           for k, r in (('plain', plain), ('debug_nans', flagged))}
    phase(27, f'cli --tensorboard --debug-nans, synthetic {n}, 2 epochs: '
              f'dequant launches {flagged["launches"]} (as without the '
              f'flags), test acc {flagged["res"][0.5]:.4f} (without: '
              f'{plain["res"][0.5]:.4f}); '
              f'{sum(len(v) for v in events.values())} events of '
              f'{sorted(tags)} equal to metrics.csv\'s {len(rows)} rows as '
              f'f32; a NaN encoder weight raised FloatingPointError: '
              f'{named}')
    print(f'slice_debug_nans: step_ms median {med["plain"]:.3f} without '
          f'the flag, {med["debug_nans"]:.3f} with --debug-nans (steps '
          f'2-16, synchronized); cli walls {plain["wall"]:.2f} s and '
          f'{flagged["wall"]:.2f} s; card {smi}', flush=True)
    out['debug_nans'] = flagged['launches']

    # ------------------------------------------------------------- 28
    batches = {}

    def record(f):
        def next_batch(self):
            x, y = f(self)
            got = batches.setdefault(id(self), (self, []))[1]
            if len(got) < self.epoch_batches:
                got.append(x)
            return x, y
        return next_batch
    undo = patched(grain_loader.GrainLoader, 'next_batch', record)
    try:
        grain = run(['--data-dir', celeba['corpus'], '--split-file',
                     'list_eval_partition.csv', '--do-train', '--epochs',
                     '1', '--sup', '0.5', '--num-workers', '8',
                     '--decode-backend', 'grain'], 'chip_smoke_grain')
    finally:
        undo()
    n_train, n_valid, n_test = CORPUS
    want = 2 * (n_train // 2 // BATCH) + 2 * (n_valid // BATCH)
    check(grain['launches'] == want, f'grain backend: dequant launches '
          f'{grain["launches"]}, expected {want}')
    check(len(batches) == 4, f'{len(batches)} grain loaders ran, expected '
          f'sup, unsup, valid and test')
    with open(os.path.join(grain['dir'], 'result.json')) as f:
        hist = json.load(f)['history']
    for loader, got in batches.values():
        check(loader.n_s % BATCH == 0 and len(got) == loader.epoch_batches,
              f'a grain loader of {loader.n_s} rows yielded {len(got)} '
              f'batches')
        with ThreadPoolExecutor(8) as pool:
            decoded = list(pool.map(lambda i, s=loader.source: s[i][0],
                                    range(loader.n_s)))
        key = lambda imgs: sorted(im.tobytes() for im in imgs)
        check(key(np.concatenate(got)) == key(decoded),
              f'the first epoch of a grain loader of {loader.n_s} rows is '
              f'not a permutation of its split')
    phase(28, f'cli --decode-backend grain from the phase-16 corpus (sup '
              f'0.5, bs {BATCH}, 1 epoch, the port\'s own permutation): '
              f'dequant launches {grain["launches"]}; each of the 4 '
              f'loaders\' first epoch is a permutation of its split; test '
              f'acc {grain["res"][0.5]:.4f}')
    # the host's cost of the port's permutation at CelebA's train split
    t0 = time.perf_counter()
    for epoch in range(3):
        order = grain_loader.feistel_index_shuffle(np.arange(162770),
                                                   162769, epoch)
    perm_s = (time.perf_counter() - t0) / 3
    check(np.array_equal(np.sort(order), np.arange(162770)),
          'the permutation of 162,770 indices is not one')
    print(f'slice_grain: epoch wall {hist[0]["epoch_time"]:.3f} s, cli '
          f'wall {grain["wall"]:.2f} s; the permutation of 162,770 '
          f'indices {perm_s:.4f} s an epoch (host CPU); card {smi}',
          flush=True)
    out['grain'] = grain['launches']

    # ------------------------------------------------------------- 29
    argv = ['--batch-size', str(BATCH), '--steps', '10', '--scan', '4',
            '--eval-images', str(8 * BATCH), '--e2e-train-images',
            str(2 * BATCH), '--device', str(dev)]
    text = io.StringIO()
    sync(dev)
    preprocess.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = bench.main(argv)
    sync(dev)
    wall = time.perf_counter() - t0
    out['bench'] = preprocess.launches
    lines = text.getvalue().splitlines()
    check(rc == 0 and len(lines) == 1, f'bench: rc {rc}, output {lines}')
    line = json.loads(lines[0])
    unset = [k for k, v in line.items() if v is None
             and not (dev.type == 'cpu' and k.startswith('peak_hbm'))]
    unset += [f'{r}.{k}' for r in ('roofline', 'eval_roofline',
                                   'eval_roofline_resident')
              for k in ('step_gflops', 'achieved_tflops_per_sec')
              if (line[r] or {}).get(k) is None]
    check(not unset, f'bench: null values {unset}')
    check(out['bench'] > 0, 'the bench launched no dequant')
    print('bench: ' + lines[0], flush=True)
    phase(29, f'python -m gltvae_torch.bench {" ".join(argv)}: every key '
              f'bench.py fills is set; dequant launches {out["bench"]}; '
              f'{wall:.1f} s')
    return out


def count_plain_calls():
    """On the CPU the kernels' wrappers take their plain versions and count
    nothing: count each call where the card would launch (a CPU rehearsal
    of phase 31's ranks, which cannot be patched from outside)."""
    import gltvae_torch.train.steps as tsteps
    from gltvae_torch.ops import preprocess
    dq, aug = preprocess.dequant, preprocess._augment

    def dequant(u8, *a, **k):
        preprocess.launches += 1
        return dq(u8, *a, **k)

    def augment(*a, **k):
        preprocess.augment_launches += 1
        return aug(*a, **k)
    preprocess.dequant = tsteps.dequant = dequant
    preprocess._augment = augment


def augmented_run(label, model_cfg, train_cfg, splits, dev, run_name,
                  **trainer_kw):
    """Phase 9's augmented path (steps_per_dispatch 4, shipped), 2 epochs
    and the test, with the launch counts set to 0 just before and read
    just after; each crop's sha256 (and its rows' sha256 for each rank of
    a 2-rank mesh) kept. Returns what the run measured."""
    import hashlib

    import torch
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    mesh = trainer_kw.get('mesh')
    shard = (mesh.rank, mesh.world) if mesh is not None else None
    loaders = {k: BatchLoader(v, BATCH, seed=0, shard=shard)
               for k, v in splits.items()}
    run_dir = os.path.join(ROOT, 'build', run_name)
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = Trainer(model_cfg, train_cfg,
                      mu_init=cooccurrence_gating_matrix(
                          splits['sup'].labels),
                      metrics_path=os.path.join(run_dir, 'metrics.csv'),
                      steps_per_dispatch=4, device=dev,
                      local_batches=shard is not None, **trainer_kw)
    sha = lambda t: hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
    crops, chunk_s = [], []
    augment = trainer._augment

    def record(u8):
        out = augment(u8)
        if len(crops) == 0:             # the kernel vs plain at this shape
            draws = [torch.stack(v) for v in zip(*(
                preprocess.draw_crop_flip(
                    torch.Generator(device=dev).manual_seed(i),
                    u8.shape[1], u8.shape[2], u8.shape[3],
                    model_cfg.image_size) for i in range(len(u8))))]
            got = preprocess.fused_augment_stacked_given(
                u8, *draws, model_cfg.image_size)
            check(torch.equal(got, preprocess.augment_reference(
                u8, *draws, model_cfg.image_size)),
                f'{label}: augment != plain at {tuple(u8.shape)}')
            preprocess.augment_launches -= 1    # not the path's launch
        b = out.shape[1] // 2
        crops.append({'shape': tuple(out.shape), 'sha': sha(out),
                      'rows': [sha(out[:, r * b:(r + 1) * b])
                               for r in range(2)]})
        return out
    trainer._augment = record
    trainer._chunk_step = synced(trainer._chunk_step, chunk_s)
    sync(dev)
    preprocess.launches = preprocess.augment_launches = 0   # path starts
    trainer.train(loaders, log_every=1)
    test_acc = trainer.test(loaders['test'])
    sync(dev)
    launches = (preprocess.augment_launches, preprocess.launches)  # ends
    check(trainer.state.step == 16, f'{label}: {trainer.state.step} steps')
    check(0.0 <= test_acc <= 1.0, f'{label}: test accuracy {test_acc}')
    return dict(state=trainer.state.state_dict(), rows=trainer.metrics.rows,
                crops=crops, launches=launches, test_acc=test_acc,
                chunk_s=chunk_s, trainer=trainer)


def one_steps(model_cfg, train_cfg, mu, batches, dev, mesh=None):
    """One sup step and one unsup step, each from the initial state, on
    the global (x, y) `batches` (this rank's rows of them on a mesh): the
    metrics and the state after each, and the initial params."""
    import torch
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import make_train_steps
    out = []
    for (x, y), sup in zip(batches, (True, False)):
        model = init_model(model_cfg, train_cfg, mu, dev)
        state = create_train_state(model, train_cfg)
        dp = None
        if mesh is not None:
            shard_state(state, mesh)
            dp = DataParallel(mesh)
            x, y = x[mesh.rows(len(x))], y[mesh.rows(len(y))]
        p0 = {k: v.clone().cpu() for k, v in model.state_dict().items()}
        steps = make_train_steps(model, train_cfg, dp)
        _, m = steps[0 if sup else 1](state, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(y).to(dev), 1.0)
        out.append(dict(metrics={k: float(v) for k, v in m.items()},
                        state=state.state_dict(), p0=p0))
    return out


def dp_step_gaps(rank_pairs, pair, train_cfg):
    """How far each rank's ``one_steps`` results (`rank_pairs`, one list a
    rank) are from one process's (`pair`): metrics max rel; Adam m and v
    max abs over their leaf's largest value ('adam') and as one vector's
    relative L2 distance ('adam_m_l2', 'adam_v_l2'); the number of params
    outside rtol 2e-4 / atol 1e-6 of the one process's ('outside') and how
    far those are from the Keras Adam step of their rank's own moments, in
    units of lr ('adam_step'; inf where a frozen μ moved); 'adam_at' names
    the leaf of the worst 'adam'."""
    import torch
    from gltvae_torch.train.state import keras_alpha
    lr, eps = train_cfg.lr, train_cfg.adam_eps
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    w = dict(metrics=0.0, adam=0.0, adam_m_l2=0.0, adam_v_l2=0.0,
             outside=0, adam_step=0.0, adam_at='')
    for mine_pair in rank_pairs:
        for mine, ref, step_kind in zip(mine_pair, pair, ('sup', 'unsup')):
            w['metrics'] = max(w['metrics'], max(
                rel(mine['metrics'][k], ref['metrics'][k])
                for k in ref['metrics']))
            for g in ('adam_m', 'adam_v'):
                for k, v in ref['state'][g].items():
                    top = float(v.abs().max())
                    gap = float((mine['state'][g][k] - v).abs().max())
                    if gap / max(top, 1e-30) > w['adam']:
                        w['adam'] = gap / max(top, 1e-30)
                        w['adam_at'] = (f'{step_kind} {g} {k} (leaf max '
                                        f'{top:.3e}, gap {gap:.3e})')
                got, want = (torch.cat([d[g][k].flatten()
                                        for k in ref['state'][g]])
                             for d in (mine['state'], ref['state']))
                w[f'{g}_l2'] = max(w[f'{g}_l2'], float(
                    (got - want).norm() / want.norm()))
            alpha = keras_alpha(mine['state']['adam_count'], lr)
            for k, p in ref['state']['params'].items():
                q = mine['state']['params'][k]
                outside = (q - p).abs() > 1e-6 + 2e-4 * p.abs()
                w['outside'] += int(outside.sum())
                if k in mine['state']['adam_m'] and bool(outside.any()):
                    step = mine['p0'][k] - alpha * mine['state']['adam_m'][
                        k] / (mine['state']['adam_v'][k].sqrt() + eps)
                    w['adam_step'] = max(w['adam_step'], float(
                        (q - step)[outside].abs().max()) / lr)
                elif bool(outside.any()):
                    w['adam_step'] = float('inf')    # a frozen μ moved
    return w


def dp_rank(rank, world, store, dev_name, model_cfg, train_cfg, splits,
            model_a, train_a, splits_a, batch, root):
    """One of phase 31's gloo ranks on `dev_name`: the resident path, the
    augmented path and the one-step pair; saves what it measured beside
    the `store` as rank<r>.pt. `batch` and `root` are the parent's BATCH
    and ROOT."""
    global BATCH, ROOT
    BATCH, ROOT = batch, root
    sys.path.insert(0, ROOT)
    import torch
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.parallel.dp import replicas_agree
    dev = torch.device(dev_name)
    if dev.type == 'cpu':
        torch.set_num_threads(1)
        count_plain_calls()
    pmesh.initialize_multihost(f'file://{store}', world, rank, device=dev,
                               backend='gloo')
    try:
        mesh = pmesh.create_mesh(dev)
        check((mesh.rank, mesh.world, mesh.backend, mesh.device)
              == (rank, world, 'gloo', dev), f'rank {rank}: mesh {mesh}')
        # the dequant kernel vs plain at a rank's batch shape
        u8 = torch.from_numpy(splits['sup'].images[:BATCH // world]).to(dev)
        check(torch.equal(preprocess.dequant(u8),
                          preprocess.dequant_reference(u8)),
              f'rank {rank}: dequant != plain at {tuple(u8.shape)}')
        plain = train_and_test(f'rank {rank} resident', model_cfg,
                               train_cfg, splits, dev,
                               f'chip_smoke_dp/run{rank}', mesh=mesh)
        aug = augmented_run(f'rank {rank} augmented', model_a, train_a,
                            splits_a, dev, f'chip_smoke_dp/aug{rank}',
                            mesh=mesh)
        agree = (replicas_agree(plain['trainer'].state, mesh),
                 replicas_agree(aug['trainer'].state, mesh))
        mu = cooccurrence_gating_matrix(splits['sup'].labels)
        pair = one_steps(model_cfg, train_cfg, mu,
                         [(splits[k].images[:BATCH], splits[k].labels[:BATCH])
                          for k in ('sup', 'unsup')], dev, mesh)
        plain['state'] = plain['trainer'].state.state_dict()
        keep = lambda r: {k: v for k, v in r.items() if k != 'trainer'}
        torch.save(dict(plain=keep(plain), aug=keep(aug), agree=agree,
                        pair=pair),
                   os.path.join(os.path.dirname(store), f'rank{rank}.pt'))
    finally:
        pmesh.shutdown()


def dp_phases(dev, smi, ref5, model_cfg, train_cfg, splits, model_a,
              train_a, splits_a, timeout_s=300.0):
    """Phases 30-31: a mesh of one over NCCL against phase 5 (`ref5`), and
    two gloo ranks on the one card against the one-process runs. Returns
    the dequant launches of the mesh of one and of each rank's resident
    run, and each rank's (augment, dequant) launches on the augmented
    path."""
    import socket

    import torch
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel import mesh as pmesh
    out = {}
    keys = ('loss', 'elbo', 'log_pxz', 'kl', 'log_qy_zc', 'log_qy_x',
            'c_sum')

    # ------------------------------------------------------------- 30
    # cuDNN's default backward convolutions sum in an order that varies
    # from run to run (phase 11's two runs of identical batches end with
    # params 4.6e-5 apart), so phase 5's run is repeated, without and with
    # the mesh, on cuDNN's deterministic algorithms, and those two are
    # held bit for bit
    with socket.socket() as sk:         # a free port for the TCP store
        sk.bind(('127.0.0.1', 0))
        port = sk.getsockname()[1]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pmesh.initialize_multihost(f'127.0.0.1:{port}', 1, 0, device=dev)
    try:
        mesh = pmesh.create_mesh(dev)
        want = 'nccl' if dev.type == 'cuda' else 'gloo'
        check((mesh.world, mesh.backend, mesh.device) == (1, want, dev),
              f'mesh of one: {mesh}')
        runs = [train_and_test(label, model_cfg, train_cfg, splits, dev,
                               f'chip_smoke_mesh1_{i}', **kw)
                for i, (label, kw) in enumerate((
                    ('phase 5 again, deterministic', {}),
                    ('mesh of one, deterministic', dict(mesh=mesh))))]
    finally:
        pmesh.shutdown()
        torch.backends.cudnn.deterministic = deterministic
    sds = [r['trainer'].state.state_dict() for r in runs]
    differ = [f'{g}.{k}' for g in ('params', 'adam_m', 'adam_v')
              for k, v in sds[0][g].items()
              if not torch.equal(v, sds[1][g][k])]
    strip = lambda rows: [{k: v for k, v in r.items() if k != 'time'}
                          for r in rows]
    check(not differ and strip(runs[1]['rows']) == strip(runs[0]['rows'])
          and sds[0]['adam_count'] == sds[1]['adam_count'],
          f'mesh of one != phase 5\'s run: {differ[:5]}')
    launches = [r['launches'] for r in runs]
    check(launches == [ref5['launches']] * 2,
          f'dequant launches {launches} != phase 5\'s {ref5["launches"]}')
    gap5 = max(float((sds[0]['params'][k] - v).abs().max())
               for k, v in ref5['state']['params'].items())
    out['nccl_1'] = launches[1]
    med = [statistics.median(r['step_s'][1:]) for r in runs]
    phase(30, f'mesh of one over {mesh.backend} on {mesh.device}: phase '
              f'5\'s run through Trainer(mesh=) equal to the same run '
              f'without a mesh bit for bit (params, Adam moments, '
              f'{len(runs[1]["rows"])} metric rows; both on cuDNN\'s '
              f'deterministic algorithms; vs phase 5 itself params max abs '
              f'{gap5:.3e}, not held); dequant launches {launches[1]}')
    print(f'slice_mesh1: step_ms median {med[1] * 1e3:.3f} with the mesh '
          f'of one, {med[0] * 1e3:.3f} without (deterministic cuDNN; '
          f'phase 5: {ref5["step_med"] * 1e3:.3f}; steps 2-16, '
          f'synchronized); card {smi}', flush=True)
    del runs, sds

    # ------------------------------------------------------------- 31
    world = 2
    dp_dir = os.path.join(ROOT, 'build', 'chip_smoke_dp')
    shutil.rmtree(dp_dir, ignore_errors=True)
    os.makedirs(dp_dir)
    t0 = time.perf_counter()
    pmesh.spawn(dp_rank, world, (os.path.join(dp_dir, 'store'), str(dev),
                                 model_cfg, train_cfg, splits, model_a,
                                 train_a, splits_a, BATCH, ROOT), timeout_s)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(dp_dir, f'rank{r}.pt'),
                        weights_only=False) for r in range(world)]
    one = augmented_run('one-process augmented', model_a, train_a, splits_a,
                        dev, 'chip_smoke_dp/aug')
    mu = cooccurrence_gating_matrix(splits['sup'].labels)
    pair = one_steps(model_cfg, train_cfg, mu,
                     [(splits[k].images[:BATCH], splits[k].labels[:BATCH])
                      for k in ('sup', 'unsup')], dev)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    for r, got in enumerate(ranks):
        plain, aug = got['plain'], got['aug']
        check(all(got['agree']), f'rank {r}: replicas disagree')
        check(plain['launches'] == 22 and plain['steps'] == 16,
              f'rank {r}: resident path dequant launches '
              f'{plain["launches"]}, steps {plain["steps"]}')
        b = BATCH // world
        check(aug['launches'] == (4, 6) and [c['shape'] for c in
                                             aug['crops']]
              == [(4, b, model_a.image_size, model_a.image_size, 3)] * 4,
              f'rank {r}: augment path launches {aug["launches"]} of '
              f'{[c["shape"] for c in aug["crops"]]}')
        check([c['sha'] for c in aug['crops']]
              == [c['rows'][r] for c in one['crops']],
              f'rank {r}: its crops differ from its rows of the '
              f'one-process crops')
    for name, ref in (('resident', ref5['rows']), ('augmented',
                                                   one['rows'])):
        worst = max(rel(a[k], b[k]) for got in ranks
                    for a, b in zip(got['plain' if name == 'resident'
                                        else 'aug']['rows'], ref)
                    for k in keys)
        phase(31, f'{name}: 2 ranks vs 1 process, 16 steps: metric rows '
                  f'max rel {worst:.3e} (tol 1e-4)')
        check(worst <= 1e-4, f'{name}: 2-rank metrics off the 1-process '
                             f'run')
    for name, g in (('params', 'params'), ('adam_m', 'adam_m'),
                    ('adam_v', 'adam_v')):
        gap = max(float((got['plain']['state'][g][k] - v).abs().max())
                  for got in ranks for k, v in ref5['state'][g].items())
        print(f'  2 ranks vs 1 process after 16 steps: {name} max abs '
              f'{gap:.3e} (printed, not held)', flush=True)
    gaps = dp_step_gaps([got['pair'] for got in ranks], pair, train_cfg)
    met_w, mom_w, n_out, step_w = (gaps[k] for k in ('metrics', 'adam',
                                                     'outside', 'adam_step'))
    phase(31, f'one sup and one unsup step from one state, 2 ranks vs 1 '
              f'process: metrics max rel {met_w:.3e} (tol 1e-5); Adam m, v '
              f'max abs / leaf max {mom_w:.3e} (tol 2e-4); params outside '
              f'rtol 2e-4 atol 1e-6: {n_out} elements, held instead within '
              f'lr/4 of the Adam step of their rank\'s moments: '
              f'{step_w:.3e} x lr (tol 0.25)')
    check(met_w <= 1e-5, '2-rank one-step metrics off the 1-process step')
    check(mom_w <= 2e-4, '2-rank Adam moments off the 1-process step')
    check(step_w <= 0.25, '2-rank params are not the Adam step of their '
                          'moments')
    meds = [statistics.median(got['plain']['step_s'][1:]) for got in ranks]
    phase(31, f'2 gloo ranks on {dev} ({spawn_s:.1f} s with their start): '
              f'each rank 22 dequant launches on the resident path, 4 '
              f'augment launches of {BATCH // world * 4} images and 6 '
              f'dequant on the augmented path; both kernels bit-equal to '
              f'plain at the ranks\' shapes; each rank\'s crops bit-equal '
              f'to its rows of the 1-process crops; the ranks\' states '
              f'equal')
    print(f'slice_dp: resident step_ms median per rank '
          f'{", ".join(f"{m * 1e3:.3f}" for m in meds)} (two ranks share '
          f'one card through gloo: not a DP speed); one process '
          f'{ref5["step_med"] * 1e3:.3f} (phase 5); card {smi}', flush=True)
    out['gloo_2'] = ranks[0]['plain']['launches']
    out['gloo_2_augment'] = ranks[0]['aug']['launches']
    return out


#: phase 35: bench_data's corpus size and the ship+step rows' timed steps
#: (bench_data.bench_ship_and_step's default)
BENCH_DATA_N = 512
SHIP_ITERS = 20
#: phase 36: images of each eval pass (profile_step's --eval-images) and
#: the steps of a train-scan dispatch (--scan)
PROFILE_EVAL_IMAGES = 4096
PROFILE_SCAN = 8
#: phase 34: the parity corpus's images and the seed panel's batch
PANEL_N = 350
PANEL_BS = 64


def experiment_phases(dev, smi, celeba):
    """Phases 32-34: the experiment tools on the card, as a user runs them
    (each module's ``main``): the gating and metrics tools on phase 18's
    run, the Table-1 matrix on phase 16's corpus, the parity corpus and
    the seed panel. Returns the dequant launches of each path (None where
    the path runs in subprocesses, which count for themselves)."""
    import numpy as np
    from gltvae_torch import (analyze_gating, cli, gen_gating_matrix,
                              metrics_summary, parity_corpus,
                              repro_reference, seed_panel)
    from gltvae_torch.config import CELEBA_EASY_LABELS, CELEBA_LABELS
    from gltvae_torch.data.celeba import load_attr_csv
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import (cooccurrence_gating_matrix,
                                         save_labeled_csv)
    from gltvae_torch.train.loop import Trainer
    build = os.path.join(ROOT, 'build')
    tools_dir = os.path.join(build, 'chip_smoke_tools')
    shutil.rmtree(tools_dir, ignore_errors=True)
    os.makedirs(tools_dir)
    corpus, run_dir = celeba['corpus'], celeba['run_dir']
    out = {}

    # ------------------------------------------------------------- 32
    attr = os.path.join(corpus, 'list_attr_celeba.csv')
    for all_labels, names in ((False, CELEBA_EASY_LABELS),
                              (True, CELEBA_LABELS)):
        d = os.path.join(tools_dir, f'gating_{len(names)}')
        gen_gating_matrix.main(['--attr-csv', attr, '--out-dir', d]
                               + (['--all-labels'] if all_labels else []))
        want = cooccurrence_gating_matrix(load_attr_csv(
            attr, use_easy_labels=not all_labels)[1])
        got = np.load(os.path.join(d, 'gating_matrix.npy'))
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f'gen_gating_matrix {len(names)} labels: .npy != '
              f'ops/gating.py\'s matrix')
        ref_csv = os.path.join(d, 'ops_gating.csv')
        save_labeled_csv(want, names, ref_csv)
        check(open(os.path.join(d, 'gating_matrix.csv'), 'rb').read()
              == open(ref_csv, 'rb').read(),
              f'gen_gating_matrix {len(names)} labels: .csv differs')
    counts, text = captured(analyze_gating.main, [
        '--data-dir', corpus, '--models-dir', os.path.dirname(run_dir),
        '--sup', '0.5'])
    check('Learned Gating Matrix' in text and list(counts[0]) == ['0.5']
          and len(counts[1]['0.5']) == 9, f'analyze_gating: {counts}')
    history = os.path.join(run_dir, 'gating_history.npz')
    epochs, text = captured(metrics_summary.main, [
        os.path.join(run_dir, 'metrics.csv'), '--gating-history', history])
    check(len(epochs) == 2 and 'gating history: 2 epochs' in text,
          f'metrics_summary: {len(epochs)} epochs')
    png = os.path.join(tools_dir, 'curves.png')
    try:
        captured(metrics_summary.main, [os.path.join(run_dir, 'metrics.csv'),
                                        '--plot', png])
        plot = f'--plot wrote {os.path.getsize(png)} B'
    except ImportError as e:
        check('--plot needs matplotlib' in str(e), f'--plot raised {e!r}')
        plot = f'--plot raised ImportError ({e})'
    phase(32, f'gen_gating_matrix from phase 16\'s {attr!r} (18 and 40 '
              f'labels): .npy bit-equal to ops/gating.py\'s matrix, .csv '
              f'byte-equal to save_labeled_csv; analyze_gating on phase 18\'s '
              f'run: {counts[1]["0.5"]}; metrics_summary --gating-history: '
              f'{len(epochs)} epochs; {plot}')

    # ------------------------------------------------------------- 33
    _, n_valid, n_test = CORPUS
    eval_batches = math.ceil(n_valid / BATCH) + math.ceil(n_test / BATCH)
    matrix_dir = os.path.join(build, 'chip_smoke_matrix')
    shutil.rmtree(matrix_dir, ignore_errors=True)
    args = repro_reference.parse_args([
        '--data-dir', corpus, '--epochs', '1', '--batch-size', str(BATCH),
        '--output-dir', os.path.join(matrix_dir, 'models'), '--device',
        str(dev)])
    cells, trainers = [], []

    def timed(main):
        def run(argv):
            sync(dev)
            preprocess.launches = preprocess.augment_launches = 0
            t0 = time.perf_counter()
            res = main(argv)
            sync(dev)
            cells.append(dict(s=time.perf_counter() - t0,
                              launches=(preprocess.launches,
                                        preprocess.augment_launches),
                              steps=trainers[-1].state.step))
            return res
        return run

    def init(f):
        def run(self, *a, **kw):
            f(self, *a, **kw)
            trainers.append(self)
        return run
    undo = [patched(cli, 'main', timed), patched(Trainer, '__init__', init)]
    try:
        acc = repro_reference.run_matrix(args, [
            '--split-file', 'list_eval_partition.csv', '--num-workers', '8',
            '--cache-dir', os.path.join(matrix_dir, 'cache')])
    finally:
        for u in undo:
            u()
    del trainers
    check(len(cells) == 9 and list(acc) == [
        repro_reference.cell_key(g, s, sup) for g, s, sup, _ in
        repro_reference.cell_argvs(args)], f'matrix cells {list(acc)}')
    for (key, rec), c in zip(acc.items(), cells):
        check(c['launches'] == (c['steps'] + eval_batches, 0),
              f'{key}: dequant, augment launches {c["launches"]} for '
              f'{c["steps"]} steps + {eval_batches} eval batches')
        check(0.0 <= rec['test_accuracy'] <= 1.0, f'{key}: {rec}')
    out['matrix'] = sum(c['launches'][0] for c in cells)
    phase(33, f'repro_reference: the 9 Table-1 cells through cell_argvs '
              f'and cli.main on phase 16\'s corpus (1 epoch each, '
              f'bf16, bs {BATCH}, --deterministic-eval, split file, one '
              f'--cache-dir for all): dequant launches '
              f'{[c["launches"][0] for c in cells]} (steps + '
              f'{eval_batches} eval batches each), {out["matrix"]} in all')
    print('matrix: ' + json.dumps({k: dict(v, seconds=round(c['s'], 3))
                                   for (k, v), c in zip(acc.items(), cells)})
          + ' (noise JPEGs: the Table-1 values are not expected); '
          f'card {smi}', flush=True)

    # ------------------------------------------------------------- 34
    panel = os.path.join(build, 'chip_smoke_panel')
    shutil.rmtree(panel, ignore_errors=True)
    n_panel = PANEL_N
    parity_corpus.main(['--out', os.path.join(panel, 'data'), '--n',
                        str(n_panel)])
    again = os.path.join(build, 'chip_smoke_panel_again')
    shutil.rmtree(again, ignore_errors=True)
    parity_corpus.generate_corpus(again, n=n_panel)
    for rel in ('list_attr_celeba.csv', 'img_align_celeba/000001.jpg',
                f'img_align_celeba/{n_panel:06d}.jpg'):
        check(open(os.path.join(panel, 'data', rel), 'rb').read()
              == open(os.path.join(again, rel), 'rb').read(),
              f'parity corpus: {rel} differs between two writes')
    shutil.rmtree(again)
    t0 = time.perf_counter()
    results = seed_panel.main(['--workdir', panel, '--seeds', '0', '--n',
                               str(n_panel), '--epochs', '1', '--bs',
                               str(PANEL_BS), '--device', str(dev)])
    panel_s = time.perf_counter() - t0
    check(sorted(results) == ['locs=linear/seed=0', 'locs=relu/seed=0']
          and all(0.0 <= r['test_accuracy'] <= 1.0
                  for r in results.values()), f'seed panel: {results}')
    out['seed_panel'] = None             # its runs are subprocesses
    phase(34, f'parity_corpus of {n_panel} images (written twice, the same '
              f'bytes); seed_panel, 1 seed x relu/linear posterior locs, '
              f'1 epoch each through `python -m gltvae_torch.cli` '
              f'subprocesses on {dev.type} in {panel_s:.1f} s: '
              + ', '.join(f'{k} {v["test_accuracy"]:.4f}'
                          for k, v in sorted(results.items())))

    return out


def captured(fn, argv):
    """fn(argv) with its stdout kept: (return value, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return ret, buf.getvalue()


def measure_phases(dev, smi):
    """Phases 35-36: bench_data (every row, the ship+step rows on the
    card) and profile_step's four modes at bs BATCH. Returns the dequant
    launches of each."""
    from gltvae_torch import bench_data, profile_step
    from gltvae_torch.ops import preprocess
    build = os.path.join(ROOT, 'build')
    out = {}

    # ------------------------------------------------------------- 35
    sync(dev)
    preprocess.launches = 0
    rows = bench_data.main(['--n', str(BENCH_DATA_N), '--threads', '8',
                            '--device-resize', '--device', str(dev)])
    sync(dev)
    out['bench_data'] = preprocess.launches
    native = next(k for k in rows if k.startswith('native_cpp'))
    missing = [k for k, v in rows.items() if v is None
               and k not in (native, 'train-path native x8')]
    check(not missing and len(rows) == 9, f'bench_data rows without a '
                                          f'rate: {missing}')
    check(out['bench_data'] == 2 * (SHIP_ITERS + 1),
          f'bench_data ship+step rows: {out["bench_data"]} dequant '
          f'launches, expected {2 * (SHIP_ITERS + 1)}')
    phase(35, f'bench_data --n {BENCH_DATA_N} --device-resize: every row '
              f'(the native rows where the pool builds); ship+step rows '
              f'{out["bench_data"]} dequant launches (warm-up + '
              f'{SHIP_ITERS} steps each)')
    print('bench_data: ' + json.dumps(rows) + f'; card {smi}', flush=True)

    # ------------------------------------------------------------- 36
    prof_dir = os.path.join(build, 'chip_smoke_profile')
    shutil.rmtree(prof_dir, ignore_errors=True)
    summary = os.path.join(prof_dir, 'summary.json')
    out['profile'] = {}
    per = {'train-step': 1, 'train-scan': PROFILE_SCAN,
           'eval-resident': PROFILE_EVAL_IMAGES // BATCH,
           'eval-chunked': PROFILE_EVAL_IMAGES // BATCH}
    for mode in profile_step.MODES:
        sync(dev)
        preprocess.launches = 0
        rec, text = captured(profile_step.main, [
            '--mode', mode, '--steps', '4', '--batch-size', str(BATCH),
            '--scan', str(PROFILE_SCAN), '--eval-images',
            str(PROFILE_EVAL_IMAGES),
            '--out', prof_dir, '--summary', summary,
            '--device', str(dev)])
        sync(dev)
        launches = preprocess.launches
        out['profile'][mode] = launches
        check(launches == 12 * per[mode],
              f'profile {mode}: {launches} dequant launches, expected 12 '
              f'dispatches x {per[mode]}')
        check(rec['launches_per_dispatch'] > 0
              and rec['device_ms_per_dispatch'] > 0,
              f'profile {mode}: {rec["launches_per_dispatch"]} launches')
        unit = 'steps' if mode.startswith('train') else 'eval batches'
        print(f'profile {mode}: wall {rec["wall_ms_per_dispatch"]:.3f} ms, '
              f'device {rec["device_ms_per_dispatch"]:.3f} ms, '
              f'{rec["launches_per_dispatch"]:.0f} launches per dispatch of '
              f'{per[mode]} {unit}; top: ' + '; '.join(
                  f'{k["device_ms_per_dispatch"]:.3f} ms {k["name"][:40]}'
                  for k in rec['top_kernels'][:3]) + f'; card {smi}',
              flush=True)
    with open(summary) as f:
        check(sorted(json.load(f)) == sorted(profile_step.MODES),
              'profile summary misses a mode')
    phase(36, f'profile_step --mode {"/".join(profile_step.MODES)} at bs '
              f'{BATCH} ({PROFILE_EVAL_IMAGES} eval images): dequant '
              f'launches {out["profile"]}; summary {summary}')
    return out


#: phase 37: the sweep's global batch and the rows of its eval split (not
#: a multiple of 4: the last of 4 ranks holds a padding row)
SWEEP_BATCH = 4096
SWEEP_EVAL_ROWS = 5099


def sweep_inputs(batch, eval_rows):
    """Phase 37's data from one seed: a sup and an unsup batch of `batch`
    rows (x u8, y f32) and an eval split of `eval_rows` rows."""
    import numpy as np
    rng = np.random.RandomState(37)
    make = lambda n: (rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8),
                      (rng.rand(n, 18) > 0.5).astype(np.float32))
    return [make(batch), make(batch)], make(eval_rows)


def sweep_evals(model_cfg, train_cfg, mu, eval_split, dev, mesh=None):
    """A fresh Trainer's validation accuracy over `eval_split`, resident
    (a mesh's ranks exchange rows, gather_rows) and shipped (each batch's
    rows of this rank), with the matches gathered over the ranks
    (``DataParallel.mean_rows``)."""
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.train.loop import Trainer
    out = {}
    for name, mode in (('resident', 'auto'), ('shipped', 'off')):
        tr = Trainer(model_cfg, train_cfg, mu_init=mu, device=dev,
                     mesh=mesh, resident_eval=mode)
        loader = BatchLoader(ArrayDataset(*eval_split), train_cfg.batch_size,
                             seed=0)
        out[name] = tr.evaluate(loader)
        check((id(loader) in tr._resident_data) == (mode == 'auto'),
              f'sweep eval {name}: resident {mode} not taken')
    return out


def sweep_rank(rank, world, url, devices, model_cfg, train_cfg, mu,
               batches, eval_split, out_dir, root):
    """One rank of phase 37 on ``devices[rank]``: its own card over NCCL
    ('cuda:<rank>' with a tcp:// `url`), or over gloo on one shared device
    ('cuda:0' or 'cpu'). Checks dequant against plain at its rows' shape, then runs
    ``one_steps`` at bf16 and f32 and ``sweep_evals``; saves what it
    measured as <out_dir>/rank<r>.pt."""
    import dataclasses

    global ROOT
    ROOT = root
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh as pmesh
    dev = torch.device(devices[rank])
    nccl = dev.type == 'cuda' and dev.index == rank and world > 1 \
        and url.startswith('tcp')
    if dev.type == 'cpu':
        torch.set_num_threads(1)
        count_plain_calls()
    # cuDNN's deterministic algorithms: a rank's arithmetic is then the
    # same in every leg, and the legs differ only in their transport
    torch.backends.cudnn.deterministic = True
    gathers = [0]
    real = dist.all_gather_into_tensor

    def counted(*a, **k):
        gathers[0] += 1
        return real(*a, **k)
    dist.all_gather_into_tensor = counted
    pmesh.initialize_multihost(url, world, rank, device=dev,
                               backend='nccl' if nccl else 'gloo')
    try:
        mesh = pmesh.create_mesh(dev)
        check((mesh.rank, mesh.world, mesh.device) == (rank, world, dev)
              and mesh.backend == ('nccl' if nccl else 'gloo'),
              f'rank {rank}: mesh {mesh}')
        if dev.type == 'cuda':
            check(torch.cuda.current_device() == dev.index,
                  f'rank {rank} bound to card {torch.cuda.current_device()}')
        u8 = torch.from_numpy(batches[0][0][mesh.rows(len(batches[0][0]))]
                              ).to(dev)
        check(torch.equal(preprocess.dequant(u8),
                          preprocess.dequant_reference(u8)),
              f'rank {rank}: dequant != plain at {tuple(u8.shape)}')
        shape = tuple(u8.shape)
        del u8
        sync(dev)
        preprocess.launches = 0
        pairs = {dt: one_steps(dataclasses.replace(model_cfg,
                                                   compute_dtype=dt),
                               train_cfg, mu, batches, dev, mesh)
                 for dt in ('bfloat16', 'float32')}
        evals = sweep_evals(model_cfg, train_cfg, mu, eval_split, dev, mesh)
        sync(dev)
        launches = preprocess.launches
        torch.save(dict(pairs=pairs, evals=evals, launches=launches,
                        shape=shape, gathers=gathers[0],
                        backend=mesh.backend),
                   os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        dist.all_gather_into_tensor = real
        pmesh.shutdown()


def sweep_phase(dev, smi, world=None, timeout_s=600.0):
    """Phase 37: ``config.dp_sweep()[0]`` (bf16, global batch SWEEP_BATCH)
    in one process, one sup and one unsup step, timed and profiled; dequant
    timed at that batch; then, with `world` ranks (default: min(cards, 4)
    where 2 or more cards exist, one rank a card over NCCL), the same
    steps from one state held to the one process, and the resident and
    gathered evals. Returns the launches and dequant's timing."""
    import dataclasses
    import socket

    import numpy as np
    import torch
    import gltvae_torch.train.steps as tsteps
    from torch.profiler import ProfilerActivity, profile
    from gltvae_torch.config import dp_sweep
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.profile_step import kernel_table
    from gltvae_torch.time_kernels import (cuda_ms, cycler, dequant_bound_ms,
                                           memory_rate)
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import make_train_steps
    cuda = dev.type == 'cuda'
    name, model_cfg, train_cfg = dp_sweep()[0]
    train_cfg = dataclasses.replace(train_cfg, batch_size=SWEEP_BATCH)
    B = SWEEP_BATCH
    batches, eval_split = sweep_inputs(B, SWEEP_EVAL_ROWS)
    mu = cooccurrence_gating_matrix(batches[0][1]).astype(np.float32)
    out = {}

    # one process: warm-up pair, a timed pair, a profiled pair
    seen = []
    undo = patched(tsteps, 'dequant', lambda f: lambda x, *a: (
        seen.append(tuple(x.shape)), f(x, *a))[1])
    try:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        model = init_model(model_cfg, train_cfg, mu, dev)
        state = create_train_state(model, train_cfg)
        steps = make_train_steps(model, train_cfg)
        xs = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
              for x, y in batches]
        sync(dev)
        preprocess.launches = 0

        def pair(times=None):
            for fn, (x, y) in zip(steps, xs):
                sync(dev)
                t = time.perf_counter()
                _, m = fn(state, x, y, 1.0)
                sync(dev)
                if times is not None:
                    times.append(time.perf_counter() - t)
            return m
        first = []
        pair(first)
        walls = []
        m = pair(walls)
        events = []
        if cuda:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pair()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        else:
            pair()
        sync(dev)
        launches = preprocess.launches
        peak = (torch.cuda.max_memory_allocated(dev) - held) if cuda else 0
    finally:
        undo()
    check(all(math.isfinite(float(v)) for v in m.values()),
          f'{name}: metrics not finite at B={B}')
    check(launches == 6 and seen == [(B, 64, 64, 3)] * 6,
          f'{name}: dequant launches {launches} at {seen}, expected 6 at '
          f'{(B, 64, 64, 3)}')
    table = kernel_table(events, 2, 5) if events else None
    out['one_process'] = launches
    phase(37, f'{name} (dp_sweep()[0]: {model_cfg.gate_type}/'
              f'{model_cfg.gate_subtype}, sup {train_cfg.perc_supervision}, '
              f'{model_cfg.compute_dtype}) at global batch {B} in one '
              f'process: a sup and an unsup step, 3 times each; dequant '
              f'launches {launches} at {(B, 64, 64, 3)}')
    dev_ms = table['device_ms_per_dispatch'] if table else float('nan')
    print(f'slice_sweep: step wall sup {walls[0] * 1e3:.3f} ms, unsup '
          f'{walls[1] * 1e3:.3f} ms (first {first[0] * 1e3:.1f} / '
          f'{first[1] * 1e3:.1f}), {2 * B / sum(walls):.0f} img/s; device '
          f'{dev_ms:.3f} ms per step (sum of kernel times, profiled pair), '
          f'{table["launches_per_dispatch"] if table else 0:.0f} launches a '
          f'step; peak memory {peak / 2**20:.1f} MiB above the start; card '
          f'{smi}', flush=True)
    del model, state, steps, xs, m

    # dequant at the sweep's batch: 4 distinct 50 MB inputs cycled
    if cuda:
        gen = torch.Generator(device=dev).manual_seed(37)
        shp = (B, 64, 64, 3)
        ins = [torch.randint(0, 256, shp, dtype=torch.uint8, device=dev,
                             generator=gen) for _ in range(4)]
        for mode in ('div', 'mul'):
            check(torch.equal(preprocess.dequant(ins[0], mode),
                              preprocess.dequant_reference(ins[0], mode)),
                  f'dequant {mode} {shp}: kernel != plain')
        nxt = cycler(ins)
        ms, call_ms = cuda_ms(lambda: preprocess.dequant(nxt()), 40)
        plain, _ = cuda_ms(lambda: preprocess.dequant_reference(nxt()), 20)
        lib, _ = cuda_ms(lambda: nxt().float() / 255.0, 20)
        n = math.prod(shp)
        bound = dequant_bound_ms(n, memory_rate(torch.cuda.get_device_name(
            dev)))
        plan = preprocess.dequant_plan(ins[0].data_ptr(), 0, n)
        out['dequant_4096'] = {'shape': list(shp), 'ms': ms,
                               'plain_ms': plain, 'library_ms': lib,
                               'bound_ms': bound}
        print(f'kernels dequant {shp}: kernel_ms {ms:.5f} ({call_ms:.5f}); '
              f'plain_ms {plain:.5f}; library_ms {lib:.5f}; bound_ms '
              f'{bound:.5f} ({n * 5} B, {bound / ms:.1%} of it); plan '
              f'{plan.tiles} tiles + {plan.tail} B tail, grid {plan.grid}; '
              f'card {smi}', flush=True)
        del ins, nxt

    # ranks: one a card over NCCL
    if world is None:
        count = torch.cuda.device_count() if cuda else 0
        if count < 2:
            phase(37, f'NCCL across cards not run in this call: '
                      f'{count} card(s) visible')
            out['ranks'] = None
            return out
        world = min(count, 4)
    # the legs: NCCL ranks one a card and, as their reference, gloo ranks
    # sharing cuda:0 (the same per-rank shapes and deterministic cuDNN
    # algorithms: only the transport differs); on the CPU, gloo ranks
    if cuda:
        legs = [('nccl', [f'cuda:{r}' for r in range(world)]),
                ('gloo', ['cuda:0'] * world)]
    else:
        legs = [('gloo', ['cpu'] * world)]
    results, spawn_s = {}, {}
    for backend, devices in legs:
        leg_dir = os.path.join(ROOT, 'build', f'chip_smoke_sweep_{backend}')
        shutil.rmtree(leg_dir, ignore_errors=True)
        os.makedirs(leg_dir)
        if backend == 'nccl':
            with socket.socket() as sk:     # a free port for the TCP store
                sk.bind(('127.0.0.1', 0))
                url = f'tcp://127.0.0.1:{sk.getsockname()[1]}'
        else:
            url = f'file://{os.path.join(leg_dir, "store")}'
        t0 = time.perf_counter()
        pmesh.spawn(sweep_rank, world,
                    (url, devices, model_cfg, train_cfg, mu, batches,
                     eval_split, leg_dir, ROOT), timeout_s)
        spawn_s[backend] = time.perf_counter() - t0
        results[backend] = [torch.load(os.path.join(leg_dir, f'rank{r}.pt'),
                                       weights_only=False)
                            for r in range(world)]
    ranks = results[legs[0][0]]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True        # as the ranks
    try:
        ref = {dt: one_steps(dataclasses.replace(model_cfg,
                                                 compute_dtype=dt),
                             train_cfg, mu, batches, dev)
               for dt in ('bfloat16', 'float32')}
        ref_eval = sweep_evals(model_cfg, train_cfg, mu, eval_split, dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    backend = ranks[0]['backend']
    b = B // world
    for leg, got_ranks in results.items():
        for r, got in enumerate(got_ranks):
            check(got['shape'] == (b, 64, 64, 3) and got['backend'] == leg,
                  f'{leg} rank {r}: {got["shape"]} on {got["backend"]}')
            check(got['evals']['resident'] == got['evals']['shipped'],
                  f'{leg} rank {r}: resident eval {got["evals"]} != '
                  f'shipped')
            check(got['evals'] == got_ranks[0]['evals'],
                  f'{leg} rank {r}: eval {got["evals"]} != rank 0\'s')
            check(leg != 'nccl' or got['gathers'] > 0,
                  f'nccl rank {r}: no all_gather_into_tensor')
    eval_batches = math.ceil(SWEEP_EVAL_ROWS / B)
    want = 4 + 2 * eval_batches      # 2 step pairs, 2 eval passes
    check(all(got['launches'] == want for got in ranks),
          f'rank dequant launches {[g["launches"] for g in ranks]}, '
          f'expected {want}')

    def report(label, gaps, tol):
        held = lambda k: f'(tol {tol[k]:.0e})' if k in tol else '(printed)'
        phase(37, f'{label}: metrics max rel {gaps["metrics"]:.3e} '
                  f'{held("metrics")}; Adam m, v max abs / leaf max '
                  f'{gaps["adam"]:.3e} {held("adam")}, rel L2 m '
                  f'{gaps["adam_m_l2"]:.3e} {held("adam_m_l2")}, v '
                  f'{gaps["adam_v_l2"]:.3e} {held("adam_v_l2")}; params '
                  f'outside rtol 2e-4 atol 1e-6: {gaps["outside"]}, within '
                  f'{gaps["adam_step"]:.3e} x lr of their Adam step (tol '
                  f'0.25)')
        print(f'  worst leaf: {gaps["adam_at"]}', flush=True)
        bad = [k for k in tol if gaps[k] > tol[k]]
        check(not bad and gaps['adam_step'] <= 0.25,
              f'{label}: off ({bad})')

    for dt in ('float32', 'bfloat16'):
        # NCCL against gloo ranks on one card: the same per-rank
        # arithmetic, so phase 31's rules
        if len(results) == 2:
            report(f'{world} nccl ranks vs {world} gloo ranks on cuda:0, '
                   f'{dt}, one sup and one unsup step from one state',
                   dp_step_gaps([g['pairs'][dt] for g in results['nccl']],
                                results['gloo'][0]['pairs'][dt], train_cfg),
                   dict(metrics=1e-5, adam=2e-4))
        # the ranks against one process at B rows: metrics 1e-4 rel and
        # the moments as one vector (rel L2); a leaf's max-relative gap is
        # printed, not held: a B-row step sums each gradient in another
        # order than `world` steps of B/world rows, and a leaf of
        # near-cancelling terms magnifies that (2.3e-2 of the largest
        # value of decoder.conv1t.weight's Adam m on four H100s)
        tol = (dict(metrics=1e-4, adam_m_l2=1e-3, adam_v_l2=1e-3)
               if dt == 'float32' else
               dict(metrics=BF16_TOL['metrics'],
                    adam_m_l2=BF16_TOL['adam_m_l2'],
                    adam_v_l2=BF16_TOL['adam_v_l2']))
        report(f'{world} {backend} ranks vs 1 process, {dt}, one sup and '
               f'one unsup step from one state at global batch {B} ({b} a '
               f'rank)', dp_step_gaps([g['pairs'][dt] for g in ranks],
                                      ref[dt], train_cfg), tol)
    if len(results) == 2:
        check(results['nccl'][0]['evals'] == results['gloo'][0]['evals'],
              f'eval: nccl ranks {results["nccl"][0]["evals"]} != gloo '
              f'ranks {results["gloo"][0]["evals"]}')
    gap = abs(ranks[0]['evals']['resident'] - ref_eval['resident'])
    check(gap <= 1e-3 and ref_eval['resident'] == ref_eval['shipped'],
          f'eval on the ranks {ranks[0]["evals"]} vs one process '
          f'{ref_eval}')
    out['ranks'] = dict(world=world, backend=backend,
                        launches_per_rank=ranks[0]['launches'])
    phase(37, f'{world} {backend} ranks ({spawn_s[backend]:.1f} s with '
              f'their start): '
              f'dequant bit-equal to plain at ({b}, 64, 64, 3) on each, '
              f'{ranks[0]["launches"]} dequant launches a rank; eval over '
              f'{SWEEP_EVAL_ROWS} rows ({math.ceil(SWEEP_EVAL_ROWS / world)} '
              f'resident a rank, the last with padding) resident == shipped '
              f'on every rank ({ranks[0]["evals"]["resident"]:.6f}), one '
              f'process {ref_eval["resident"]:.6f} (|diff| {gap:.2e}, tol '
              f'1e-3); all_gather_into_tensor calls a rank '
              f'{[g["gathers"] for g in ranks]}; card {smi}')
    return out


#: phase 38: the recorded head-to-head's corpus size, epochs and batch
#: (docs/HEAD2HEAD.md), its parity tolerance, and the learning floor: the
#: port's test accuracy must beat the test split's majority-class accuracy
#: by H2H_FLOOR (the recorded legs sit at 0.56-0.74, chance about 0.5)
H2H_N = 2100
H2H_EPOCHS = 12
H2H_BS = 64
H2H_TOL = 0.06
H2H_FLOOR = 0.03
#: the recorded legs: every cell's reference and gltvae legs, and for
#: training seed 4 of fixed/one-one sup=1.0 the reference's leg and
#: gltvae's (the posterior-locs panel's relu run at seed 4)
H2H_RECORD = os.path.join(ROOT, 'docs', 'artifacts', 'h2h_results.json')
REF_SEED_PANEL = os.path.join(ROOT, 'docs', 'artifacts',
                              'ref_seed_panel.json')
GLTVAE_SEED_PANEL = os.path.join(ROOT, 'docs', 'artifacts',
                                 'posterior_locs_seed_panel.json')
#: --h2h-only: the recorded matrix as harness invocations into one
#: workdir (the harness merges them): 8 cells at 12 epochs, fixed/one-one
#: sup=1.0 at 30 (its recorded leg's length), and that cell at 12 epochs
#: with training seeds 1-4
H2H_MATRIX = (
    [['--modes', 'fixed/inferred', 'learnable/inferred',
      '--sups', '1.0', '0.5', '0.2', '--epochs', '12'],
     ['--modes', 'fixed/one-one', '--sups', '0.5', '0.2', '--epochs', '12'],
     ['--modes', 'fixed/one-one', '--sups', '1.0', '--epochs', '30']]
    + [['--modes', 'fixed/one-one', '--sups', '1.0', '--epochs', '12',
        '--train-seed', str(s)] for s in (1, 2, 3, 4)])


def parse_h2h_tag(tag):
    """'fixed/one-one/sup=1.0/tseed=2' -> ('fixed', 'one-one', 1.0, 2);
    the seed is None without a tseed part."""
    parts = tag.split('/')
    seed = int(parts[3].split('=')[1]) if len(parts) > 3 else None
    return parts[0], parts[1], float(parts[2].split('=')[1]), seed


def recorded_legs(tag):
    """(reference leg, gltvae leg) of a head-to-head cell as recorded in
    the repo."""
    with open(H2H_RECORD) as f:
        record = json.load(f)
    if tag in record:
        return record[tag]['reference'], record[tag]['gltvae']
    check(parse_h2h_tag(tag) == ('fixed', 'one-one', 1.0, 4),
          f'no recorded leg for {tag}')
    with open(REF_SEED_PANEL) as f:
        ref = json.load(f)['seed4']
    with open(GLTVAE_SEED_PANEL) as f:
        glt = json.load(f)['locs=relu/seed=4']
    return ref, glt


def write_reference_leg(workdir, tag, leg):
    """Write a recorded reference leg where the harness's
    ``--skip-reference`` reuses it: ``run_reference``'s
    <workdir>/ref_{gate_type}_{gate_subtype}_{sup}[_s{seed}].json."""
    gate_type, gate_subtype, sup, seed = parse_h2h_tag(tag)
    name = f'ref_{gate_type}_{gate_subtype}_{sup}' + (
        '' if seed is None else f'_s{seed}')
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f'{name}.json')
    with open(path, 'w') as f:
        json.dump(leg, f, indent=2)
    return path


def majority_accuracy(data_dir, n):
    """The test split's majority-class accuracy: each easy attribute
    predicted as its more frequent value over the test rows (the CLI's
    --n-* splits: the last n // 7 of the CSV's first n rows), averaged
    over the attributes and rows."""
    import numpy as np
    from gltvae_torch.data.celeba import load_attr_csv
    from gltvae_torch.parity_head2head import splits
    _, labels = load_attr_csv(os.path.join(data_dir, 'list_attr_celeba.csv'))
    n_tr, n_va, n_te = splits(n)
    p = labels[n_tr + n_va:n_tr + n_va + n_te].mean(0)
    return float(np.maximum(p, 1 - p).mean())


def h2h_steps(n, sup, bs, epochs):
    """(train steps, eval batches) of one port leg: the reference loader's
    ceil(rows / bs) batches an epoch for each of the sup and unsup parts of
    the train split (the sup part its first int(rows * sup)), and for the
    valid split each epoch and the test split once."""
    from gltvae_torch.parity_head2head import splits
    n_tr, n_va, n_te = splits(n)
    k = n_tr if sup == 1.0 else int(n_tr * sup)
    per_epoch = -(-k // bs) + -(-(n_tr - k) // bs)
    return epochs * per_epoch, epochs * -(-n_va // bs) + -(-n_te // bs)


def run_h2h(argv, dev, cells):
    """``parity_head2head.main(argv)`` with its port leg run in this process
    (``cli.main`` on the command's arguments, so the wrappers' launch
    counts see it; any other command fails the phase). Each port leg
    appends to `cells`: its wall, dequant and augment launches, and the
    shapes dequant saw. Returns (results, printed text)."""
    import gltvae_torch.train.steps as tsteps
    from gltvae_torch import cli, parity_head2head
    from gltvae_torch.ops import preprocess
    seen = []

    def port_leg(cmd, **kw):
        check(cmd[1:3] == ['-m', 'gltvae_torch.cli'],
              f'the harness ran {cmd[:3]}: only the port leg runs here (the '
              f'reference legs are recorded)')
        sync(dev)
        preprocess.launches = preprocess.augment_launches = 0
        seen.clear()
        t0 = time.perf_counter()
        cli.main(cmd[3:])
        sync(dev)
        cells.append(dict(s=time.perf_counter() - t0,
                          launches=(preprocess.launches,
                                    preprocess.augment_launches),
                          shapes=sorted(set(seen))))
        return subprocess.CompletedProcess(cmd, 0)
    undo = [patched(subprocess, 'run', lambda f: port_leg),
            patched(tsteps, 'dequant', lambda f: lambda x, *a: (
                seen.append(tuple(x.shape)), f(x, *a))[1])]
    try:
        return captured(parity_head2head.main, argv)
    finally:
        for u in undo:
            u()


def h2h_line(tag, r, cell):
    """One printed line a head-to-head cell: the port's, the recorded
    reference's and gltvae's test accuracies, both deltas, the verdict at
    H2H_TOL, the wall and the port's img/s."""
    _, glt = recorded_legs(tag)
    port, ref = r['port']['test_accuracy'], r['reference']['test_accuracy']
    verdict = {None: 'n/a', True: 'PASS', False: 'FAIL'}[
        r['compare']['parity']]
    return (f'h2h {tag}: port {port:.4f}, ref {ref:.4f}, gltvae '
            f'{glt["test_accuracy"]:.4f}; delta vs ref {port - ref:+.4f}, '
            f'vs gltvae {port - glt["test_accuracy"]:+.4f}; {verdict} at tol '
            f'{H2H_TOL}; wall {cell["s"]:.1f} s, '
            f'{r["port"]["images_per_sec"]:.0f} img/s')


def dequant_at(shp, dev, smi):
    """Dequant bit-equal to its plain version (divide and multiply forms)
    on the device and the CPU at `shp`; on the card timed beside its
    bound over inputs cycled past the 50 MB L2. Returns the timing (None
    off the card)."""
    import torch
    from gltvae_torch.ops import preprocess
    from gltvae_torch.time_kernels import (cuda_ms, cycler, dequant_bound_ms,
                                           memory_rate)
    gen = torch.Generator(device=dev).manual_seed(38)
    n = math.prod(shp)
    ins = [torch.randint(0, 256, shp, dtype=torch.uint8, device=dev,
                         generator=gen) for _ in range(-(-64 * 2**20 // n))]
    for mode in ('div', 'mul'):
        got = preprocess.dequant(ins[0], mode)
        check(torch.equal(got, preprocess.dequant_reference(ins[0], mode)),
              f'dequant {mode} {shp}: kernel != plain')
        check(torch.equal(got.cpu(), preprocess.dequant_reference(
            ins[0].cpu(), mode)), f'dequant {mode} {shp}: card != CPU')
    if dev.type != 'cuda':
        return None
    nxt = cycler(ins)
    ms, call_ms = cuda_ms(lambda: preprocess.dequant(nxt()), 100)
    plain, _ = cuda_ms(lambda: preprocess.dequant_reference(nxt()), 50)
    lib, _ = cuda_ms(lambda: nxt().float() / 255.0, 50)
    bound = dequant_bound_ms(n, memory_rate(torch.cuda.get_device_name(dev)))
    plan = preprocess.dequant_plan(ins[0].data_ptr(), 0, n)
    print(f'kernels dequant {shp}: kernel_ms {ms:.5f} ({call_ms:.5f}); '
          f'plain_ms {plain:.5f}; library_ms {lib:.5f}; bound_ms '
          f'{bound:.5f} ({n * 5} B, {bound / ms:.1%} of it); plan '
          f'{plan.tiles} tiles + {plan.tail} B tail; card {smi}', flush=True)
    return {'shape': list(shp), 'ms': ms, 'plain_ms': plain,
            'library_ms': lib, 'bound_ms': bound}


def h2h_phase(dev, smi):
    """Phase 38: the head-to-head harness's port leg on the device, one
    recorded cell at full size (learnable/inferred sup=0.2: learnable μ
    with temperature decay on the sup/unsup interleave), the reference leg
    reused from the recorded results. Returns the dequant launches and
    the timings at the path's shape."""
    work = os.path.join(ROOT, 'build', 'chip_smoke_h2h')
    shutil.rmtree(work, ignore_errors=True)
    tag = 'learnable/inferred/sup=0.2'
    ref, glt = recorded_legs(tag)
    ref_path = write_reference_leg(work, tag, ref)
    report = os.path.join(work, 'HEAD2HEAD.md')
    cells = []
    results, text = run_h2h([
        '--workdir', work, '--modes', 'learnable/inferred', '--sups', '0.2',
        '--epochs', str(H2H_EPOCHS), '--bs', str(H2H_BS), '--n', str(H2H_N),
        '--skip-reference', '--device', str(dev), '--report', report], dev,
        cells)
    data_dir = os.path.join(work, 'ref_root', 'data')
    check(list(results) == [tag] and len(cells) == 1
          and results[tag]['reference'] == ref
          and results[tag]['port']['framework'] == 'gltvae_torch',
          f'harness results {list(results)}, {len(cells)} port legs')
    with open(os.path.join(work, 'h2h_results.json')) as f:
        check(json.load(f) == results, 'h2h_results.json != the returned '
                                       'results')
    with open(report) as f:
        check(f'=== {tag}: port leg ===' in text and 'parity: ' in text
              and f'| {tag} |' in f.read(),
              f'harness text or report: {text[-300:]!r}')
    with open(os.path.join(work, 'port_models', 'params_0.2_learnable',
                           'result.json')) as f:
        device = json.load(f)['device']
    check(device == str(dev), f'the port leg ran on {device}, not {dev}')
    port, cell = results[tag]['port'], cells[0]
    check(len(port['val_accuracy']) == H2H_EPOCHS
          and math.isfinite(port['test_accuracy']),
          f'{len(port["val_accuracy"])} val accuracies, test '
          f'{port["test_accuracy"]}')
    steps, eval_batches = h2h_steps(H2H_N, 0.2, H2H_BS, H2H_EPOCHS)
    check(cell['launches'] == (steps + eval_batches, 0),
          f'dequant, augment launches {cell["launches"]} for {steps} steps '
          f'+ {eval_batches} eval batches')
    # every batch is whole: the loaders wrap around as the reference's
    # does, so the last eval batch of a split (44 of 300 rows at bs 64) is
    # completed from the split's front
    shape = (H2H_BS, 64, 64, 3)
    check(cell['shapes'] == [shape],
          f'dequant saw {cell["shapes"]}, expected only {shape}')
    floor = majority_accuracy(data_dir, H2H_N) + H2H_FLOOR
    check(port['test_accuracy'] >= floor,
          f'learning floor: test accuracy {port["test_accuracy"]:.4f} < '
          f'the test split\'s majority-class accuracy + {H2H_FLOOR} = '
          f'{floor:.4f}')
    timed = dequant_at(shape, dev, smi)
    phase(38, f'parity_head2head --modes learnable/inferred --sups 0.2 '
              f'--epochs {H2H_EPOCHS} --bs {H2H_BS} --n {H2H_N} '
              f'--skip-reference (recorded leg {os.path.basename(ref_path)}) '
              f'on {device}: {steps} steps + {eval_batches} eval '
              f'batches, dequant launches {cell["launches"][0]} at '
              f'{cell["shapes"]} (bit-equal to plain there); val accuracies '
              f'{len(port["val_accuracy"])}, test '
              f'{port["test_accuracy"]:.4f} >= floor {floor:.4f} (majority '
              f'+ {H2H_FLOOR}); report {report}')
    print(h2h_line(tag, results[tag], cell) + f'; gltvae delta vs ref '
          f'{glt["test_accuracy"] - ref["test_accuracy"]:+.4f} (recorded); '
          f'card {smi}', flush=True)
    return {'launches': cell['launches'][0], 'shape': timed}


def h2h_matrix(dev, smi, out_dir=None):
    """--h2h-only: the recorded matrix (H2H_MATRIX) through the harness's
    port leg into one workdir, each reference leg reused from the recorded
    results: one line a cell, the harness's summary and report. Each port
    leg is held to the device, its epochs of val accuracies, a finite test
    accuracy and its dequant launches; the verdicts are printed, not
    held. With `out_dir`, the results, the report and each cell's wall
    and launches are copied there after each invocation. Returns the
    results."""
    from gltvae_torch import parity_head2head as h2h
    work = os.path.join(ROOT, 'build', 'chip_smoke_h2h_matrix')
    shutil.rmtree(work, ignore_errors=True)
    report = os.path.join(work, 'HEAD2HEAD_torch.md')
    walls, results, text = {}, {}, ''
    for extra in H2H_MATRIX:
        argv = ['--workdir', work, '--bs', str(H2H_BS), '--n', str(H2H_N),
                '--skip-reference', '--device', str(dev), '--report',
                report] + extra
        args = h2h.parse_args(argv)
        want = {tuple(m.split('/')) for m in args.modes}
        tags = [f'{g}/{s}/sup={sup}' + ('' if args.train_seed is None else
                                       f'/tseed={args.train_seed}')
                for g, s in h2h.MODES if (g, s) in want for sup in args.sups]
        for tag in tags:
            write_reference_leg(work, tag, recorded_legs(tag)[0])
        cells = []
        results, text = run_h2h(argv, dev, cells)
        check(len(cells) == len(tags), f'{len(cells)} port legs for {tags}')
        run_dir = os.path.join(work, 'port_models' + (
            '' if args.train_seed is None else f'_s{args.train_seed}'))
        for tag, cell in zip(tags, cells):
            port = results[tag]['port']
            g, s, sup, _ = parse_h2h_tag(tag)
            steps, eval_batches = h2h_steps(H2H_N, sup, H2H_BS, args.epochs)
            run_name = (f'params_{sup}_{g}' if g == 'learnable'
                        else f'params_{sup}_{g}_{s}')
            with open(os.path.join(run_dir, run_name, 'result.json')) as f:
                device = json.load(f)['device']
            check(device == str(dev)
                  and len(port['val_accuracy']) == args.epochs
                  and math.isfinite(port['test_accuracy'])
                  and cell['launches'] == (steps + eval_batches, 0),
                  f'{tag}: on {device}, {len(port["val_accuracy"])} val '
                  f'accuracies, test {port["test_accuracy"]}, launches '
                  f'{cell["launches"]} for {steps} steps + {eval_batches} '
                  f'eval batches')
            walls[tag] = dict(seconds=cell['s'], steps=steps,
                              dequant_launches=cell['launches'][0],
                              images_per_sec=port['images_per_sec'])
            print(h2h_line(tag, results[tag], cell) + f'; card {smi}',
                  flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            for f in ('h2h_results.json', os.path.basename(report)):
                shutil.copy(os.path.join(work, f), out_dir)
            with open(os.path.join(out_dir, 'h2h_walls.json'), 'w') as f:
                json.dump(dict(card=smi, cells=walls), f, indent=2)
    print('h2h ' + text.strip().splitlines()[-1] + f'; report {report}; '
          f'card {smi}', flush=True)
    return results


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description='Smoke run of the port on the '
                                'GPU (phases 1-38; see the module text).')
    p.add_argument('--sweep-only', action='store_true',
                   help='phases 1-2 and 37 only: the sweep in one process '
                        'and, with 2 or more cards, on min(cards, 4) NCCL '
                        'ranks (the four-card check)')
    p.add_argument('--h2h-only', action='store_true',
                   help='phases 1-2, then the recorded head-to-head matrix '
                        'through the harness\'s port leg (13 runs of 12 '
                        'or 30 epochs on the 2,100-image parity corpus)')
    p.add_argument('--h2h-out', default=None,
                   help='with --h2h-only: a folder to copy the results, the '
                        'report and the walls into')
    args = p.parse_args(argv)
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

    if args.sweep_only or args.h2h_only:
        if args.sweep_only:
            print(json.dumps({'sweep': sweep_phase(dev, smi)}), flush=True)
        if args.h2h_only:
            h2h_matrix(dev, smi, args.h2h_out)
        print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                                 'kind': card_name,
                                                 'count': count}}),
              flush=True)
        return 0

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
    # phase 30 holds a mesh of one to this run
    ref5 = dict(state=main_run['trainer'].state.state_dict(),
                rows=main_run['rows'], launches=main_launches,
                step_med=step_med)
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

    # ---------------------------------------------------------- 23-26
    served = serving_phases(dev, smi, celeba)

    # ---------------------------------------------------------- 27-29
    host = host_phases(dev, smi, celeba)

    # ---------------------------------------------------------- 30-31
    dp = dp_phases(dev, smi, ref5, model_cfg, train_cfg, splits, model_a,
                   train_a, splits_a)

    # ---------------------------------------------------------- 32-36
    tools = experiment_phases(dev, smi, celeba)
    tools.update(measure_phases(dev, smi))

    # ------------------------------------------------------------- 37
    sweep = sweep_phase(dev, smi)

    # ------------------------------------------------------------- 38
    h2h = h2h_phase(dev, smi)

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
        # phases 24 and 26: inference from the .h5 folder, the warm
        # start's test (null where h5py is absent), preprocess_batch
        'launches_infer_h5': served['infer_h5'],
        'launches_warm_start': served['warm_start'],
        'launches_preprocess_batch': served['preprocess_batch'],
        # phases 27-29: the synthetic CLI run under --tensorboard
        # --debug-nans, the grain backend, the bench twin
        'launches_debug_nans': host['debug_nans'],
        'launches_grain': host['grain'],
        'launches_bench': host['bench'],
        # phases 30-31: the NCCL mesh of one; each of two gloo ranks on
        # the resident path and on the augmented path (eval only)
        'launches_mesh_nccl_1': dp['nccl_1'],
        'launches_mesh_gloo_2_per_rank': dp['gloo_2'],
        'launches_mesh_gloo_2_augment_per_rank': dp['gloo_2_augment'][1],
        # phases 33-37: the Table-1 matrix (9 cells), the seed panel (its
        # runs are subprocesses: not counted), bench_data's ship+step
        # rows, each profile_step mode, the sweep's one process at
        # (4096, 64, 64, 3) and each of its NCCL ranks (null on one card)
        'launches_matrix': tools['matrix'],
        'launches_seed_panel': tools['seed_panel'],
        'launches_bench_data': tools['bench_data'],
        'launches_profile': tools['profile'],
        'launches_sweep': sweep['one_process'],
        'launches_sweep_nccl_per_rank': (sweep['ranks'] or {}).get(
            'launches_per_rank'),
        'sweep_ranks': sweep['ranks'],
        'shape_4096': sweep.get('dequant_4096'),
        # phase 38: the head-to-head harness's port leg (12 epochs at bs
        # 64 on the 2,100-image parity corpus) and dequant at its one
        # shape, (64, 64, 64, 3)
        'launches_h2h': h2h['launches'],
        'shape_h2h': h2h['shape'],
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
        # phase 31: each of two gloo ranks, 512 images a launch
        'launches_mesh_gloo_2_per_rank': dp['gloo_2_augment'][0],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': card_name,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
