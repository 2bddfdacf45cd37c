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
    host, captured: every u8 batch bit-equal (a step's as its static
    input holds it, gathered on the card or copied in), metrics within
    phase 6's tolerance, both step medians;
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
    anchor: the captured decode (``eval/traversal.py``, one CUDA graph a
    grid) bit-equal to the eager one, card vs CPU within 1e-5, both timed
    in turns; ``render.traversal`` bit-equal to the captured grid; the
    render CLI's PNG;
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
    (printed as ``bench: ...``) with every key bench.py fills set, and
    each roofline's FLOPs and rate above 0;
30. a mesh of one rank over NCCL (``parallel.mesh.initialize_multihost``
    with a TCP coordinator and one process): phase 5's run through
    ``Trainer(mesh=)`` equals phase 5's run without a mesh bit for bit
    (params, Adam moments, every metric row) with its 22 dequant
    launches, captured against captured (the mesh's default over NCCL)
    and eager against eager, all on cuDNN's deterministic algorithms (the
    default ones do not repeat a run bit for bit);
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
    all_gather_into_tensor on NCCL; the NCCL ranks run the steps and evals
    once more captured, bit-equal to their eager leg or else within phase
    31's one-step rules with the gaps printed. On one card it says that
    NCCL across cards did not run and runs nothing in its place;
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
    0.06, the wall and the img/s are printed, not held;
39. the data-parallel CLI as a user runs it: ``python -m
    torch.distributed.run --standalone --nproc-per-node=D chip_smoke.py
    --dp-cli-rank ...`` (each rank ``cli.main`` with ``--mesh``, its state
    and files recorded), ``config.dp_sweep()[0]``'s command (learnable,
    sup 0.2, bf16, global batch 4096) on 65,536 synthetic images for 2
    epochs (34 steps), at D = 1 (a mesh of one over NCCL), against the
    same command in one process without ``--mesh``: every rank's
    end-of-training and restored states bit-equal to rank 0's (sha256 of
    params, Adam m and v), dequant bit-equal to plain at each rank's
    (4096/D, 64, 64, 3) and 40 launches a rank (34 steps + 6 eval
    batches), rank 0 alone writing result.json, model_config.json, the
    checkpoints and the μ files, the final state within a rel L2 bound of
    the one process's (``dp_cli_bounds``: 34 times phase 37's one-step
    tolerances) and test accuracy within 0.02; then ``torchrun ... -m
    gltvae_torch.infer --mesh`` at batch 256 over 448 JPEGs written from
    the seed, its CSV equal to the one-process ``infer``'s row for row;
    printed: the trainer meter's img/s, the last epoch's step wall, spawn
    to first step, and the device ms a step on the slowest card (NCCL's
    kernels apart) from a separate one-epoch run of the same command whose
    dispatches 4-11 are profiled; dequant timed at (1024, 64, 64, 3) and
    (2048, 64, 64, 3). Every D runs captured (the default over NCCL at
    every size), its Trainers held past ``cli.main`` (whose leaving the
    group releases their graphs), and the step wall is printed beside the
    eager one recorded on four cards, the profiled figure beside its own
    window's wall; each launch prints a timestamped line as it starts,
    each rank one before and after it leaves its group, and a rank still
    running 60 s before its kill dumps its Python stack into the kept
    log. Each process that fails or outlives 600 s fails the phase (its
    session killed);
40. the captured train step (``train/graphs.py``, gltvae's jitted step):
    (a) phase 5's model, 16 steps of the sup 0.5 interleave from one
    state, the temperature decayed halfway, eagerly (``jit=False``) and
    captured, on cuDNN's deterministic algorithms: params, Adam m and v
    and every metric bit-equal, or else within ``F32_TOL`` with the
    largest gap and its leaf printed; 16 dequant launches each, the
    captured ones counted at the replays; (b) the same for phase 13's
    128 px bf16 + s2d + remat 'dots' model under ``BF16_TOL``; (c) phase
    5's Trainer run with ``jit=True`` and ``jit=False``: metrics.csv equal
    row for row and the test accuracy equal; (d) a ``graphs_speed:`` JSON
    line for each of the plain step (bs 256, f32) and the sweep step
    (``dp_sweep()[0]``, bs 4096, bf16), eager and captured, run in turns:
    the median synchronized step wall of 50 steps, img/s, device ms a
    step and the busy share, host launches a step (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ... from torch.profiler; a captured step at most
    ``CAPTURED_STEP_LAUNCHES``), peak memory, the Trainer meter of (c),
    the card's name and power limit;
41. gltvae's compiled eval, ELBO and multi-step dispatches as CUDA graphs
    (``train/graphs.py``), on cuDNN's deterministic algorithms for
    (a)-(d): (a) phase 5's and phase 13's models, eval and ELBO passes
    over 512-image valid and test splits, resident epochs and chunked
    passes of 4 batches, stochastic and deterministic, captured against
    eager: values and the eval generator's state after bit-equal, dequant
    launches n a replay, draws into static slices equal to fresh draws,
    and the raw draws' gate uniforms made Gumbels (``steps.gate_gumbels``,
    as the graphs make them) equal to the Gumbel draws; (b) both models,
    16 steps of the interleave in chunks of 4, 4, 4, 3 and 1 (three mask
    patterns), shipped and gathered from resident
    splits, and as 16 captured single steps, each against 16 eager steps
    (bit-equal, or else within ``F32_TOL`` / ``BF16_TOL`` with the gaps
    printed); (c) phase 9's augmented steps, per step and chunked at n =
    4, bit-equal to the eager augment then step, the augment launched
    inside the graphs; (d) phase 5's Trainer at steps_per_dispatch 4 and
    phase 9's augmented Trainer run with jit=True and jit=False:
    metrics.csv equal row for row and the test accuracy equal; (e)
    ``graphs_speed:`` lines for the eval passes (2,048 images, resident
    and in chunks of 4), a chunk of 4 plain steps, of 4 sweep steps and an
    augmented step, each eager, as per-batch or per-step replays and as
    one graph (median synchronized wall, img/s, device ms, busy, host
    launches, peak memory, the card), then
    phase 5's Trainer meter captured and eager on the default
    algorithms; (f) the tally of the
    graph audit (``audit_graphs``);
42. gltvae's compiled mesh dispatches: the data-parallel steps, chunks,
    eval and ELBO passes and inference as CUDA graphs with the NCCL
    collectives inside, on ranks spawned one a card (a mesh of one over
    NCCL; with ``--sweep-only`` on 2 or more cards also D = 2 and
    min(cards, 4)), each killed after 600 s and each printing a
    timestamped line as it starts a leg; (a)-(c) on cuDNN's
    deterministic algorithms: (a) phase 5's model, 16 steps of the
    interleave as single steps, as chunks of 4, 4, 4, 3 and 1 (shipped,
    and gathered from resident splits through ``gather_rows``) and as the
    shardmap steps, each captured against eager on the same mesh (at D =
    1 bit for bit, and the captured mesh equal to the captured run
    without a mesh; past one rank bit for bit or within ``F32_TOL`` with
    the gaps printed); (b) the eval and ELBO passes (resident epochs and
    chunks of 4, stochastic and deterministic) and phase 9's augmented
    steps and chunks, captured against eager, each rank's crops its rows
    of the one-process crops; (c) ``infer.make_predict`` over the batches
    of 448 JPEGs from the seed, deterministic and stochastic, on one
    device and on the mesh: captured probabilities bit-equal to eager;
    (d) each rank's graph audit, which also holds a mesh graph's NCCL
    kernel nodes to the collectives its capture issued (none on a mesh of
    one, where NCCL launches no kernel); (e) a ``dp_graphs_speed:`` JSON
    line for ``config.dp_sweep()[0]``'s step (bf16, global batch 4096,
    4096/D rows a rank) and a chunk of 4, eager and captured: first call,
    waited and back-to-back walls, img/s, device ms and NCCL ms on the
    slowest rank, busy share, host launches, peak memory, the card; and
    the phase's wall. A rank still running 30 s before its kill dumps its
    Python stack;
43. leaving a group with a captured program alive: ``torchrun`` of D
    NCCL ranks (each of ``--worlds`` past one; D = 1 where there is no
    such world, as on one card), each capturing ``config.dp_sweep()[0]``'s
    data-parallel sup step (bf16, global batch 4096) by default, running
    it twice, keeping it, and calling ``parallel.mesh.shutdown`` under a
    60 s bound (a rank still inside dumps its stack and exits 1): every
    rank must print that it left its group, its step registered with the
    mesh, holding its collectives, and released, and the held step run
    again must raise, naming the group it left.

Phases 5, 9, 11, 13, 18-22, 27-29 and 33-38 train and evaluate through
captured programs (the Trainer's default on one device and on an NCCL
mesh of one); phase 30 runs both ways, with and without the mesh of one;
phases 31, 39 and 43 run on meshes (31 over gloo on one card, eager; 39
and 43 over NCCL, captured). The dequant and
augment launches of captured programs are counted at their replays
(``train/graphs.py``), and every program captured in this process is
audited at its capture (``audit_graphs``, after phase 2): its graph must
hold the dequant and the augment kernel as often as the capture counted.
Phase 41 (f) prints the audit's tally; phases 37 and 40 (d) also print
how many dequant kernels torch.profiler saw run.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}. ``--sweep-only`` runs phases 1-2, 37, 42,
43 and 39 alone (the check to run on four cards: phases 42, 43 and 39
then also at D = 2 and min(cards, 4), one rank a card; ``--worlds 2,4``
picks their rank counts, to leave out D = 1, which every whole run
covers); ``--teardown-only`` runs phases 1-2 and 43 (at ``--worlds``);
``--graphs-only`` runs
phases 1-2 and 40-42. ``--h2h-only`` runs phases 1-2,
then the recorded head-to-head matrix through the harness in one workdir
(9 cells at 12 epochs but fixed/one-one sup=1.0 at 30, and that cell at
12 epochs with training seeds 1-4), one line a cell, and ``--h2h-out DIR``
copies its results, report and walls to DIR. Run artifacts go to
build/chip_smoke*/.
"""

import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

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
    gets a copy of every uint8 batch a step or an eval pass dequantizes:
    a captured program's as its static inputs hold it before the run
    (copied in, or the resident split's rows at its static indices, which
    its graph gathers), an eager dispatch's where it dequantizes. Returns
    what the run measured."""
    import torch
    import gltvae_torch.train.steps as tsteps
    from gltvae_torch.train import graphs
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
    undo = []
    if record is not None:
        inside = []         # a captured program is running

        def keep(x):
            if x.dtype == torch.uint8:
                record.append(x.clone())

        def program(f):
            def run(self, owner):
                for b in self.batches():    # what its next run reads
                    keep(b)
                inside.append(1)
                try:
                    return f(self, owner)
                finally:
                    inside.pop()
            return run
        undo = [patched(tsteps, '_prep_image', lambda f: lambda x, size: (
                    None if inside else keep(x), f(x, size))[1]),
                patched(graphs.Captured, '__call__', program)]
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
        for u in undo:
            u()
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


#: The dequant kernel's name in torch.profiler's device events
#: (gltvae_torch/csrc/dequant.cu).
DEQUANT_KERNEL = 'dequant_kernel'


def device_launches(events, kernel=DEQUANT_KERNEL):
    """How many times `kernel` ran on the card among torch.profiler's
    `events` (``key_averages()``), the kernels of a graph's replays
    included: the launches a replay makes without calling a wrapper."""
    import torch
    return sum(e.count for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.key)


#: The augment kernel's name in a graph's node dump
#: (gltvae_torch/csrc/augment.cu).
AUGMENT_KERNEL = 'augment_kernel'

#: The node kinds of a graph's dump (``cudaGraphDebugDotPrint``), each
#: node's record starting with its kind.
NODE_KINDS = ('KERNEL', 'MEMCPY', 'MEMSET', 'HOST', 'GRAPH', 'EMPTY',
              'WAIT_EVENT', 'EVENT_RECORD', 'EXT_SEMAS_SIGNAL',
              'EXT_SEMAS_WAIT', 'MEM_ALLOC', 'MEM_FREE', 'BATCH_MEM_OP',
              'CONDITIONAL')


def nccl_nodes(text):
    """The kernel nodes of a graph's dump that run an NCCL kernel: the
    records that start with KERNEL and name a kernel ``nccl...`` before
    the next node's kind."""
    import re
    parts = re.split(r'\b(' + '|'.join(NODE_KINDS) + r')\b', text)
    return sum(1 for kind, body in zip(parts[1::2], parts[2::2])
               if kind == 'KERNEL' and 'nccl' in body.lower())


def mesh_world():
    """The world size of this process's default group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def audit_graphs():
    """From here on, each program captured in this process (a train step
    or chunk, an eval or ELBO pass; ``train/graphs.py``) keeps its graph
    (``keep_graph``) and is audited at its capture: the graph's kernel
    nodes (``CUDAGraph.debug_dump``) must hold the dequant kernel and the
    augment kernel as often as the capture counted
    (``Captured.dequant_launches``, ``augment_launches``), the launches
    each replay adds to ``preprocess.launches`` and ``augment_launches``.
    On a mesh of more than one rank the graph must also hold one NCCL
    kernel node for each collective its capture issued
    (``Captured.collectives``, counted at the ``Mesh`` methods); NCCL's
    one-rank path launches no kernel (an in-place reduce or broadcast is a
    no-op, a gather one copy), so on a mesh of one it must hold none.
    A graph that differs fails the phase that captured it. Returns the
    running tally {'graphs', 'dequant_nodes', 'augment_nodes',
    'nccl_nodes', 'collectives', 'mesh_graphs' (graphs with collectives),
    'kinds': {class name: graphs}, 'capture_s': {class name: seconds of
    warm-up and capture}, 'dump_s': seconds of the audit's own dumps};
    the audit stays on."""
    import warnings

    import torch
    from gltvae_torch.train import graphs
    tally = {'graphs': 0, 'dequant_nodes': 0, 'augment_nodes': 0,
             'nccl_nodes': 0, 'collectives': 0, 'mesh_graphs': 0,
             'kinds': {}, 'capture_s': {}, 'dump_s': 0.0}
    # one file a process: the ranks of a mesh capture the same graphs at
    # the same moment, and a shared file let one rank read or remove
    # another's dump
    dump = os.path.join(ROOT, 'build', f'graph_audit_{os.getpid()}.dot')
    os.makedirs(os.path.dirname(dump), exist_ok=True)

    def capture(fn, pool, error_mode='global'):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=error_mode):
            out = fn()
        graph.instantiate()
        return graph, out

    def audited(f):
        def run(self, owner):
            t = time.perf_counter()
            f(self, owner)
            sync(self.device)
            t1 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                self.graph.debug_dump(dump)
            with open(dump) as fh:
                text = fh.read()
            os.remove(dump)
            nodes = (text.count(DEQUANT_KERNEL), text.count(AUGMENT_KERNEL))
            kind = type(self).__name__
            check(nodes == (self.dequant_launches, self.augment_launches),
                  f'a captured {kind}\'s graph holds {nodes[0]} dequant '
                  f'and {nodes[1]} augment kernel nodes; its capture '
                  f'counted {self.dequant_launches} and '
                  f'{self.augment_launches}')
            nccl = nccl_nodes(text)
            want = self.collectives if mesh_world() > 1 else 0
            check(nccl == want,
                  f'a captured {kind}\'s graph holds {nccl} NCCL kernel '
                  f'nodes; its capture issued {self.collectives} '
                  f'collectives on a mesh of {mesh_world()} (expected '
                  f'{want} nodes); its kernel names: '
                  f'{sorted(set(_kernel_names(text)))[:12]}')
            tally['graphs'] += 1
            tally['dequant_nodes'] += nodes[0]
            tally['augment_nodes'] += nodes[1]
            tally['nccl_nodes'] += nccl
            tally['collectives'] += self.collectives
            tally['mesh_graphs'] += self.collectives > 0
            tally['kinds'][kind] = tally['kinds'].get(kind, 0) + 1
            tally['capture_s'][kind] = (tally['capture_s'].get(kind, 0.0)
                                        + t1 - t)
            tally['dump_s'] += time.perf_counter() - t1
        return run
    patched(graphs, '_cuda_capture', lambda f: capture)
    patched(graphs.Captured, '_capture', audited)
    return tally


def _kernel_names(text):
    """The names in a graph's dump that look like kernels' (for a
    failing audit's message)."""
    import re
    return re.findall(r'[A-Za-z_]\w*(?:[Kk]ernel|KERNEL)\w*', text)


def audit_line(tally, n=41):
    """Phase `n`'s line for audit_graphs' tally (none audited fails)."""
    check(tally['graphs'] > 0, 'no captured graph was audited')
    secs = {k: round(v, 3) for k, v in tally['capture_s'].items()}
    phase(n, f'(f) every program captured in this process audited at its '
             f'capture: {tally["graphs"]} graphs ({tally["kinds"]}) holding '
             f'{tally["dequant_nodes"]} dequant and '
             f'{tally["augment_nodes"]} augment kernel nodes, each graph '
             f'as many as its capture counted (the launches its replays '
             f'add to the counts); seconds of warm-up and capture by kind '
             f'{secs}, of the audit\'s dumps {tally["dump_s"]:.3f}')


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
    # the padded batches the captured chunks crop in their graphs
    shapes = r19['shapes']
    check(r19['launches'] == (6, 4)
          and shapes == [(4, BATCH, 72, 72, 3)] * 4,
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
    # a captured step calls the wrappers at its warm-up and capture only,
    # so the shapes are held as a set and the launches by the count
    check(dr_launches == (12, 0) and set(seen) == {full}
          and set(resized) == {(BATCH, 218, 178, 3)},
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

    def grids(m, d, jit):
        """Both grids of `m` on `d`, each a traversal made once: every
        latent dim from z = 0, and render's z_classify rows from the prior
        anchor."""
        anchors = {'all dims, z=0': (None, torch.zeros(cfg.z_dim, device=d)),
                   'z_classify, prior': (list(range(cfg.z_style, cfg.z_dim)),
                                         render.prior_anchor(m, (), 0))}
        return {k: functools.partial(make_traversal_fn(m, dims=dims,
                                                       jit=jit), z)
                for k, (dims, z) in anchors.items()}
    gaps, got = {}, {}
    # compared on cuDNN's deterministic algorithms, as phases 40-42 compare
    # (on the default ones cuDNN may pick another algorithm for a capture)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fns = {'graph': grids(models[dev], dev, True),
               'eager': grids(models[dev], dev, False),
               'cpu': grids(models[cpu], cpu, False)}
        for name in fns['graph']:
            got[name] = fns['graph'][name]().cpu()  # the first call captures
            eager, want = fns['eager'][name]().cpu(), fns['cpu'][name]()
            check(got[name].shape == want.shape
                  and torch.isfinite(got[name]).all()
                  and got[name].shape[2:] == (cfg.image_size,
                                              cfg.image_size, 3),
                  f'traversal {name}: shape {tuple(got[name].shape)}')
            check(torch.equal(got[name], eager), f'traversal {name}: the '
                  f'graph differs from the eager decode (max abs '
                  f'{float((got[name] - eager).abs().max()):.3e})')
            gaps[name] = (tuple(got[name].shape),
                          float((got[name] - want).abs().max()))
        check(torch.equal(render.traversal(models[dev], anchor='prior').cpu(),
                          got['z_classify, prior']),
              'render.traversal differs from the z_classify grid')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(gaps['all dims, z=0'][0][:2] == (cfg.z_dim, 8)
          and gaps['z_classify, prior'][0][:2] == (cfg.z_classify, 8),
          f'traversal grids {gaps}')
    check(all(g <= 1e-5 for _, g in gaps.values()),
          f'traversal card vs CPU over 1e-5: {gaps}')
    # timed on the default algorithms, each form made anew
    timed = {how: grids(models[dev], dev, how == 'graph')
             for how in ('graph', 'eager')}
    ms = {name: {how: median_ms(timed[how][name], dev)
                 for how in ('eager', 'graph', 'graph', 'eager')}
          for name in got}
    png = os.path.join(build, 'chip_smoke_traversal.png')
    render.main(['--mode', 'traversal', '--anchor', 'prior', '--checkpoint',
                 run_dir, '--out', png, '--device', str(dev)])
    from PIL import Image
    png_shape = np.asarray(Image.open(png)).shape
    check(png_shape == (cfg.z_classify * cfg.image_size,
                        8 * cfg.image_size, 3), f'render PNG {png_shape}')
    phase(23, f'traversal on the card and the CPU from the phase-18 '
              f'weights: ' + '; '.join(
                  f'{k} {s[0] * s[1]} images, the graph bit-equal to the '
                  f'eager decode, card vs CPU max abs {g:.3e}'
                  for k, (s, g) in gaps.items())
          + f' (tol 1e-5; on cuDNN\'s deterministic algorithms); '
            f'render.traversal (its own graph) bit-equal to the z_classify '
            f'grid; render PNG {png_shape}')
    print('slice_traversal: ' + '; '.join(
        f'{k} {gaps[k][0][0] * gaps[k][0][1]} images eager '
        f'{v["eager"]:.3f} ms, graph {v["graph"]:.3f} ms per grid'
        for k, v in ms.items())
        + f' (median of 20 synchronized calls after 3, the later of two '
          f'turns eager, graph, graph, eager, on the default algorithms); '
          f'card {smi}', flush=True)

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
    # each roofline present and above 0 (a count made on a graph's replay
    # reads 0: fault F3); on the CPU the rate rounds to 0 at 3 decimals
    unset += [f'{r}.{k}' for r in ('roofline', 'eval_roofline',
                                   'eval_roofline_resident')
              for k in ('step_gflops', 'achieved_tflops_per_sec')
              if not (dev.type == 'cpu' and k == 'achieved_tflops_per_sec')
              and not ((line[r] or {}).get(k) or 0) > 0]
    check(not unset, f'bench: null or zero values {unset}')
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


def one_steps(model_cfg, train_cfg, mu, batches, dev, mesh=None, jit=None):
    """One sup step and one unsup step, each from the initial state, on
    the global (x, y) `batches` (this rank's rows of them on a mesh), the
    makers' `jit`: the metrics and the state after each, and the initial
    params."""
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
        steps = make_train_steps(model, train_cfg, dp, jit)
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
        # eager, so that its crops can be kept (gloo over CUDA tensors is
        # eager anyway; a CPU mesh would crop inside its steps)
        aug = augmented_run(f'rank {rank} augmented', model_a, train_a,
                            splits_a, dev, f'chip_smoke_dp/aug{rank}',
                            mesh=mesh, jit=False)
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
        # each mode without and with the mesh: eager (jit=False) and
        # captured (the default on one device and over NCCL)
        runs = {(jit, on): train_and_test(
                    f'{"mesh of one" if on else "phase 5 again"}, '
                    f'{"captured" if jit else "eager"}, deterministic',
                    model_cfg, train_cfg, splits, dev,
                    f'chip_smoke_mesh1_{jit}_{on}', jit=jit,
                    **(dict(mesh=mesh) if on else {}))
                for jit in (False, True) for on in (False, True)}
    finally:
        pmesh.shutdown()
        torch.backends.cudnn.deterministic = deterministic
    strip = lambda rows: [{k: v for k, v in r.items() if k != 'time'}
                          for r in rows]
    for jit in (False, True):
        pair = [runs[(jit, on)] for on in (False, True)]
        check(all(r['trainer']._jit == jit for r in pair),
              f'phase 30 jit={jit}: dispatches not as asked')
        sds = [r['trainer'].state.state_dict() for r in pair]
        differ = [f'{g}.{k}' for g in ('params', 'adam_m', 'adam_v')
                  for k, v in sds[0][g].items()
                  if not torch.equal(v, sds[1][g][k])]
        check(not differ and strip(pair[1]['rows']) == strip(pair[0]['rows'])
              and sds[0]['adam_count'] == sds[1]['adam_count'],
              f'mesh of one != phase 5\'s run (jit={jit}): {differ[:5]}')
    launches = {k: r['launches'] for k, r in runs.items()}
    check(set(launches.values()) == {ref5['launches']},
          f'dequant launches {launches} != phase 5\'s {ref5["launches"]}')
    gap5 = max(float((runs[(True, False)]['trainer'].state.model
                      .state_dict()[k].cpu() - v).abs().max())
               for k, v in ref5['state']['params'].items())
    out['nccl_1'] = launches[(True, True)]
    med = {k: statistics.median(r['step_s'][1:]) for k, r in runs.items()}
    phase(30, f'mesh of one over {mesh.backend} on {mesh.device}: phase '
              f'5\'s run through Trainer(mesh=) equal to the same run '
              f'without a mesh bit for bit (params, Adam moments, '
              f'{len(runs[(True, True)]["rows"])} metric rows), captured '
              f'against captured (the mesh\'s default over NCCL) and eager '
              f'against eager, all on cuDNN\'s deterministic algorithms; '
              f'vs phase 5 itself params max abs {gap5:.3e}, not held; '
              f'dequant launches {launches[(True, True)]} in each run')
    print(f'slice_mesh1: step_ms median captured {med[(True, True)] * 1e3:.3f}'
          f' with the mesh of one, {med[(True, False)] * 1e3:.3f} without; '
          f'eager {med[(False, True)] * 1e3:.3f} with, '
          f'{med[(False, False)] * 1e3:.3f} without (deterministic cuDNN; '
          f'phase 5: {ref5["step_med"] * 1e3:.3f}; steps 2-16, '
          f'synchronized); card {smi}', flush=True)
    del runs

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
    # eager, so that its crops can be kept (a captured step crops inside
    # its graph)
    one = augmented_run('one-process augmented', model_a, train_a, splits_a,
                        dev, 'chip_smoke_dp/aug', jit=False)
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


def sweep_evals(model_cfg, train_cfg, mu, eval_split, dev, mesh=None,
                jit=None):
    """A fresh Trainer's (with `jit`) validation accuracy over
    `eval_split`, resident (a mesh's ranks exchange rows, gather_rows)
    and shipped (each batch's rows of this rank), with the matches
    gathered over the ranks (``DataParallel.mean_rows``)."""
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.train.loop import Trainer
    out = {}
    for name, mode in (('resident', 'auto'), ('shipped', 'off')):
        tr = Trainer(model_cfg, train_cfg, mu_init=mu, device=dev,
                     mesh=mesh, resident_eval=mode, jit=jit)
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
    ``one_steps`` at bf16 and f32 and ``sweep_evals`` eagerly, and on the
    NCCL ranks once more captured (``jit=True``); saves
    what it measured as <out_dir>/rank<r>.pt."""
    import dataclasses

    global ROOT
    ROOT = root
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.config import apply_precision
    dev = torch.device(devices[rank])
    nccl = dev.type == 'cuda' and dev.index == rank and world > 1 \
        and url.startswith('tcp')
    # TF32 off from the first step (the Trainer's setting): every leg of
    # every rank then runs the f32 convolutions alike
    apply_precision(model_cfg)
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
        legs = {}
        for jit in ((False, True) if nccl else (False,)):
            preprocess.launches = 0
            pairs = {dt: one_steps(dataclasses.replace(model_cfg,
                                                       compute_dtype=dt),
                                   train_cfg, mu, batches, dev, mesh, jit)
                     for dt in ('bfloat16', 'float32')}
            evals = sweep_evals(model_cfg, train_cfg, mu, eval_split, dev,
                                mesh, jit)
            sync(dev)
            legs[jit] = dict(pairs=pairs, evals=evals,
                             launches=preprocess.launches)
        torch.save(dict(legs[False], shape=shape, gathers=gathers[0],
                        backend=mesh.backend,
                        captured=legs.get(True)),
                   os.path.join(out_dir, f'rank{rank}.pt'))
        if nccl:            # a rank that hangs leaving its group shows
            print(f'[phase 37] rank {rank} of {world}: saved, leaving the '
                  f'group', flush=True)
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
    from gltvae_torch.config import apply_precision
    cuda = dev.type == 'cuda'
    name, model_cfg, train_cfg = dp_sweep()[0]
    train_cfg = dataclasses.replace(train_cfg, batch_size=SWEEP_BATCH)
    apply_precision(model_cfg)      # as the ranks and the Trainer
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
        counted = preprocess.launches
        if cuda:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                pair()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        else:
            pair()
        sync(dev)
        launches = preprocess.launches
        counted = launches - counted
        peak = (torch.cuda.max_memory_allocated(dev) - held) if cuda else 0
    finally:
        undo()
    check(all(math.isfinite(float(v)) for v in m.values()),
          f'{name}: metrics not finite at B={B}')
    check(launches == 6 and set(seen) == {(B, 64, 64, 3)},
          f'{name}: dequant launches {launches} at {seen}, expected 6 at '
          f'{(B, 64, 64, 3)}')
    table = kernel_table(events, 2, 5) if events else None
    out['one_process'] = launches
    phase(37, f'{name} (dp_sweep()[0]: {model_cfg.gate_type}/'
              f'{model_cfg.gate_subtype}, sup {train_cfg.perc_supervision}, '
              f'{model_cfg.compute_dtype}) at global batch {B} in one '
              f'process: a sup and an unsup step, 3 times each; dequant '
              f'launches {launches} at {(B, 64, 64, 3)}'
              + (f'; of the profiled pair\'s {counted}, torch.profiler '
                 f'saw {device_launches(events)} run on the card'
                 if cuda else ''))
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
    if 'nccl' in results:
        # the NCCL ranks' captured leg against their eager leg: the same
        # per-rank arithmetic, but NCCL may pick another algorithm under
        # capture, so past D = 2 the sum order can differ: bit-equal, or
        # else phase 31's one-step rules with the gaps printed
        nccl = results['nccl']
        for dt in ('float32', 'bfloat16'):
            same = all(
                torch.equal(got['captured']['pairs'][dt][i]['state'][g][k],
                            v)
                for got in nccl for i in range(2)
                for g in ('params', 'adam_m', 'adam_v')
                for k, v in got['pairs'][dt][i]['state'][g].items()) and all(
                got['captured']['pairs'][dt][i]['metrics']
                == got['pairs'][dt][i]['metrics']
                for got in nccl for i in range(2))
            if same:
                phase(37, f'{world} nccl ranks, {dt}: the captured leg '
                          f'bit-equal to the eager leg on every rank '
                          f'(params, Adam m and v, metrics)')
            else:
                for r, got in enumerate(nccl):
                    report(f'{world} nccl ranks, rank {r}, {dt}: the '
                           f'captured leg vs the eager leg, not bit-equal',
                           dp_step_gaps([got['captured']['pairs'][dt]],
                                        got['pairs'][dt], train_cfg),
                           dict(metrics=1e-5, adam=2e-4))
        evals = [got['captured']['evals'] for got in nccl]
        check(all(e == nccl[0]['evals'] for e in evals)
              and all(got['captured']['launches'] == want for got in nccl),
              f'nccl ranks: captured evals {evals} != eager '
              f'{nccl[0]["evals"]}, or dequant launches '
              f'{[g["captured"]["launches"] for g in nccl]} (expected '
              f'{want}, counted at the replays)')
        phase(37, f'{world} nccl ranks: the captured evals equal the eager '
                  f'ones ({evals[0]}); {want} dequant launches a rank in '
                  f'each leg')
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


#: phase 39: the data-parallel CLI through torchrun, ``config.dp_sweep()[0]``'s
#: command (learnable/inferred, sup 0.2, bf16, global batch 4096) on
#: DP_CLI_N synthetic train images for DP_CLI_EPOCHS epochs (sup 0.2 of
#: 65,536: 4 sup and 13 unsup batches, 17 steps an epoch), then ``infer
#: --mesh`` at batch DP_CLI_INFER_BS over a corpus of DP_CLI_PHOTOS (train,
#: valid, test) JPEGs from the seed (448: two batches, the second a
#: wrap-around tail); each process has DP_CLI_TIMEOUT seconds
DP_CLI_N = 65536
DP_CLI_EPOCHS = 2
DP_CLI_PHOTOS = (320, 64, 64)
DP_CLI_INFER_BS = 256
DP_CLI_TIMEOUT = 600.0
#: the D-rank run against the one process: test accuracy
DP_CLI_ACC_TOL = 0.02
#: the profiled run (one epoch, apart from the checked run so that its
#: meter and step walls carry no profiler cost): dispatches 4-11 on each
#: card, after the first of each kind has planned its cuDNN algorithms
DP_CLI_PROFILE = (4, 8)
SCRIPT = os.path.abspath(__file__)
#: the step wall (ms) of phase 39's CLI when its mesh dispatches were
#: eager, at D ranks on four NVIDIA H100 80GB HBM3 cards at 700.00 W
#: (PERF.md section 3), printed beside the captured one
EAGER_DP_CLI_STEP_MS = {1: 19.667, 2: 18.386, 4: 19.174}


def dp_cli_worlds(cards, sweep, given=None):
    """Phase 39's, 42's and 43's rank counts: a mesh of one (one rank over
    NCCL)
    on a run of the whole script; with ``--sweep-only`` and 2 or more cards
    also 2 and min(cards, 4) ranks, one a card (NCCL refuses two ranks on
    one card, so never more ranks than cards), or the counts `given`
    (``--worlds``, comma-separated)."""
    if sweep and given:
        worlds = sorted({int(w) for w in given.split(',')})
        check(worlds[0] >= 1 and worlds[-1] <= cards,
              f'--worlds {given} on {cards} card(s)')
        return worlds
    if not sweep or cards < 2:
        return [1]
    return sorted({1, 2, min(cards, 4)})


def dp_cli_argv(out_dir, mesh, device='cuda', n=None, epochs=None,
                batch=None, dtype=None):
    """Phase 39's CLI argv: ``config.dp_sweep()[0]``'s gate scheme, sup
    fraction, compute dtype and global batch on `n` synthetic train images
    with a learnable signal for `epochs` epochs, with ``--mesh`` or in one
    process."""
    from gltvae_torch.config import dp_sweep
    _, model_cfg, train_cfg = dp_sweep()[0]
    argv = ['--synthetic', '--synthetic-n', str(n or DP_CLI_N),
            '--synthetic-signal', '--do-train',
            '--epochs', str(epochs or DP_CLI_EPOCHS),
            '--gate-type', model_cfg.gate_type,
            '--gate-subtype', model_cfg.gate_subtype,
            '--sup', str(train_cfg.perc_supervision),
            '-bs', str(batch or train_cfg.batch_size),
            '--compute-dtype', dtype or model_cfg.compute_dtype,
            '--output-dir', out_dir, '--device', device]
    return argv + (['--mesh'] if mesh else [])


def dp_cli_steps(argv):
    """(train steps, eval batches) of a phase-39 run: the CLI's synthetic
    split sizes and the Trainer's schedule, validation each epoch and one
    test pass."""
    from gltvae_torch.cli import parse_args
    a = parse_args(argv)
    n_eval = max(64, a.synthetic_n // 8)
    sup = a.sup[0]
    n_sup = int(a.synthetic_n * sup)
    per_epoch = (math.ceil(n_sup / a.batch_size)
                 + math.ceil((a.synthetic_n - n_sup) / a.batch_size))
    return (a.epochs * per_epoch,
            (a.epochs + 1) * math.ceil(n_eval / a.batch_size))


def state_digest(state):
    """A TrainState's step and the sha256 of its params (every entry of the
    model's state_dict, μ included), Adam m and Adam v, each over its
    tensors' names, dtypes and bytes in name order: equal digests are equal
    states bit for bit."""
    import hashlib

    import torch

    def digest(tensors):
        h = hashlib.sha256()
        for k in sorted(tensors):
            t = tensors[k].detach().cpu().contiguous().reshape(-1)
            h.update(f'{k} {t.dtype} '.encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        return h.hexdigest()
    return {'step': int(state.step),
            'params': digest(state.model.state_dict()),
            'adam_m': digest(state.adam_m), 'adam_v': digest(state.adam_v)}


def written_paths(log):
    """Log to `log` the path of every file this process writes (``open`` for
    writing, ``torch.save``, ``np.save``, ``np.savez``, the target of
    ``os.replace``); returns the undo."""
    import builtins

    import numpy as np
    import torch

    def note(i):
        def wrap(fn):
            def run(*a, **k):
                if len(a) > i and isinstance(a[i], (str, os.PathLike)):
                    log.append(os.path.abspath(a[i]))
                return fn(*a, **k)
            return run
        return wrap

    def opened(fn):
        def run(file, mode='r', *a, **k):
            if isinstance(file, (str, os.PathLike)) and any(
                    c in mode for c in 'wax+'):
                log.append(os.path.abspath(file))
            return fn(file, mode, *a, **k)
        return run
    undo = [patched(builtins, 'open', opened),
            patched(torch, 'save', note(1)), patched(np, 'save', note(0)),
            patched(np, 'savez', note(0)), patched(os, 'replace', note(1))]
    return lambda: [u() for u in reversed(undo)]


def dp_cli_rank(report_dir, argv, profiled=False):
    """One process of phase 39, under torchrun (a rank) or alone (with no
    ``--mesh``: the one-process run): dequant bit-equal to plain at this
    process's rows of a batch; then ``cli.main(argv)`` with dequant's
    count set to 0 just before it, every dispatch's time (``Throughput.
    step``), the paths written, the end-of-training state (its digest; rank
    0 also its tensors, rank0_state.pt) and the restored state's digest;
    `profiled` on a card, DP_CLI_PROFILE's dispatches under the profiler.
    Writes ``<report_dir>/rank<r>.json``."""
    sys.path.insert(0, os.path.dirname(SCRIPT))
    import faulthandler

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, schedule
    from gltvae_torch import cli
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.profile_step import kernel_table
    from gltvae_torch.train import loop, metrics
    # a rank that hangs shows its Python stack in the kept log before its
    # kill (the process started a few seconds after the kill's clock)
    faulthandler.dump_traceback_later(DP_CLI_TIMEOUT - 60)
    rank = int(os.environ.get('RANK', '0'))
    world = int(os.environ.get('WORLD_SIZE', '1'))
    args = cli.parse_args(argv)
    cuda = args.device != 'cpu'
    dev = (torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
           if cuda else torch.device('cpu'))
    if cuda:
        torch.cuda.set_device(dev)      # before the profiler touches a card
    else:
        count_plain_calls()
    shape = (args.batch_size // world, args.image_size, args.image_size, 3)
    u8 = torch.randint(0, 256, shape, dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(39 + rank)
                       ).to(dev)
    check(torch.equal(preprocess.dequant(u8),
                      preprocess.dequant_reference(u8)),
          f'rank {rank}: dequant != plain at {shape}')
    del u8
    first, n_prof = DP_CLI_PROFILE
    stamps, trainers, final, tables, written = [], [], {}, [], []
    prof = None

    # the profiled window's first and last stamps wait for the card, so
    # its wall holds all of its dispatches' device work
    bounds = {first - 1, first - 1 + n_prof}

    def on_step(fn):
        def run(self, n):
            fn(self, n)
            if prof is not None and len(stamps) in bounds:
                torch.cuda.synchronize(dev)
            stamps.append(time.time())
            if prof is not None:
                prof.step()
        return run

    def on_train(fn):
        def run(self, *a, **k):
            trainers.append(self)
            out = fn(self, *a, **k)
            final['digest'] = state_digest(self.state)
            if rank == 0:
                torch.save(self.state.state_dict(),
                           os.path.join(report_dir, 'rank0_state.pt'))
            return out
        return run

    def leaving(fn):
        def run():
            grouped = dist.is_initialized()
            if grouped:
                rank_line(39, rank, world, 'leaving the group')
            fn()
            if grouped:
                rank_line(39, rank, world, 'left the group')
        return run

    def on_trace(p):
        events = [e for e in p.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        nccl = [e for e in events if 'nccl' in e.key.lower()]
        tables.append(dict(
            all=kernel_table(events, n_prof, 5),
            nccl=kernel_table(nccl, n_prof, 2) if nccl else None))
    undo = [patched(metrics.Throughput, 'step', on_step),
            patched(loop.Trainer, 'train', on_train),
            patched(pmesh, 'shutdown', leaving)]
    out_dir = os.path.abspath(args.output_dir)
    try:
        if cuda and profiled:
            prof = profile(activities=[ProfilerActivity.CUDA],
                           schedule=schedule(wait=first - 1, warmup=1,
                                             active=n_prof, repeat=1),
                           on_trace_ready=on_trace)
            prof.start()
        undo.append(written_paths(written))
        preprocess.launches = 0
        result = cli.main(argv)
        launches = preprocess.launches
        undo.pop()()
        if prof is not None:
            prof.stop()
    finally:
        for u in reversed(undo):
            u()
        faulthandler.cancel_dump_traceback_later()
    own = sorted({os.path.relpath(p, out_dir) for p in written
                  if p.startswith(out_dir + os.sep)})
    mesh = trainers[-1].mesh
    report = dict(rank=rank, world=world, device=str(trainers[-1].device),
                  backend=mesh and mesh.backend,
                  kernel_shape=list(shape), launches=launches,
                  final=final['digest'],
                  restored=state_digest(trainers[-1].state),
                  written=own, stamps=stamps,
                  result={str(k): v for k, v in result.items()},
                  profile=tables[0] if tables else None)
    if tables:      # the wall of the profiled dispatches, on the same stamps,
        # synchronized at both ends
        report['profile']['window_wall_ms'] = (
            stamps[first - 1 + n_prof] - stamps[first - 1]) / n_prof * 1e3
    with open(os.path.join(report_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)


def run_bounded(cmd, log_path, timeout_s):
    """Run `cmd` from the checkout in a session of its own, its output to
    `log_path`. A non-zero exit fails the phase with the log's tail; after
    `timeout_s` seconds the session (torchrun and every rank) is killed and
    the phase fails. Returns the seconds taken."""
    import signal
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [os.path.dirname(SCRIPT)] + [p for p in env.get('PYTHONPATH', '')
                                     .split(os.pathsep) if p])
    t0 = time.perf_counter()
    with open(log_path, 'w') as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(SCRIPT), env=env,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        print(tail, flush=True)
        check(False, f'{" ".join(cmd[:6])} ... '
                     + ('timed out after %.0f s' % timeout_s if rc is None
                        else f'exited {rc}'))
    return time.perf_counter() - t0


def kept_log(name):
    """The path of log `name` in the checkout's ``chiprun_out/
    chip_smoke_logs``, which a chip call brings back (a torchrun log holds
    every rank's lines)."""
    keep = os.path.join(ROOT, 'chiprun_out', 'chip_smoke_logs')
    os.makedirs(keep, exist_ok=True)
    return os.path.join(keep, name)


def torchrun(world, *cmd):
    """The command that starts `world` local ranks of `cmd` (a script and
    its arguments, or ``-m module ...``) under torchrun."""
    return [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            f'--nproc-per-node={world}', *cmd]


def dp_cli_bounds(ref_state, steps, lr, dtype):
    """The rel L2 bounds of phase 39's final state against the one
    process's, each a one-step tolerance of phase 37 times the run's
    `steps`: the params by phase 37's element rule (rtol 2e-4, atol 1e-6,
    or lr/4 of the Adam step, whose size is at most about lr) summed over
    the elements, as an L2 norm, against the one process's params; Adam m
    and v by phase 37's rel L2 tolerances for `dtype`."""
    p = torch_cat(ref_state['params'])
    n = p.numel()
    norm = float(p.norm())
    per_step = 2e-4 + (1e-6 + 0.25 * lr) * math.sqrt(n) / norm
    m, v = ((BF16_TOL['adam_m_l2'], BF16_TOL['adam_v_l2'])
            if dtype == 'bfloat16' else (1e-3, 1e-3))
    return {'params': steps * per_step, 'adam_m': steps * m,
            'adam_v': steps * v}


def torch_cat(tensors):
    """A dict of tensors as one float64 vector, in name order."""
    import torch
    return torch.cat([tensors[k].double().reshape(-1)
                      for k in sorted(tensors)])


def rel_l2(got, want):
    """|got - want| / |want| over the dicts' tensors as one vector."""
    a, b = torch_cat(got), torch_cat(want)
    return float((a - b).norm() / b.norm())


def dp_cli_phase(dev, smi, worlds, **argv_kw):
    """Phase 39: the data-parallel CLI through torchrun at each of `worlds`
    ranks, one a card over NCCL (gloo on the CPU), against the same command
    without --mesh in one process; then ``infer --mesh`` through torchrun
    on each run's checkpoint against the one-process ``infer``. Held: every
    rank's end-of-training and restored states bit-equal to rank 0's,
    dequant bit-equal to plain at each rank's rows and its launch count,
    the files (rank 0 alone writes result.json, the checkpoints and the μ
    files), the final state within ``dp_cli_bounds`` of the one process's
    and test accuracy within DP_CLI_ACC_TOL, the CSVs equal row for row,
    and every rank's line that it left its group.
    Printed: the trainer meter's img/s, the step wall of the last epoch,
    spawn to first step, and the device ms a step (NCCL's share apart) of
    a one-epoch run profiled on each card. Returns what it measured a
    world."""
    import torch
    from gltvae_torch import infer as tinfer
    from gltvae_torch.cli import build_configs, parse_args
    from gltvae_torch.data.synthetic import write_celeba_corpus
    device = 'cpu' if dev.type == 'cpu' else 'cuda'
    root = os.path.join(ROOT, 'build', 'chip_smoke_dp_cli')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_celeba_corpus(os.path.join(root, 'photos'), *DP_CLI_PHOTOS)
    images = os.path.join(root, 'photos', 'img_align_celeba')
    n_photos = sum(DP_CLI_PHOTOS)
    args_ref = dp_cli_argv(os.path.join(root, 'one'), False, device,
                           **argv_kw)
    steps, eval_batches = dp_cli_steps(args_ref)
    a = parse_args(args_ref)
    model_cfg, train_cfg = build_configs(a, a.sup[0])
    run_name = f'params_{a.sup[0]}_{model_cfg.gate_type}'
    B = train_cfg.batch_size

    def launch(world, rep, argv, profiled=False):
        os.makedirs(rep)
        print(f'  phase 39 launch, {time.strftime("%H:%M:%S")}: '
              f'{os.path.basename(rep)} ({world or 1} process(es)'
              f'{", profiled" if profiled else ""})', flush=True)
        cmd = [SCRIPT, '--dp-cli-rank', rep,
               *(['--profiled'] if profiled else []), *argv]
        t0 = time.time()
        log = kept_log(os.path.basename(rep) + '.log')
        s = run_bounded(torchrun(world, *cmd) if world else
                        [sys.executable, *cmd], log, DP_CLI_TIMEOUT)
        if world:
            with open(log) as f:
                text = f.read()
            check(all(f'rank {r} of {world}: left the group' in text
                      for r in range(world)),
                  f'{world} ranks: not every rank printed that it left '
                  f'its group ({log})')
        reports = []
        for r in range(world or 1):
            with open(os.path.join(rep, f'rank{r}.json')) as f:
                reports.append(json.load(f))
        return reports, t0, s

    def device_time(world, argv, name):
        """The device time a step of `argv` for one epoch at `world` ranks
        (None: one process), profiled on each card; None off the card."""
        if device != 'cuda':
            return None
        one = argv[:argv.index('--epochs') + 1] + ['1'] + argv[
            argv.index('--epochs') + 2:]
        one[one.index('--output-dir') + 1] += '_profiled'
        reports, _, _ = launch(world, os.path.join(root, name), one, True)
        return [r['profile'] for r in reports]

    ref_rep = os.path.join(root, 'one_report')
    (ref,), t_ref, _ = launch(None, ref_rep, args_ref)
    ref_state = torch.load(os.path.join(ref_rep, 'rank0_state.pt'),
                           weights_only=False)
    with open(os.path.join(root, 'one', run_name, 'result.json')) as f:
        ref_result = json.load(f)
    bounds = dp_cli_bounds(ref_state, steps, train_cfg.lr,
                           model_cfg.compute_dtype)
    out = {'steps': steps, 'eval_batches': eval_batches, 'bounds': bounds,
           'one_process': dp_cli_speed(
               [ref], t_ref, steps, B, ref_result,
               device_time(None, args_ref, 'one_profiled')),
           'worlds': {}}
    check(ref['launches'] == steps + eval_batches,
          f'one process: dequant launches {ref["launches"]}, expected '
          f'{steps} steps + {eval_batches} eval batches')
    phase(39, f'{" ".join(args_ref)} in one process: {ref["launches"]} '
              f'dequant launches ({steps} steps + {eval_batches} eval '
              f'batches), test accuracy {ref_result["test_accuracy"]:.4f}; '
              f'bounds of a D-rank run\'s final state against it (rel L2, '
              f'{steps} steps x phase 37\'s one-step tolerance): params '
              f'{bounds["params"]:.3e}, Adam m {bounds["adam_m"]:.3e}, v '
              f'{bounds["adam_v"]:.3e}')
    print(dp_cli_line('one process', out['one_process'], smi), flush=True)
    for world in worlds:
        run_dir = os.path.join(root, f'd{world}')
        argv = dp_cli_argv(run_dir, True, device, **argv_kw)
        reports, t0, s = launch(world, os.path.join(root, f'd{world}_report'),
                                argv)
        with open(os.path.join(run_dir, run_name, 'result.json')) as f:
            result = json.load(f)
        r0 = reports[0]
        b = B // world
        backend = 'nccl' if device == 'cuda' else 'gloo'
        for r, got in enumerate(reports):
            check(got['rank'] == r and got['world'] == world
                  and got['device'] == (f'cuda:{r}' if device == 'cuda'
                                        else 'cpu')
                  and got['backend'] == backend,
                  f'{world} ranks: rank {r} is {got["rank"]} of '
                  f'{got["world"]} on {got["device"]} over '
                  f'{got["backend"]}, expected {backend}')
            check(got['final'] == r0['final'] and got['restored'] ==
                  r0['restored'],
                  f'{world} ranks: rank {r}\'s state differs from rank 0\'s '
                  f'({got["final"]} vs {r0["final"]})')
            check(got['kernel_shape'] == [b, 64, 64, 3]
                  and got['launches'] == steps + eval_batches,
                  f'{world} ranks: rank {r} {got["launches"]} dequant '
                  f'launches at {got["kernel_shape"]}, expected '
                  f'{steps + eval_batches} at {[b, 64, 64, 3]}')
            check(r == 0 or not got['written'],
                  f'{world} ranks: rank {r} wrote {got["written"]}')
            check(got['result'] == r0['result'],
                  f'{world} ranks: test accuracy {got["result"]} on rank '
                  f'{r}, {r0["result"]} on rank 0')
        check(r0['final']['step'] == steps, f'{world} ranks: final step '
              f'{r0["final"]["step"]}, expected {steps}')
        files = r0['written']
        mu = [f for f in files if os.path.basename(f).startswith(
            'learned_gating_matrix_')]
        check(f'{run_name}/result.json' in files
              and f'{run_name}/model_config.json' in files
              and any(f.startswith(f'{run_name}/checkpoints/') for f in files)
              and {os.path.basename(f) for f in mu} >= {
                  f'learned_gating_matrix_{i}.{e}' for i in ('best', 'last')
                  for e in ('npy', 'csv')},
              f'{world} ranks: rank 0 wrote {files}')
        state = torch.load(os.path.join(run_dir + '_report',
                                        'rank0_state.pt'), weights_only=False)
        gaps = {k: rel_l2(state[k], ref_state[k])
                for k in ('params', 'adam_m', 'adam_v')}
        acc_gap = abs(result['test_accuracy'] - ref_result['test_accuracy'])
        check(all(gaps[k] <= bounds[k] for k in gaps)
              and acc_gap <= DP_CLI_ACC_TOL,
              f'{world} ranks vs one process: rel L2 {gaps} (bounds '
              f'{bounds}), test accuracy {result["test_accuracy"]} vs '
              f'{ref_result["test_accuracy"]} (tol {DP_CLI_ACC_TOL})')
        speed = dp_cli_speed(reports, t0, steps, B, result,
                             device_time(world, argv, f'd{world}_profiled'))
        phase(39, f'torchrun {world} rank(s) of the CLI --mesh '
                  f'({backend}, {b} rows a '
                  f'rank), {s:.1f} s: every rank\'s final and restored state '
                  f'bit-equal to rank 0\'s (step {r0["final"]["step"]}); '
                  f'dequant bit-equal to plain at {tuple(r0["kernel_shape"])} '
                  f'and {r0["launches"]} launches on each rank; rank 0 alone '
                  f'wrote {len(files)} files ({len(mu)} mu files); vs one '
                  f'process: rel L2 params {gaps["params"]:.3e}, m '
                  f'{gaps["adam_m"]:.3e}, v {gaps["adam_v"]:.3e} (bounds '
                  f'{bounds["params"]:.3e}, {bounds["adam_m"]:.3e}, '
                  f'{bounds["adam_v"]:.3e}), test accuracy '
                  f'{result["test_accuracy"]:.4f} vs '
                  f'{ref_result["test_accuracy"]:.4f} (tol '
                  f'{DP_CLI_ACC_TOL})')
        print(dp_cli_line(f'{world} rank(s)', speed, smi), flush=True)
        print(f'  the step wall captured (the CLI\'s default) '
              f'{speed["step_wall_ms"]:.3f} ms; eager (recorded, four '
              f'cards) {EAGER_DP_CLI_STEP_MS.get(world, float("nan")):.3f} '
              f'ms', flush=True)

        # infer --mesh on this run's checkpoint, held row for row to one
        # process labelling as many rows a call as each card does (the same
        # arithmetic); against one process at the global batch its gap is
        # printed: cuDNN rounds a bf16 batch of 128 rows otherwise than one
        # of 256 (9 of 448 rows a 4th decimal apart at D = 2, four H100s)
        ckpt = os.path.join(run_dir, run_name)
        base = ['--checkpoint', ckpt, '--images', images, '--device', device]
        mesh_csv = os.path.join(root, f'preds_d{world}.csv')
        s_inf = run_bounded(torchrun(world, '-m', 'gltvae_torch.infer',
                                     *base, '--batch-size',
                                     str(DP_CLI_INFER_BS), '--mesh',
                                     '--output', mesh_csv),
                            kept_log(f'infer_d{world}.log'),
                            DP_CLI_TIMEOUT)

        def one_process(bs):
            path = os.path.join(root, f'preds_d{world}_one_bs{bs}.csv')
            captured(tinfer.main, base + ['--batch-size', str(bs),
                                          '--output', path])
            return csv_rows(path)
        got, bs = csv_rows(mesh_csv), DP_CLI_INFER_BS // world
        per_card = one_process(bs)
        same = csv_gap(got, per_card)
        check(len(got) == len(per_card) == n_photos + 1 and same['rows'] == 0,
              f'infer --mesh on {world} rank(s): {len(got) - 1} rows, vs one '
              f'process at batch {bs} {same}')
        whole = same if bs == DP_CLI_INFER_BS else csv_gap(
            got, one_process(DP_CLI_INFER_BS))
        phase(39, f'torchrun {world} rank(s) of infer --mesh at batch '
                  f'{DP_CLI_INFER_BS} over {n_photos} JPEGs, {s_inf:.1f} s: '
                  f'the CSV equals row for row the one process\'s at batch '
                  f'{bs} (the rows a card labels at once); against one '
                  f'process at batch {DP_CLI_INFER_BS}: {whole["rows"]} rows '
                  f'differ, {whole["labels"]} hard labels, max |dp| '
                  f'{whole["max_p"]:.4f} (printed)')
        out['worlds'][world] = dict(
            launches_per_rank=[g['launches'] for g in reports],
            shape=r0['kernel_shape'], gaps=gaps,
            test_accuracy=result['test_accuracy'], seconds=s,
            infer_vs_global_batch=whole, **speed)
    out['one_process'].update(test_accuracy=ref_result['test_accuracy'],
                              launches=ref['launches'])
    # dequant at the ranks' rows of a 4096 batch on 4 and on 2 cards
    out['shapes'] = [dequant_at((B // w, 64, 64, 3), dev, smi)
                     for w in (4, 2)]
    return out


def csv_rows(path):
    with open(path) as f:
        return f.read().splitlines()


def csv_gap(a, b):
    """Two inference CSVs (lines, header first) compared row by row: the
    rows that differ, the hard labels that differ and the largest gap of a
    printed probability."""
    rows = labels = 0
    max_p = 0.0
    for x, y in zip(a[1:], b[1:]):
        x, y = x.split(','), y.split(',')
        n = (len(x) - 1) // 2
        rows += x != y
        labels += sum(u != v for u, v in zip(x[1:1 + n], y[1:1 + n]))
        max_p = max([max_p] + [abs(float(u) - float(v))
                               for u, v in zip(x[1 + n:], y[1 + n:])])
    return {'rows': rows + (a[:1] != b[:1]) + abs(len(a) - len(b)),
            'labels': labels, 'max_p': max_p}


def dp_cli_speed(reports, t0, steps, batch, result, profs=None):
    """A phase-39 run's speed: the trainer meter's img/s and the epoch
    walls (result.json), the median dispatch interval of the last epoch
    after its first two on rank 0 (the step wall) and its img/s, the
    seconds from the command's start to the last rank's first step, and
    from `profs` (each card's profile of the profiled run, or None) the
    device ms a step on the slowest card and NCCL's part of it."""
    st = reports[0]['stamps']
    last = st[steps - steps // len(result['history']) + 1:]
    gaps = [b - a for a, b in zip(last, last[1:])]
    wall = statistics.median(gaps) if gaps else float('nan')
    slow = max(profs or [], default=None,
               key=lambda p: p['all']['device_ms_per_dispatch'])
    return dict(meter_images_per_sec=result['images_per_sec'],
                epoch_s=[h['epoch_time'] for h in result['history']],
                step_wall_ms=wall * 1e3, step_images_per_sec=batch / wall,
                device_ms_per_step=slow and slow['all'][
                    'device_ms_per_dispatch'],
                nccl_ms_per_step=slow and (slow['nccl'] or {}).get(
                    'device_ms_per_dispatch', 0.0),
                launches_per_step=slow and slow['all'][
                    'launches_per_dispatch'],
                profiled_dispatches=slow and slow['all']['dispatches'],
                profiled_wall_ms=slow and slow.get('window_wall_ms'),
                spawn_to_first_step_s=max(r['stamps'][0] for r in reports)
                - t0)


def dp_cli_line(label, sp, smi):
    """The printed speed line of one phase-39 run."""
    dev = ('not measured (no card)' if sp['device_ms_per_step'] is None
           else f'{sp["device_ms_per_step"]:.3f} ms a step on the slowest '
                f'card over the {sp["profiled_dispatches"]} dispatches '
                f'{DP_CLI_PROFILE[0]}-{sum(DP_CLI_PROFILE) - 1} of a '
                f'one-epoch run, whose own wall is '
                f'{sp["profiled_wall_ms"]:.3f} ms a dispatch '
                f'({sp["device_ms_per_step"] / sp["profiled_wall_ms"]:.1%} '
                f'busy; {sp["device_ms_per_step"] / sp["step_wall_ms"]:.1%} '
                f'of the unprofiled step wall), NCCL '
                f'{sp["nccl_ms_per_step"]:.3f} of it, '
                f'{sp["launches_per_step"]:.0f} kernels a dispatch')
    return (f'slice_dp_cli {label}: trainer meter '
            f'{sp["meter_images_per_sec"]:.0f} img/s (epochs '
            f'{", ".join(f"{e:.2f}" for e in sp["epoch_s"])} s); step wall '
            f'{sp["step_wall_ms"]:.3f} ms ({sp["step_images_per_sec"]:.0f} '
            f'img/s, median of the last epoch); device {dev}; spawn to '
            f'first step {sp["spawn_to_first_step_s"]:.1f} s; card {smi}')


#: The CUDA runtime and driver calls that put work on a stream from the
#: host, as torch.profiler names them (phase 40's host launches a step):
#: kernel launches, graph launches, and the copies and fills that go to
#: the copy engines (a contiguous device-to-device ``copy_`` or
#: ``clone`` is a ``cudaMemcpyAsync``, not a kernel).
LAUNCH_APIS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
               'cuLaunchKernelEx', 'cudaGraphLaunch', 'cudaMemcpyAsync',
               'cudaMemsetAsync')

#: Phase 40's steps: 16 of the sup 0.5 interleave (sup on even steps), the
#: gating temperature decayed once halfway, as at an epoch's end.
GRAPH_STEPS = 16

#: the most host launches a captured train step may make (phase 40 (d)):
#: its host part draws z's normals, the two gate uniforms and eps_k or u_y
#: (4 launches), fills the temperature and alpha and copies the batch in
CAPTURED_STEP_LAUNCHES = 20
#: Phase 40's timed steps a speed line (after 4 warm-up steps), and the
#: profiled steps after them.
SPEED_STEPS, SPEED_PROFILED = 50, 10


def graph_batches(image_size, y_dim, n, dev, seed=40):
    """`n` (x u8, y f32) batches of BATCH rows on `dev`, from the seed."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randint(
                0, 256, (BATCH, image_size, image_size, 3)).astype(
                    np.uint8)).to(dev),
             torch.from_numpy((rng.rand(BATCH, y_dim) > 0.5).astype(
                 np.float32)).to(dev)) for _ in range(n)]


def train_leg(model_cfg, train_cfg, mu, batches, kinds, temps, dev, how,
              sizes=None, mesh=None):
    """The steps `kinds` (True: sup) on the global device `batches` at the
    gating temperatures `temps`, from a fresh initial state (rank 0's on
    every rank of a `mesh`, each rank taking its rows of each batch), run
    `how`: 'eager' (``make_train_steps(jit=False)``), 'steps' (captured
    single steps), 'chunks' (captured chunks of `sizes` steps over stacked
    shipped batches, ``make_mixed_scan_train_step``), 'resident' (the same
    over rows of two device-resident splits, the sup and the unsup
    batches, ``make_resident_mixed_scan_train_step``; on a mesh this
    rank's rows of each, exchanged through ``gather_rows``), 'shardmap' or
    'shardmap_eager' (``make_shardmap_train_steps``, captured or not; a
    mesh only). A padded batch is cropped by the augment kernel inside
    the step or chunk. Returns the final state, each step's metrics on the
    host, the (dequant, augment) launches counted and, of a chunk leg, the
    static crop draws of its last chunk."""
    import torch
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.parallel.shardmap import make_shardmap_train_steps
    from gltvae_torch.train import steps as ts
    from gltvae_torch.train.state import create_train_state, init_model
    model = init_model(model_cfg, train_cfg, mu, dev)
    state = create_train_state(model, train_cfg)
    dp = None
    if mesh is not None:
        shard_state(state, mesh)
        dp = DataParallel(mesh)
    jit = how not in ('eager', 'shardmap_eager')
    sync(dev)
    launches0 = preprocess.launches, preprocess.augment_launches
    mets, draws = [], None
    if how in ('eager', 'steps', 'shardmap', 'shardmap_eager'):
        fns = (make_shardmap_train_steps(model, train_cfg, mesh, jit)
               if how.startswith('shardmap') else
               ts.make_train_steps(model, train_cfg, dp, jit))
        for (x, y), sup, temp in zip(batches, kinds, temps):
            mets.append(fns[0 if sup else 1](
                state, _rank_rows(x, mesh), _rank_rows(y, mesh), temp)[1])
    else:
        B = len(batches[0][0])
        split = {k: [b for b, s in zip(batches, kinds) if s == k]
                 for k in (True, False)}
        res = {k: (_rank_rows(torch.cat([x for x, _ in v]), mesh),
                   torch.cat([y for _, y in v]))
               for k, v in split.items() if v}
        fns = (ts.make_resident_mixed_scan_train_step if how == 'resident'
               else ts.make_mixed_scan_train_step)(model, train_cfg, dp,
                                                   jit=True)
        rows, i = {True: 0, False: 0}, 0
        for n in sizes:
            mask, temp = kinds[i:i + n], temps[i]
            check(temps[i:i + n] == [temp] * n,
                  'a chunk takes one temperature')
            if how == 'resident':
                idxs = []
                for m in mask:
                    idxs.append(torch.arange(rows[m] * B, (rows[m] + 1) * B,
                                             device=dev))
                    rows[m] += 1
                empty = (torch.empty(0, device=dev),) * 2
                _, ms = fns(state, *res.get(True, empty),
                            *res.get(False, empty), torch.stack(idxs), mask,
                            temp)
            else:
                xs, ys = (torch.stack([_rank_rows(b[k], mesh)
                                       for b in batches[i:i + n]])
                          for k in (0, 1))
                _, ms = fns(state, xs, ys, mask, temp)
            mets += [{k: v[j] for k, v in ms.items()} for j in range(n)]
            i += n
        last = tuple(kinds[i - sizes[-1]:i])
        chunk = next((c for key, c in getattr(fns, 'chunks', {}).items()
                      if key[0] == last and c.crop_draws is not None), None)
        if chunk is not None:
            draws = tuple(d.cpu() for d in chunk.crop_draws)
    sync(dev)
    out = dict(state=state.state_dict(),
               launches=(preprocess.launches - launches0[0],
                         preprocess.augment_launches - launches0[1]),
               metrics=[{k: v.detach().float().cpu() for k, v in m.items()}
                        for m in mets], crop_draws=draws)
    del model, state, mets, fns
    return out


def compare_legs(eager, capt):
    """Whether two train legs' step, count, every metric, param and Adam
    moment are bit-equal, with the worst gap of each measure and where it
    is ('metrics' rel; 'params', 'adam_m', 'adam_v' max abs over the leaf's
    largest value; 'adam_m_l2', 'adam_v_l2' rel L2 over all leaves)."""
    import torch
    worst = {k: (0.0, '') for k in ('metrics', 'params', 'adam_m', 'adam_v',
                                    'adam_m_l2', 'adam_v_l2')}

    def note(key, val, where):
        if val > worst[key][0]:
            worst[key] = (val, where)

    equal = all(eager['state'][k] == capt['state'][k]
                for k in ('step', 'adam_count'))
    equal &= len(eager['metrics']) == len(capt['metrics'])
    for i, (a, b) in enumerate(zip(eager['metrics'], capt['metrics'])):
        for k in a:
            equal &= torch.equal(a[k], b[k])
            note('metrics', float((a[k] - b[k]).abs())
                 / max(float(a[k].abs()), 1e-6), f'step {i} {k}')
    for key in ('params', 'adam_m', 'adam_v'):
        want, got = eager['state'][key], capt['state'][key]
        for k, ref in want.items():
            equal &= torch.equal(got[k], ref)
            note(key, float((got[k] - ref).abs().max())
                 / max(float(ref.abs().max()), 1e-30), k)
        if key != 'params':
            a, b = (torch.cat([d[k].flatten() for k in want])
                    for d in (want, got))
            note(f'{key}_l2', float((b - a).norm() / a.norm()), key)
    return bool(equal), worst


def eager_vs_captured(model_cfg, train_cfg, mu, batches, kinds, temps, dev):
    """The steps `kinds` (True: sup) on device `batches` at the gating
    temperatures `temps`, from one initial state, eagerly
    (``make_train_steps(jit=False)``) and captured (``jit=True``).
    Returns whether every metric, param and Adam moment is bit-equal, the
    worst gap of each measure with where it is (``compare_legs``) and each
    run's dequant launches."""
    legs = [train_leg(model_cfg, train_cfg, mu, batches, kinds, temps, dev,
                      how) for how in ('eager', 'steps')]
    equal, worst = compare_legs(*legs)
    return dict(equal=equal, worst=worst,
                launches=tuple(leg['launches'][0] for leg in legs))


def hold_captured(label, res, tol):
    """Phase 40's rule: the captured steps bit-equal to the eager ones, or
    else within `tol` (card_vs_cpu's keys; a key missing from `tol` is
    printed, not held), with the largest gap and its leaf printed."""
    w = res['worst']
    if res['equal']:
        return 'bit-equal (metrics, params, Adam m and v)'
    print(f'  {label}: not bit-equal; largest gaps: ' + '; '.join(
        f'{k} {v:.3e} at {where}' for k, (v, where) in w.items()),
        flush=True)
    bad = [k for k in ('metrics', 'adam_m', 'adam_v', 'adam_m_l2',
                       'adam_v_l2') if k in tol and w[k][0] > tol[k]]
    check(not bad, f'{label}: captured steps differ from the eager ones '
          f'beyond the tolerance ({bad})')
    return (f'within tolerance, not bit-equal: metrics max rel '
            f'{w["metrics"][0]:.3e}, Adam m {w["adam_m"][0]:.3e}, v '
            f'{w["adam_v"][0]:.3e} of leaf max, params {w["params"][0]:.3e} '
            f'of leaf max at {w["params"][1]}')


def step_speed(model_cfg, train_cfg, mu, batches, dev, jit):
    """Sup and unsup steps alternating on two device `batches`, eagerly or
    captured: the median synchronized step wall over `steps` steps (after
    4 warm-up steps, which capture), then `profiled` steps under
    torch.profiler: device ms a step (the sum of the device's kernel,
    copy and fill times), host launches a step by runtime call, the
    dequant launches counted and those torch.profiler saw run on the card,
    and the peak memory above what was held before the model was made. `steps` and
    `profiled` are SPEED_STEPS and SPEED_PROFILED."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gltvae_torch.ops import preprocess
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import make_train_steps
    cuda = dev.type == 'cuda'
    steps, profiled = SPEED_STEPS, SPEED_PROFILED
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    model = init_model(model_cfg, train_cfg, mu, dev)
    state = create_train_state(model, train_cfg)
    fns = make_train_steps(model, train_cfg, jit=jit)

    def one(i):
        x, y = batches[i % 2]
        return fns[i % 2](state, x, y, 1.0)[1]
    for i in range(4):
        m = one(i)
    walls = []
    for i in range(steps):
        sync(dev)
        t = time.perf_counter()
        m = one(i)
        sync(dev)
        walls.append(time.perf_counter() - t)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(dev)
    counted = preprocess.launches
    with profile(activities=acts) as prof:
        for i in range(profiled):
            m = one(i)
        sync(dev)
    counted = preprocess.launches - counted
    check(all(math.isfinite(float(v)) for v in m.values()),
          'step speed: metrics not finite')
    events = prof.key_averages()
    # reported, not held: torch.profiler has missed one of a window's
    # graph kernels now and then; the graphs themselves are audited at
    # their capture (audit_graphs)
    ran = device_launches(events) if cuda else None
    device_ms = (sum(e.self_device_time_total for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA)
                 / 1e3 / profiled) if cuda else float('nan')
    launches = {e.key: e.count / profiled for e in events
                if e.key in LAUNCH_APIS}
    wall_ms = statistics.median(walls) * 1e3
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20 if cuda \
        else 0.0
    del model, state, fns
    return dict(jit=jit, steps=steps, wall_ms=wall_ms,
                img_s=len(batches[0][0]) / wall_ms * 1e3,
                device_ms=device_ms, busy=device_ms / wall_ms,
                launches=launches, launches_total=sum(launches.values()),
                dequant_counted=counted, dequant_on_card=ran,
                peak_mib=peak)


def graphs_phase(dev, smi):
    """Phase 40: the captured train step (train/graphs.py) against the
    eager one. (a) phase 5's model, 16 steps of the sup 0.5 interleave
    from one state on cuDNN's deterministic algorithms; (b) the same for
    phase 13's 128 px bf16 + s2d + remat 'dots' model; (c) phase 5's
    two-epoch Trainer run with jit=True and jit=False: metrics.csv row for
    row and the test accuracy equal; (d) speed lines, eager and captured,
    for the plain step (bs 256, f32) and the sweep step
    (``dp_sweep()[0]``, batch 4096, bf16). Returns the captured run's
    dequant launches of (a), (b) and (c)."""
    import dataclasses

    import numpy as np
    import torch
    from gltvae_torch.config import celeba128, default_celeba64, dp_sweep
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model_cfg, train_cfg = default_celeba64(sup=0.5, n_epochs=2,
                                                batch_size=BATCH)
        model_128, train_128 = celeba128(sup=0.5, n_epochs=2,
                                         batch_size=BATCH, remat='dots')
        model_128 = dataclasses.replace(model_128, compute_dtype='bfloat16',
                                        input_s2d=True, output_s2d=True)
        kinds = [i % 2 == 0 for i in range(GRAPH_STEPS)]
        for key, mcfg, tcfg_, tol in (('plain', model_cfg, train_cfg,
                                       F32_TOL),
                                      ('128', model_128, train_128,
                                       BF16_TOL)):
            batches = graph_batches(mcfg.image_size, mcfg.y_dim,
                                    GRAPH_STEPS, dev)
            mu = cooccurrence_gating_matrix(
                torch.cat([y for _, y in batches]).cpu().numpy())
            t0 = tcfg_.gating_temp_for(mcfg)
            temps = [t0 * (0.99 if i >= GRAPH_STEPS // 2 else 1.0)
                     for i in range(GRAPH_STEPS)]
            res = eager_vs_captured(mcfg, tcfg_, mu, batches, kinds, temps,
                                    dev)
            check(res['launches'] == (GRAPH_STEPS, GRAPH_STEPS),
                  f'{key}: dequant launches {res["launches"]}, expected '
                  f'{GRAPH_STEPS} eager and captured')
            verdict = hold_captured(key, res, tol)
            out[key] = res['launches'][1]
            phase(40, f'({"a" if key == "plain" else "b"}) '
                      f'{mcfg.image_size} px {mcfg.compute_dtype} '
                      f'(s2d {mcfg.input_s2d}/{mcfg.output_s2d}, remat '
                      f'{tcfg_.remat}), bs {BATCH}, {GRAPH_STEPS} steps '
                      f'of the sup 0.5 interleave from one state, eager '
                      f'vs captured on cuDNN\'s deterministic algorithms: '
                      f'{verdict}; dequant launches {res["launches"]}')
            del batches

        # (c) the Trainer, phase 5's run
        splits = synthetic_splits(n_train=8 * BATCH, n_valid=2 * BATCH,
                                  n_test=2 * BATCH, sup_frac=0.5,
                                  image_size=model_cfg.image_size,
                                  y_dim=model_cfg.y_dim,
                                  learnable_signal=True)
        runs = {jit: train_and_test(f'phase 5, jit={jit}', model_cfg,
                                    train_cfg, splits, dev,
                                    f'chip_smoke_jit_{jit}', jit=jit)
                for jit in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    strip = lambda rows: [{k: v for k, v in r.items() if k != 'time'}
                          for r in rows]
    same_rows = strip(runs[True]['rows']) == strip(runs[False]['rows'])
    check(same_rows and runs[True]['test_acc'] == runs[False]['test_acc'],
          'Trainer: the captured run\'s metrics.csv or test accuracy '
          'differs from the eager run\'s')
    out['trainer'] = runs[True]['launches']
    meter = {jit: r['result']['images_per_sec'] for jit, r in runs.items()}
    phase(40, f'(c) phase 5\'s Trainer run (2 epochs, resident, '
              f'deterministic cuDNN) with jit=True and jit=False: '
              f'metrics.csv equal row for row ({len(runs[True]["rows"])} '
              f'rows), test accuracy {runs[True]["test_acc"]:.4f} both; '
              f'dequant launches {runs[True]["launches"]} and '
              f'{runs[False]["launches"]}')
    del runs

    # (d) speed, eager and captured, in turns (eager, captured, captured,
    # eager); each line's numbers are its second run
    name, sweep_model, sweep_train = dp_sweep()[0]
    sweep_train = dataclasses.replace(sweep_train, batch_size=SWEEP_BATCH)
    sweep_b, _ = sweep_inputs(SWEEP_BATCH, 0)
    plain_b = [(x.cpu().numpy(), y.cpu().numpy())
               for x, y in graph_batches(model_cfg.image_size,
                                         model_cfg.y_dim, 2, dev)]
    out['speed'] = {}
    for label, mcfg, tcfg_, host in (
            ('plain', model_cfg, train_cfg, plain_b),
            ('sweep', sweep_model, sweep_train, sweep_b)):
        mu = cooccurrence_gating_matrix(host[0][1]).astype(np.float32)
        batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
                   for x, y in host]
        got = {}
        for jit in (False, True, True, False):
            got[jit] = step_speed(mcfg, tcfg_, mu, batches, dev, jit)
        for jit in (False, True):
            s = got[jit]
            rec = dict(step=label, mode='captured' if jit else 'eager',
                       batch=len(host[0][0]), dtype=mcfg.compute_dtype,
                       wall_ms_median=s['wall_ms'], img_s=s['img_s'],
                       device_ms=s['device_ms'], busy=s['busy'],
                       host_launches=s['launches'],
                       host_launches_total=s['launches_total'],
                       dequant_counted=s['dequant_counted'],
                       dequant_seen_by_profiler=s['dequant_on_card'],
                       profiled_steps=SPEED_PROFILED,
                       peak_mib=s['peak_mib'],
                       trainer_meter_img_s=(meter[jit] if label == 'plain'
                                            else None),
                       card=smi)
            out['speed'][f'{label}_{rec["mode"]}'] = rec
            print('graphs_speed: ' + json.dumps(rec), flush=True)
            check(not jit or rec['host_launches_total']
                  <= CAPTURED_STEP_LAUNCHES,
                  f'(d) the captured {label} step: '
                  f'{rec["host_launches_total"]} host launches a step, '
                  f'over {CAPTURED_STEP_LAUNCHES}')
        del batches
    phase(40, f'(d) speed of the plain step (bs {BATCH}, f32) and the '
              f'sweep step ({name}, bs {SWEEP_BATCH}, bf16), eager and '
              f'captured: the graphs_speed lines above (median of '
              f'{SPEED_STEPS} synchronized steps, device ms and host '
              f'launches from {SPEED_PROFILED} profiled steps)')
    return out


#: Phase 41 (b)'s chunks: 16 steps of the sup 0.5 interleave cut into
#: chunks of 4, 4, 4, 3 and 1 steps: the mask patterns (sup, unsup, sup,
#: unsup), a short chunk (sup, unsup, sup) and a one-step chunk (unsup).
CHUNK_SIZES = (4, 4, 4, 3, 1)
#: Phase 41 (e): timed units a speed line (after 3 warm-up units, which
#: capture), and the profiled units after them.
DISPATCH_UNITS, DISPATCH_PROFILED = 10, 3
#: Phase 41 (a)'s eval splits (valid, test) and (e)'s eval images.
EVAL_SPLIT, SPEED_EVAL_IMAGES = 512, 2048


def eval_splits(model_cfg, dev, rows=None, seed=41):
    """Phase 41's eval splits from the seed: (valid, test), each `rows`
    (EVAL_SPLIT) u8 images of the model's size and f32 labels on `dev`."""
    import numpy as np
    import torch
    rows = EVAL_SPLIT if rows is None else rows
    rng = np.random.RandomState(seed)
    s, y = model_cfg.image_size, model_cfg.y_dim
    return [(torch.from_numpy(rng.randint(0, 256, (rows, s, s, 3)).astype(
                np.uint8)).to(dev),
             torch.from_numpy((rng.rand(rows, y) > 0.5).astype(
                 np.float32)).to(dev)) for _ in range(2)]


def eval_legs(model_cfg, train_cfg, mu, splits, dev, n=4, mesh=None):
    """Phase 41 (a): the eval and ELBO passes of one model over `splits`
    [(images u8, labels f32) on `dev`, whole batches of BATCH rows],
    eagerly (``jit=False``) and captured, each leg from a fresh eval
    generator of the Trainer's seed: per split a resident eval and a
    resident ELBO epoch (rows in a drawn order), then all the splits'
    batches stacked in chunked eval and ELBO passes of up to `n` batches;
    the whole sequence twice (the captured leg's first pass of each form
    captures, the others replay). Returns whether every value and the
    generator's final state are bit-equal, the largest gap, and each
    leg's dequant launches beside the batches it passed; and whether
    draws into static slices (``out=``) equal fresh draws. On a `mesh`
    (phase 42) the makers are the data-parallel ones: each resident split
    is this rank's rows of it, each chunk this rank's rows of its
    batches, the draws and values the global batch's."""
    import torch
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel.dp import DataParallel
    from gltvae_torch.train import steps as ts
    from gltvae_torch.train.state import init_model, step_seed
    dp = None if mesh is None else DataParallel(mesh)
    model = init_model(model_cfg, train_cfg, mu, dev)
    temp = train_cfg.gating_temp_for(model_cfg) * 0.99
    g = torch.Generator(device=dev).manual_seed(41)
    orders = [torch.randperm(len(x), generator=g, device=dev).view(-1, BATCH)
              for x, _ in splits]
    xs = torch.cat([x for x, _ in splits]).view(
        -1, BATCH, *splits[0][0].shape[1:])
    ys = torch.cat([y for _, y in splits]).view(-1, BATCH,
                                                splits[0][1].shape[1])
    legs = {}
    for jit in (False, True):
        make = {name: getattr(ts, f'make_{name}')(model, train_cfg, dp,
                                                  jit=jit)
                for name in ('resident_eval_step', 'resident_elbo_step',
                             'scan_eval_step', 'scan_elbo_step')}
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(train_cfg.seed + 1, 0))
        sync(dev)
        launches0 = preprocess.launches
        vals, batches = [], 0
        for _ in range(2):
            for (images, labels), idxs in zip(splits, orders):
                mine = _rank_rows(images, mesh)
                vals.append(make['resident_eval_step'](
                    model, mine, labels, idxs, gen, temp))
                vals.append(make['resident_elbo_step'](model, mine, idxs,
                                                       gen, temp))
                batches += 2 * len(idxs)
            for i in range(0, len(xs), n):
                xc, yc = (_rank_rows(a[i:i + n], mesh, 1) for a in (xs, ys))
                vals.append(make['scan_eval_step'](model, xc, yc, gen,
                                                   temp))
                vals.append(make['scan_elbo_step'](model, xc, gen, temp))
                batches += 2 * len(xc)
        sync(dev)
        legs[jit] = dict(vals=[v.cpu() for v in vals], gen=gen.get_state(),
                         launches=preprocess.launches - launches0,
                         batches=batches)
    eager, capt = legs[False], legs[True]
    equal = torch.equal(eager['gen'], capt['gen']) and all(
        torch.equal(a, b) for a, b in zip(eager['vals'], capt['vals']))
    gap = max(float((a - b).abs().max())
              for a, b in zip(eager['vals'], capt['vals']))
    gap_rel = max(float(((a - b).abs() / a.abs().clamp_min(1e-6)).max())
                  for a, b in zip(eager['vals'], capt['vals']))
    # a draw straight into a slice of a static buffer equals a fresh one,
    # Gumbels and raw uniforms alike; the raw draw's uniforms made Gumbels
    # (as the device parts make them) equal the Gumbel draw, and the
    # generator ends where it does
    draws_equal = True
    for fn, args in ((ts.draw_eval_noise, (model, BATCH)),
                     (ts.draw_noise, (model, BATCH, False, 0))):
        def draw(gen, out=None, raw=False, fn=fn, args=args):
            return fn(*args, gen, out=out, **({'raw': True} if raw else {}))
        # a draw put in the module's place may not take `raw`
        raws = ((False, True) if ts.draw_form(fn) == 'uniform'
                else (False,))
        for raw in raws:
            a, b = (torch.Generator(device=dev).manual_seed(5) for _ in 'ab')
            fresh = draw(a, raw=raw)
            bufs = {k: torch.empty((3,) + tuple(v.shape), dtype=v.dtype,
                                   device=dev) for k, v in fresh.items()}
            into = draw(b, {k: v[1] for k, v in bufs.items()}, raw)
            draws_equal &= all(torch.equal(fresh[k], into[k])
                               and into[k].data_ptr() == bufs[k][1].data_ptr()
                               for k in fresh)
            draws_equal &= torch.equal(a.get_state(), b.get_state())
        if True in raws:
            a, b = (torch.Generator(device=dev).manual_seed(5)
                    for _ in 'ab')
            gumbel, made = draw(a), ts.gate_gumbels(draw(b, raw=True))
            draws_equal &= gumbel.keys() == made.keys() and all(
                torch.equal(gumbel[k], made[k]) for k in gumbel)
            draws_equal &= torch.equal(a.get_state(), b.get_state())
    del model
    return dict(equal=bool(equal), gap=gap, gap_rel=gap_rel,
                draws_equal=bool(draws_equal),
                launches=(eager['launches'], capt['launches']),
                batches=(eager['batches'], capt['batches']))


def chunk_legs(model_cfg, train_cfg, mu, batches, kinds, temps, dev, sizes,
               legs=('steps', 'chunks', 'resident')):
    """Phase 41 (b) and (c): the steps `kinds` on `batches` eagerly and
    run as each of `legs` (``train_leg``), each held to the eager leg
    (``compare_legs``). Returns {leg: (equal, worst, launches)} with the
    eager leg's launches under 'eager'."""
    eager = train_leg(model_cfg, train_cfg, mu, batches, kinds, temps, dev,
                      'eager')
    out = {'eager': (True, None, eager['launches'])}
    for how in legs:
        got = train_leg(model_cfg, train_cfg, mu, batches, kinds, temps, dev,
                        how, sizes)
        out[how] = compare_legs(eager, got) + (got['launches'],)
    return out


def unit_speed(unit, images, dev, depth=None):
    """`unit()` (one dispatch's work; returns a device tensor) timed:
    `warmup` units, the median synchronized wall of `units` units, the
    mean of `units` units back to back (one wait at the end: a unit's
    host part then overlaps the device work of the unit before it, as in
    a run), then `profiled` units under torch.profiler: device ms a unit
    (kernel, copy and fill times), host launches a unit by runtime call,
    the busy share, img/s at `images` a unit. `depth` is (warmup, units,
    profiled), by default (3, DISPATCH_UNITS, DISPATCH_PROFILED)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = dev.type == 'cuda'
    warmup, units, profiled = depth or (3, DISPATCH_UNITS,
                                        DISPATCH_PROFILED)
    for _ in range(warmup):
        out = unit()
    walls = []
    for _ in range(units):
        sync(dev)
        t = time.perf_counter()
        out = unit()
        sync(dev)
        walls.append(time.perf_counter() - t)
    sync(dev)
    t = time.perf_counter()
    for _ in range(units):
        out = unit()
    sync(dev)
    pipelined_ms = (time.perf_counter() - t) / units * 1e3
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(dev)
    with profile(activities=acts) as prof:
        for _ in range(profiled):
            out = unit()
        sync(dev)
    check(bool(torch.isfinite(out.float()).all()),
          'dispatch speed: a value is not finite')
    events = prof.key_averages()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = (sum(e.self_device_time_total for e in on_card)
                 / 1e3 / profiled) if cuda else float('nan')
    nccl_ms = (sum(e.self_device_time_total for e in on_card
                   if 'nccl' in e.key.lower()) / 1e3 / profiled
               if cuda else float('nan'))
    launches = {e.key: e.count / profiled for e in events
                if e.key in LAUNCH_APIS}
    wall_ms = statistics.median(walls) * 1e3
    return dict(units=units, profiled=profiled, nccl_ms=nccl_ms,
                wall_ms=wall_ms, img_s=images / wall_ms * 1e3,
                pipelined_ms=pipelined_ms,
                pipelined_img_s=images / pipelined_ms * 1e3,
                device_ms=device_ms, busy=device_ms / wall_ms,
                launches=launches, launches_total=sum(launches.values()))


#: Phase 41 (e)'s large resident eval pass: the bench twin's dispatch
#: (``bench_eval_resident``: 384 batches of 256 rows, bf16, s2d) over a
#: split of SPEED_EVAL_IMAGES rows, as one graph only (its capture time
#: and memory; the eager pass, ~1.1 s and 45,699 launches, profiles for
#: tens of seconds), timed shallower: 1 warm-up, 3 units, 1 profiled.
BENCH_EVAL_BATCHES = 384
BENCH_EVAL_DEPTH = (1, 3, 1)
MODES = ('eager', 'replays', 'graph')


def speed_cases(model_cfg, train_cfg, model_a, train_a, dev):
    """Phase 41 (e)'s dispatches, each label -> (build, modes, depth),
    where build(mode) makes its model and inputs and returns (unit,
    images a unit, batch, dtype); the modes are 'eager' (``jit=False``),
    'replays' (a captured dispatch a batch or a step: one replay each,
    the augment eager before it) and 'graph' (one replay a dispatch);
    depth is ``unit_speed``'s (None: the default)."""
    import dataclasses

    import numpy as np
    import torch
    from gltvae_torch.config import dp_sweep
    from gltvae_torch.ops import preprocess
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train import steps as ts
    from gltvae_torch.train.state import create_train_state, init_model

    def evals(form, mcfg=model_cfg, batches=None):
        def build(mode):
            images, labels = eval_splits(mcfg, dev, SPEED_EVAL_IMAGES)[0]
            mu = cooccurrence_gating_matrix(labels.cpu().numpy())
            model = init_model(mcfg, train_cfg, mu, dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            idxs = torch.arange(SPEED_EVAL_IMAGES, device=dev).view(-1,
                                                                    BATCH)
            if batches is not None:     # rows drawn from the split
                idxs = torch.randint(0, SPEED_EVAL_IMAGES, (batches, BATCH),
                                     generator=gen, device=dev)
            xs = images.view(-1, BATCH, *images.shape[1:])
            ys = labels.view(-1, BATCH, labels.shape[1])
            if mode == 'replays':
                ev = ts.make_eval_step(model, train_cfg, jit=True)
                gather = form == 'resident'

                def unit():
                    return torch.stack([ev(
                        model, images.index_select(0, i) if gather else x,
                        labels.index_select(0, i) if gather else y, gen,
                        0.5) for i, x, y in zip(idxs, xs, ys)])
            elif form == 'resident':
                ev = ts.make_resident_eval_step(model, train_cfg,
                                                jit=mode == 'graph')
                unit = lambda: ev(model, images, labels, idxs, gen, 0.5)
            else:               # chunks of steps_per_dispatch 4
                ev = ts.make_scan_eval_step(model, train_cfg,
                                            jit=mode == 'graph')
                unit = lambda: torch.cat([
                    ev(model, xs[i:i + 4], ys[i:i + 4], gen, 0.5)
                    for i in range(0, len(xs), 4)])
            return unit, idxs.numel(), BATCH, mcfg.compute_dtype
        return build

    def chunk(mcfg, tcfg_, host, kinds):
        def build(mode):
            mu = cooccurrence_gating_matrix(host[0][1]).astype(np.float32)
            model = init_model(mcfg, tcfg_, mu, dev)
            state = create_train_state(model, tcfg_)
            xs = torch.stack([torch.from_numpy(host[i % len(host)][0])
                              for i in range(len(kinds))]).to(dev)
            ys = torch.stack([torch.from_numpy(host[i % len(host)][1])
                              for i in range(len(kinds))]).to(dev)
            if mode == 'replays':
                sup, unsup = ts.make_train_steps(model, tcfg_, jit=True)

                def unit():
                    return torch.stack([(sup if k else unsup)(
                        state, x, y, 1.0)[1]['loss']
                        for x, y, k in zip(xs, ys, kinds)])
            else:
                fn = ts.make_mixed_scan_train_step(model, tcfg_,
                                                   jit=mode == 'graph')
                unit = lambda: fn(state, xs, ys, kinds, 1.0)[1]['loss']
            return (unit, len(kinds) * len(xs[0]), len(xs[0]),
                    mcfg.compute_dtype)
        return build

    def augmented(mode):
        pad = train_a.augment_pad
        edge = model_a.image_size + 2 * pad
        rng = np.random.RandomState(41)
        x = torch.from_numpy(rng.randint(0, 256, (BATCH, edge, edge, 3))
                             .astype(np.uint8)).to(dev)
        y = torch.from_numpy((rng.rand(BATCH, model_a.y_dim) > 0.5)
                             .astype(np.float32)).to(dev)
        model = init_model(model_a, train_a,
                           cooccurrence_gating_matrix(y.cpu().numpy()), dev)
        state = create_train_state(model, train_a)
        crop = ts.train_crop(model, train_a)
        steps = ts.make_train_steps(model, train_a, jit=mode != 'eager')

        def unit():
            xb = x
            if mode != 'graph':       # the augment eager, before the step
                xb = preprocess.fused_augment_given(
                    x, *crop.draw(state.step, BATCH, dev), crop.size)
            return steps[state.step % 2](state, xb, y, 1.0)[1]['loss']
        return unit, BATCH, BATCH, model_a.compute_dtype

    name, sweep_model, sweep_train = dp_sweep()[0]
    sweep_train = dataclasses.replace(sweep_train, batch_size=SWEEP_BATCH)
    sweep_b, _ = sweep_inputs(SWEEP_BATCH, 0)
    plain_b = [(x.cpu().numpy(), y.cpu().numpy())
               for x, y in graph_batches(model_cfg.image_size,
                                         model_cfg.y_dim, 2, dev)]
    bench_eval = dataclasses.replace(model_cfg, compute_dtype='bfloat16',
                                     input_s2d=True, output_s2d=True)
    return {'eval_resident': (evals('resident'), MODES, None),
            'eval_chunked': (evals('chunked'), MODES, None),
            f'eval_resident_{BENCH_EVAL_BATCHES} (bench twin)': (
                evals('resident', bench_eval, BENCH_EVAL_BATCHES),
                ('graph',), BENCH_EVAL_DEPTH),
            'chunk4_plain': (chunk(model_cfg, train_cfg, plain_b,
                                   [True, False, True, False]), MODES,
                             None),
            f'chunk4_sweep ({name})': (chunk(sweep_model, sweep_train,
                                             sweep_b,
                                             [True, False, False, False]),
                                       MODES, None),
            'augmented_step': (augmented, MODES, None)}


def dispatch_phase(dev, smi, audited=None):
    """Phase 41: gltvae's compiled eval, ELBO and multi-step dispatches
    as CUDA graphs against their eager counterparts. (a) eval and ELBO
    passes, resident and chunked at n = 4, stochastic and deterministic,
    phase 5's model and phase 13's 128 px model; (b) 16 steps of the
    interleave as chunks (shipped, resident) against 16 eager steps and
    16 captured single steps, both models; (c) phase 9's augmented steps,
    per step and chunked at n = 4; (d) phase 5's Trainer at
    steps_per_dispatch 4 and phase 9's augmented run with jit=True and
    jit=False; (a)-(d) on cuDNN's deterministic algorithms; (e) speed
    lines and the Trainer meters on the default algorithms. Returns the
    launch counts of each part."""
    import dataclasses

    import torch
    from gltvae_torch.config import celeba128, default_celeba64
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer
    out = {}
    model_cfg, train_cfg = default_celeba64(sup=0.5, n_epochs=2,
                                            batch_size=BATCH)
    model_128, train_128 = celeba128(sup=0.5, n_epochs=2, batch_size=BATCH,
                                     remat='dots')
    model_128 = dataclasses.replace(model_128, compute_dtype='bfloat16',
                                    input_s2d=True, output_s2d=True)
    model_a, train_a = default_celeba64(sup=0.5, n_epochs=2,
                                        batch_size=BATCH, augment_pad=4)
    models = (('64', model_cfg, train_cfg, F32_TOL),
              ('128', model_128, train_128, BF16_TOL))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # (a) eval and ELBO
        out['eval'] = {}
        for key, mcfg, tcfg_, _ in models:
            splits = eval_splits(mcfg, dev)
            mu = cooccurrence_gating_matrix(splits[0][1].cpu().numpy())
            for det in (False, True):
                res = eval_legs(mcfg, dataclasses.replace(
                    tcfg_, deterministic_eval=det), mu, splits, dev)
                eager, capt = res['launches']
                check(res['equal'], f'(a) {key} px deterministic={det}: '
                      f'captured eval/ELBO values or the eval generator '
                      f'differ from eager (max abs {res["gap"]:.3e})')
                check(res['draws_equal'], f'(a) {key} px: draws into '
                      f'static slices differ from fresh draws, or the raw '
                      f'uniforms\' Gumbels from the Gumbel draws')
                check(eager == capt == res['batches'][0],
                      f'(a) {key} px: dequant launches {eager} eager, '
                      f'{capt} captured, for {res["batches"][0]} batches')
                out['eval'][f'{key}_{"det" if det else "stochastic"}'] = capt
                phase(41, f'(a) {mcfg.image_size} px {mcfg.compute_dtype} '
                          f'eval and ELBO, {"deterministic" if det else "stochastic"}: '
                          f'resident epochs of {EVAL_SPLIT}-image valid and '
                          f'test splits and chunked passes of 4 batches, '
                          f'twice, captured bit-equal to eager (values and '
                          f'the eval generator after); dequant launches '
                          f'{capt} captured (n a replay) = {eager} eager; '
                          f'draws into static slices equal fresh draws, '
                          f'the raw uniforms made Gumbels equal the Gumbel '
                          f'draws (the graphs\' gate transforms)')
            del splits

        # (b) chunks
        kinds = [i % 2 == 0 for i in range(GRAPH_STEPS)]
        out['chunks'] = {}
        for key, mcfg, tcfg_, tol in models:
            batches = graph_batches(mcfg.image_size, mcfg.y_dim,
                                    GRAPH_STEPS, dev)
            mu = cooccurrence_gating_matrix(
                torch.cat([y for _, y in batches]).cpu().numpy())
            t0 = tcfg_.gating_temp_for(mcfg)
            temps = [t0 * (0.99 if i >= GRAPH_STEPS // 2 else 1.0)
                     for i in range(GRAPH_STEPS)]
            res = chunk_legs(mcfg, tcfg_, mu, batches, kinds, temps, dev,
                             CHUNK_SIZES)
            verdicts = []
            for how in ('steps', 'chunks', 'resident'):
                equal, worst, launches = res[how]
                check(launches == (GRAPH_STEPS, 0),
                      f'(b) {key} px {how}: (dequant, augment) launches '
                      f'{launches}, expected ({GRAPH_STEPS}, 0)')
                verdicts.append(f'{how}: ' + hold_captured(
                    f'(b) {key} px {how}', dict(equal=equal, worst=worst),
                    tol))
            out['chunks'][key] = res['chunks'][2][0]
            phase(41, f'(b) {mcfg.image_size} px {mcfg.compute_dtype}, '
                      f'{GRAPH_STEPS} steps of the sup 0.5 interleave in '
                      f'chunks of {list(CHUNK_SIZES)} (3 mask patterns), '
                      f'against {GRAPH_STEPS} eager steps: '
                      f'{"; ".join(verdicts)}; dequant launches '
                      f'{GRAPH_STEPS} in every leg')
            del batches

        # (c) augmented: phase 9's model and padded batches
        pad_b = graph_batches(model_a.image_size + 2 * train_a.augment_pad,
                              model_a.y_dim, 8, dev, seed=9)
        mu = cooccurrence_gating_matrix(
            torch.cat([y for _, y in pad_b]).cpu().numpy())
        res = chunk_legs(model_a, train_a, mu, pad_b,
                         [i % 2 == 0 for i in range(8)], [1.0] * 8, dev,
                         (4, 4), legs=('steps', 'chunks'))
        want = {'eager': (0, 8), 'steps': (0, 8), 'chunks': (0, 2)}
        for how, (equal, worst, launches) in res.items():
            check(launches == want[how], f'(c) {how}: (dequant, augment) '
                  f'launches {launches}, expected {want[how]}')
            if how != 'eager':
                check(equal, f'(c) augmented {how}: captured != eager: '
                      + hold_captured(f'(c) {how}', dict(
                          equal=equal, worst=worst), {}))
        out['augment'] = {k: v[2][1] for k, v in res.items()}
        phase(41, f'(c) augmented (augment_pad {train_a.augment_pad}, '
                  f'(256, 72, 72, 3) -> 64), 8 steps of the interleave: '
                  f'captured per step and chunked at n = 4 bit-equal to '
                  f'the eager augment + step (metrics, params, Adam m and '
                  f'v); augment launches {out["augment"]} (one a replay, '
                  f'inside the graph), no dequant')
        del pad_b

        # (d) the Trainer both ways
        splits = synthetic_splits(n_train=8 * BATCH, n_valid=2 * BATCH,
                                  n_test=2 * BATCH, sup_frac=0.5,
                                  image_size=model_cfg.image_size,
                                  y_dim=model_cfg.y_dim,
                                  learnable_signal=True)
        splits_a = synthetic_splits(n_train=8 * BATCH, n_valid=2 * BATCH,
                                    n_test=2 * BATCH, sup_frac=0.5,
                                    image_size=model_a.image_size,
                                    y_dim=model_a.y_dim,
                                    learnable_signal=True,
                                    train_pad=train_a.augment_pad)
        kinds_before = dict((audited or {}).get('kinds', {}))
        runs = {jit: train_and_test(f'phase 41 (d) jit={jit}', model_cfg,
                                    train_cfg, splits, dev,
                                    f'chip_smoke_dispatch_{jit}',
                                    steps_per_dispatch=4, jit=jit)
                for jit in (False, True)}
        chunk_graphs = ((audited or {}).get('kinds', {}).get(
            'CapturedChunk', 0) - kinds_before.get('CapturedChunk', 0))
        aug = {jit: augmented_run(f'phase 41 (d) augmented jit={jit}',
                                  model_a, train_a, splits_a, dev,
                                  f'chip_smoke_dispatch_aug_{jit}', jit=jit)
               for jit in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    strip = lambda rows: [{k: v for k, v in r.items() if k != 'time'}
                          for r in rows]
    check(strip(runs[True]['rows']) == strip(runs[False]['rows'])
          and runs[True]['test_acc'] == runs[False]['test_acc'],
          '(d) Trainer at steps_per_dispatch 4: the captured run\'s '
          'metrics.csv or test accuracy differs from the eager run\'s')
    check(strip(aug[True]['rows']) == strip(aug[False]['rows'])
          and aug[True]['test_acc'] == aug[False]['test_acc'],
          '(d) augmented Trainer: the captured run\'s metrics.csv or test '
          'accuracy differs from the eager run\'s')
    check(aug[True]['launches'] == aug[False]['launches'] == (4, 6),
          f'(d) augmented Trainer: (augment, dequant) launches '
          f'{aug[True]["launches"]} captured, {aug[False]["launches"]} '
          f'eager, expected (4, 6)')
    flags = Trainer._schedule_flags(8, 2, 4)
    sizes = Trainer._chunk_sizes(flags, 4, True)
    at = [sum(sizes[:i]) for i in range(len(sizes))]
    patterns = sorted({tuple(flags[a:a + n]) for a, n in zip(at, sizes)})
    out['trainer'] = (runs[True]['launches'], runs[False]['launches'])
    out['trainer_augment'] = (aug[True]['launches'], aug[False]['launches'])
    phase(41, f'(d) phase 5\'s Trainer at steps_per_dispatch 4 (chunks '
              f'{sizes} an epoch, mask patterns {patterns}; chunk graphs '
              f'captured {chunk_graphs if audited else "not audited"}) and '
              f'phase 9\'s augmented run, jit=True and jit=False: '
              f'metrics.csv equal row for row ({len(runs[True]["rows"])} '
              f'and {len(aug[True]["rows"])} rows), test accuracy '
              f'{runs[True]["test_acc"]:.4f} and '
              f'{aug[True]["test_acc"]:.4f} both ways; dequant launches '
              f'{out["trainer"]}, (augment, dequant) '
              f'{out["trainer_augment"]}')
    del runs, aug

    # (e) speed, on the default algorithms
    out['speed'] = {}
    cuda = dev.type == 'cuda'
    for label, (build, modes, depth) in speed_cases(
            model_cfg, train_cfg, model_a, train_a, dev).items():
        for mode in modes:
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            unit, images, batch, dtype = build(mode)
            sync(dev)
            t = time.perf_counter()
            unit()              # the first call, which captures
            sync(dev)
            first_ms = (time.perf_counter() - t) * 1e3
            s = unit_speed(unit, images, dev, depth)
            peak = ((torch.cuda.max_memory_allocated(dev) - held) / 2**20
                    if cuda else 0.0)
            del unit
            rec = dict(phase=41, dispatch=label, mode=mode, batch=batch,
                       dtype=dtype, images=images,
                       first_call_ms=first_ms,
                       wall_ms_median=s['wall_ms'], img_s=s['img_s'],
                       pipelined_ms=s['pipelined_ms'],
                       pipelined_img_s=s['pipelined_img_s'],
                       device_ms=s['device_ms'], busy=s['busy'],
                       host_launches=s['launches'],
                       host_launches_total=s['launches_total'],
                       units=s['units'], profiled_units=s['profiled'],
                       peak_mib=peak,
                       card=smi)
            out['speed'][f'{label}_{mode}'] = rec
            print('graphs_speed: ' + json.dumps(rec), flush=True)
    meters = {}
    for jit in (False, True):
        r = train_and_test(f'phase 41 (e) meter jit={jit}', model_cfg,
                           train_cfg, splits, dev,
                           f'chip_smoke_dispatch_meter_{jit}', jit=jit)
        meters[jit] = r['result']['images_per_sec']
        rec = dict(phase=41, dispatch='trainer (phase 5, 2 epochs)',
                   mode='captured' if jit else 'eager', batch=BATCH,
                   trainer_meter_img_s=meters[jit], wall_s=r['wall'],
                   step_ms_median=statistics.median(r['step_s'][1:]) * 1e3,
                   card=smi)
        out['speed'][f'trainer_{rec["mode"]}'] = rec
        print('graphs_speed: ' + json.dumps(rec), flush=True)
        del r
    phase(41, f'(e) speed of the eval passes ({SPEED_EVAL_IMAGES} images, '
              f'bs {BATCH}, resident and in chunks of 4; and the bench '
              f'twin\'s resident pass of {BENCH_EVAL_BATCHES} batches, '
              f'bf16), a chunk of 4 plain and of 4 sweep steps and an '
              f'augmented step, eager, as per-batch or per-step replays and '
              f'as one graph, each with its first call: the '
              f'graphs_speed lines above (median of {DISPATCH_UNITS} '
              f'synchronized dispatches, and the mean of {DISPATCH_UNITS} '
              f'back to back; device ms and host launches from '
              f'{DISPATCH_PROFILED} profiled; the bench twin\'s pass '
              f'{BENCH_EVAL_DEPTH[1]} and {BENCH_EVAL_DEPTH[2]}); phase '
              f'5\'s Trainer meter '
              f'{meters[True]:.0f} img/s captured, {meters[False]:.0f} '
              f'eager, default cuDNN')
    return out


#: Phase 42: each process's kill (phase 39's), the chunk of (e)'s sweep
#: steps, and the stochastic inference temperature of (c) (infer's
#: default).
MESH_GRAPHS_TIMEOUT = 600.0
SPEED_CHUNK = (True, False, False, False)
INFER_TEMP = 0.3


def mesh_graph_cfgs():
    """Phase 42's configurations, {name: (ModelConfig, TrainConfig)}:
    phase 5's model ('plain'), phase 9's ('augment') and
    ``config.dp_sweep()[0]`` at global batch SWEEP_BATCH ('sweep')."""
    import dataclasses
    from gltvae_torch.config import default_celeba64, dp_sweep
    _, model_s, train_s = dp_sweep()[0]
    return {'plain': default_celeba64(sup=0.5, n_epochs=2, batch_size=BATCH),
            'augment': default_celeba64(sup=0.5, n_epochs=2,
                                        batch_size=BATCH, augment_pad=4),
            'sweep': (model_s, dataclasses.replace(train_s,
                                                   batch_size=SWEEP_BATCH))}


def _rank_rows(t, mesh, axis=0):
    """This rank's rows of a global tensor on `axis` (all of them off a
    mesh): contiguous, in rank order, as ``Mesh.rows``."""
    if mesh is None:
        return t
    n = t.shape[axis] // mesh.world
    return t.narrow(axis, mesh.rank * n, n)


def mesh_infer_legs(model_cfg, train_cfg, mu, photos, dev, mesh):
    """Phase 42 (c): ``infer.make_predict`` (``jit=False`` and captured)
    over the batches of the JPEG folder `photos`, decoded as ``infer``
    decodes them (DP_CLI_INFER_BS a batch, the wrap-around tail whole),
    deterministic and stochastic (each batch's generator seeded as
    ``infer --seed 0``), on one device (the global batch) and on the mesh
    (this rank's rows, the probabilities gathered). Returns the
    probabilities {(stochastic, 'device' or 'mesh', jit): [rows, y]} and
    the dequant launches."""
    import numpy as np
    import torch
    from gltvae_torch import infer as tinfer
    from gltvae_torch.data.celeba import ImageFolderDataset, _SplitData
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel.dp import DataParallel
    from gltvae_torch.train.state import init_model, step_seed
    names = sorted(os.listdir(photos))
    ds = ImageFolderDataset(photos, _SplitData(names, np.zeros((len(names),
                                                                  1))),
                            model_cfg.image_size)
    loader = BatchLoader(ds, DP_CLI_INFER_BS, shuffle=False, num_workers=4)
    it = iter(loader)
    try:
        batches = [torch.from_numpy(next(it)[0]).to(dev)
                   for _ in range(loader.epoch_batches)]
    finally:
        it.close()
    model = init_model(model_cfg, train_cfg, mu, dev).eval()
    dp = DataParallel(mesh)
    sync(dev)
    launches0 = preprocess.launches
    out = {}
    for stochastic in (False, True):
        for where, d in (('device', None), ('mesh', dp)):
            for jit in (False, True):
                predict = tinfer.make_predict(model, stochastic, INFER_TEMP,
                                              d, jit)
                probs = []
                for b, x in enumerate(batches):
                    g = torch.Generator(device=dev).manual_seed(
                        step_seed(0, b))
                    probs.append(predict(x if d is None
                                         else _rank_rows(x, mesh), g))
                out[(stochastic, where, jit)] = torch.cat(probs).cpu()
                del predict
    sync(dev)
    return dict(probs=out, launches=preprocess.launches - launches0,
                batches=len(batches), shape=tuple(batches[0].shape))


def mesh_speed(cfgs, dev, mesh):
    """Phase 42 (e) on this rank: ``config.dp_sweep()[0]``'s step (sup
    and unsup alternating) and a chunk of SPEED_CHUNK's steps at the
    global batch, this rank's rows, eager and captured, each timed by
    ``unit_speed`` (its NCCL share too) after a first call (which
    captures), with its peak memory above what was held before."""
    import numpy as np
    import torch
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train import steps as ts
    from gltvae_torch.train.state import create_train_state, init_model
    model_cfg, train_cfg = cfgs['sweep']
    B = train_cfg.batch_size
    host = sweep_inputs(B, 0)[0]
    mu = cooccurrence_gating_matrix(host[0][1]).astype(np.float32)
    dev_rows = [(_rank_rows(torch.from_numpy(x), mesh).to(dev),
                 _rank_rows(torch.from_numpy(y), mesh).to(dev))
                for x, y in host]
    cuda = dev.type == 'cuda'
    out = {}
    for label in ('step', 'chunk4'):
        for mode in ('eager', 'captured'):
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            model = init_model(model_cfg, train_cfg, mu, dev)
            state = shard_state(create_train_state(model, train_cfg), mesh)
            dp, jit = DataParallel(mesh), mode == 'captured'
            if label == 'step':
                fns = ts.make_train_steps(model, train_cfg, dp, jit)
                turn = [0]

                def unit():
                    x, y = dev_rows[turn[0] % 2]
                    fn = fns[turn[0] % 2]
                    turn[0] += 1
                    return fn(state, x, y, 1.0)[1]['loss']
                images = B
            else:
                fns = ts.make_mixed_scan_train_step(model, train_cfg, dp,
                                                    jit)
                xs = torch.stack([dev_rows[i % 2][0]
                                  for i in range(len(SPEED_CHUNK))])
                ys = torch.stack([dev_rows[i % 2][1]
                                  for i in range(len(SPEED_CHUNK))])
                unit = lambda: fns(state, xs, ys, SPEED_CHUNK, 1.0)[1][
                    'loss']
                images = B * len(SPEED_CHUNK)
            sync(dev)
            t = time.perf_counter()
            unit()
            sync(dev)
            first_ms = (time.perf_counter() - t) * 1e3
            s = unit_speed(unit, images, dev)
            peak = ((torch.cuda.max_memory_allocated(dev) - held) / 2**20
                    if cuda else 0.0)
            out[(label, mode)] = dict(s, first_call_ms=first_ms,
                                      peak_mib=peak, images=images)
            del unit, fns, state, model
    return out


def dp_graphs_speed_record(world, label, mode, batch, dtype, per_rank, smi):
    """Phase 42 (e)'s ``dp_graphs_speed:`` record of one dispatch from
    each rank's ``mesh_speed`` entry: rank 0's first call, waited wall
    (the median of synchronized dispatches) and back-to-back wall (the
    mean of dispatches enqueued in a row) with their img/s at the global
    batch; the device ms, NCCL ms and busy share of the rank with the
    most device time; rank 0's host launches; the largest peak memory;
    and the card."""
    slow = max(range(len(per_rank)),
               key=lambda r: (per_rank[r]['device_ms'], -r))
    r0, s = per_rank[0], per_rank[slow]
    return dict(phase=42, world=world, dispatch=label, mode=mode,
                batch=batch, rows_per_rank=batch // world, dtype=dtype,
                images=r0['images'], first_call_ms=r0['first_call_ms'],
                wall_ms_median=r0['wall_ms'], img_s=r0['img_s'],
                pipelined_ms=r0['pipelined_ms'],
                pipelined_img_s=r0['pipelined_img_s'],
                device_ms=s['device_ms'], device_rank=slow,
                nccl_ms=s['nccl_ms'], busy=s['device_ms'] / r0['wall_ms'],
                host_launches=r0['launches'],
                host_launches_total=r0['launches_total'],
                peak_mib=max(r['peak_mib'] for r in per_rank),
                units=r0['units'], profiled_units=r0['profiled'], card=smi)


def rank_line(n, rank, world, text):
    """Rank `rank` of `world` in phase `n` prints `text`, flushed and
    timestamped, so that a run cut at its limit shows where each rank
    stood."""
    print(f'[phase {n}] {time.strftime("%H:%M:%S")} rank {rank} of '
          f'{world}: {text}', flush=True)


def rank_mark(n, mesh, text):
    """A rank of phase `n` says that it starts `text` (``rank_line``)."""
    rank_line(n, mesh.rank, mesh.world, f'starting {text}')


def mesh_graphs_work(mesh, dev, cfgs, photos):
    """Phase 42 (a)-(c) on this rank, on cuDNN's deterministic
    algorithms: (a) phase 5's model, GRAPH_STEPS steps of the interleave
    eagerly and captured as single steps, as chunks of CHUNK_SIZES
    (shipped and resident) and as the shardmap steps (against their eager
    form), and on a mesh of one also captured off the mesh; (b) the eval
    and ELBO passes (``eval_legs``), stochastic and deterministic, and
    phase 9's augmented steps and chunks, with the rank's crop draws
    against its rows of one process's; (c) ``mesh_infer_legs``."""
    import dataclasses

    import torch
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.graphs import Crop
    out = {}
    rank_mark(42, mesh, '(a) steps, chunks, resident, shardmap and no-mesh')
    model_cfg, train_cfg = cfgs['plain']
    batches = graph_batches(model_cfg.image_size, model_cfg.y_dim,
                            GRAPH_STEPS, dev)
    mu = cooccurrence_gating_matrix(
        torch.cat([y for _, y in batches]).cpu().numpy())
    kinds = [i % 2 == 0 for i in range(GRAPH_STEPS)]
    t0 = train_cfg.gating_temp_for(model_cfg)
    temps = [t0 * (0.99 if i >= GRAPH_STEPS // 2 else 1.0)
             for i in range(GRAPH_STEPS)]
    legs = {how: (how, mesh) for how in ('eager', 'steps', 'chunks',
                                          'resident', 'shardmap_eager',
                                          'shardmap')}
    pairs = {'steps': 'eager', 'chunks': 'eager', 'resident': 'eager',
             'shardmap': 'shardmap_eager'}
    if mesh.world == 1:
        legs['no_mesh'] = ('steps', None)
        pairs['no_mesh'] = 'steps'
    runs = {name: train_leg(model_cfg, train_cfg, mu, batches, kinds, temps,
                            dev, how, CHUNK_SIZES, m)
            for name, (how, m) in legs.items()}
    out['a'] = {k: compare_legs(runs[ref], runs[k]) for k, ref in
                pairs.items()}
    out['a_launches'] = {k: v['launches'] for k, v in runs.items()}
    del runs, batches

    # (b) eval and ELBO passes; the augmented steps and chunks
    rank_mark(42, mesh, '(b) eval/ELBO passes and the augmented steps')
    splits = eval_splits(model_cfg, dev)
    mu_e = cooccurrence_gating_matrix(splits[0][1].cpu().numpy())
    out['b_eval'] = {det: eval_legs(model_cfg, dataclasses.replace(
        train_cfg, deterministic_eval=det), mu_e, splits, dev, mesh=mesh)
        for det in (False, True)}
    del splits
    model_a, train_a = cfgs['augment']
    pad_b = graph_batches(model_a.image_size + 2 * train_a.augment_pad,
                          model_a.y_dim, 8, dev, seed=9)
    mu_a = cooccurrence_gating_matrix(
        torch.cat([y for _, y in pad_b]).cpu().numpy())
    kinds_a = [i % 2 == 0 for i in range(8)]
    runs = {how: train_leg(model_a, train_a, mu_a, pad_b, kinds_a, [1.0] * 8,
                           dev, how, (4, 4), mesh)
            for how in ('eager', 'steps', 'chunks')}
    out['b_augment'] = {k: compare_legs(runs['eager'], runs[k])
                        for k in ('steps', 'chunks')}
    out['b_augment_launches'] = {k: v['launches'] for k, v in runs.items()}
    # this rank's crops: its rows of one process's draws, step by step,
    # and in the captured chunk's static draws (its last chunk, steps 4-7)
    B = len(pad_b[0][0])
    b = B // mesh.world
    one = Crop(model_a.image_size, train_a.augment_pad, train_a.seed)
    mine = Crop(model_a.image_size, train_a.augment_pad, train_a.seed,
                mesh.rank, mesh.world)
    rows = mesh.rows(B)
    want = [tuple(d[rows].cpu() for d in one.draw(s, B, dev))
            for s in range(8)]
    crops_equal = all(torch.equal(g.cpu(), w) for s in range(8)
                      for g, w in zip(mine.draw(s, b, dev), want[s]))
    static = runs['chunks']['crop_draws']
    crops_equal &= static is not None and all(
        torch.equal(static[i], torch.stack([want[s][i] for s in
                                            range(4, 8)]))
        for i in range(3))
    out['b_crops_equal'] = bool(crops_equal)
    del runs, pad_b

    # (c) inference
    rank_mark(42, mesh, '(c) inference')
    out['c'] = mesh_infer_legs(model_cfg, train_cfg, mu, photos, dev, mesh)
    return out


def mesh_graphs_rank(rank, world, url, devices, cfgs, photos, out_dir, root,
                     batch):
    """One rank of phase 42 on ``devices[rank]`` (its own card over NCCL;
    gloo on the CPU): every program it captures audited
    (``audit_graphs``), then ``mesh_graphs_work`` on cuDNN's
    deterministic algorithms and ``mesh_speed`` on the default ones;
    saves what it measured as <out_dir>/rank<r>.pt. `root` and `batch`
    are the parent's ROOT and BATCH."""
    global ROOT, BATCH
    ROOT, BATCH = root, batch
    sys.path.insert(0, ROOT)
    import faulthandler
    import torch
    from gltvae_torch.config import apply_precision
    from gltvae_torch.ops import preprocess
    from gltvae_torch.parallel import mesh as pmesh
    # a rank that hangs shows its Python stack before the parent kills it
    faulthandler.dump_traceback_later(MESH_GRAPHS_TIMEOUT - 30)
    dev = torch.device(devices[rank])
    cuda = dev.type == 'cuda'
    apply_precision(cfgs['plain'][0])       # TF32 off, as in training
    if cuda:
        torch.cuda.set_device(dev)
        audited = audit_graphs()
    else:
        torch.set_num_threads(1)
        count_plain_calls()
        audited = None
    pmesh.initialize_multihost(url, world, rank, device=dev,
                               backend='nccl' if cuda else 'gloo')
    try:
        mesh = pmesh.create_mesh(dev)
        check((mesh.rank, mesh.world, mesh.device) == (rank, world, dev)
              and mesh.backend == ('nccl' if cuda else 'gloo'),
              f'rank {rank}: mesh {mesh}')
        preprocess.launches = preprocess.augment_launches = 0
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            out = mesh_graphs_work(mesh, dev, cfgs, photos)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        rank_mark(42, mesh, '(e) mesh_speed')
        out['speed'] = mesh_speed(cfgs, dev, mesh)
        out['audit'] = audited
        out['backend'] = mesh.backend
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
        if world > 1:       # a rank that hangs leaving its group shows
            rank_line(42, rank, world, 'saved, leaving the group')
    except BaseException:
        # shown now: a rank that fails while its peers wait in a collective
        # can block in leaving the group, and its error would show only
        # at its exit
        rank_line(42, rank, world, 'failed:')
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        pmesh.shutdown()
    faulthandler.cancel_dump_traceback_later()
    if world > 1:
        rank_line(42, rank, world, 'left the group')


def mesh_graphs_report(world, ranks, smi, cfgs, spawn_s):
    """Phase 42's checks and lines for the ranks of one world (each
    rank's ``mesh_graphs_rank`` result). On a mesh of one every captured
    leg must equal its eager one (and the captured run off the mesh) bit
    for bit; on more ranks a train leg that is not bit-equal is held to
    ``F32_TOL`` with its gaps printed (NCCL may sum in another order under
    capture), an eval value to 1e-5 relative. The inference probabilities
    and the crops are held bit for bit everywhere. Returns rank 0's launch
    counts and the speed records."""
    import torch
    tag = f'D = {world}'
    B = cfgs['plain'][1].batch_size
    for r, got in enumerate(ranks):
        check(got['backend'] == ranks[0]['backend'], f'rank {r} backend')
        for how, launches in got['a_launches'].items():
            check(launches == (GRAPH_STEPS, 0),
                  f'(a) {tag} rank {r} {how}: (dequant, augment) launches '
                  f'{launches}, expected ({GRAPH_STEPS}, 0)')
        for how, launches in got['b_augment_launches'].items():
            want = (0, 2) if how == 'chunks' else (0, 8)
            check(launches == want, f'(b) {tag} rank {r} augmented {how}: '
                  f'(dequant, augment) launches {launches}, expected {want}')
        check(got['b_crops_equal'], f'(b) {tag} rank {r}: its crops are '
              f'not its rows of the one-process crops')
    verdicts = []
    for how, (equal, worst) in ranks[0]['a'].items():
        for r, got in enumerate(ranks):
            eq, w = got['a'][how]
            if world == 1 or how == 'no_mesh':
                check(eq, f'(a) {tag} {how}: captured != eager: '
                      + hold_captured(f'(a) {how}', dict(equal=eq, worst=w),
                                      {}))
            else:
                hold_captured(f'(a) {tag} rank {r} {how}',
                              dict(equal=eq, worst=w), F32_TOL)
        verdicts.append(f'{how}: ' + hold_captured(
            f'(a) {tag} {how}', dict(equal=equal, worst=worst), F32_TOL))
    phase(42, f'(a) {tag}, phase 5\'s model, {GRAPH_STEPS} steps of the '
              f'interleave, captured against eager on the mesh (rank 0; '
              f'every rank checked): {"; ".join(verdicts)}; dequant '
              f'launches {GRAPH_STEPS} in every leg ({B // world} rows a '
              f'rank); {ranks[0]["backend"]}')
    for det in (False, True):
        for r, got in enumerate(ranks):
            res = got['b_eval'][det]
            check(res['equal'] or (world > 1 and res['gap_rel'] <= 1e-5),
                  f'(b) {tag} rank {r} deterministic={det}: captured '
                  f'eval/ELBO differ from eager (max abs {res["gap"]:.3e}, '
                  f'rel {res["gap_rel"]:.3e})')
            check(res['launches'][0] == res['launches'][1]
                  == res['batches'][0], f'(b) {tag} rank {r}: dequant '
                  f'launches {res["launches"]} for {res["batches"]}')
    aug = []
    for how in ('steps', 'chunks'):
        for r, got in enumerate(ranks):
            eq, w = got['b_augment'][how]
            label = f'(b) {tag} rank {r} augmented {how}'
            if world == 1:
                check(eq, f'{label}: captured != eager: ' + hold_captured(
                    label, dict(equal=eq, worst=w), {}))
            else:
                hold_captured(label, dict(equal=eq, worst=w), F32_TOL)
        aug.append(f'{how}: ' + hold_captured(
            f'(b) augmented {how}', dict(zip(('equal', 'worst'),
                                             ranks[0]['b_augment'][how])),
            F32_TOL))
    ev = ranks[0]['b_eval']
    phase(42, f'(b) {tag}: eval and ELBO passes (resident epochs and '
              f'chunks of 4, stochastic and deterministic) captured '
              f'against eager: '
              + ', '.join(f'{"deterministic" if d else "stochastic"} '
                          f'{"bit-equal" if ev[d]["equal"] else "max rel %.3e" % ev[d]["gap_rel"]}'
                          for d in (False, True))
              + f' (values and the eval generator; dequant launches '
              f'{ev[False]["launches"][1]} a leg, n a replay); phase 9\'s '
              f'augmented steps and chunks of 4: {"; ".join(aug)}; '
              f'augment launches 8 / 8 / 2 (eager, steps, chunks); each '
              f'rank\'s crops its rows of the one-process crops')
    c = ranks[0]['c']
    for r, got in enumerate(ranks):
        probs = got['c']['probs']
        for stochastic in (False, True):
            for where in ('device', 'mesh'):
                check(torch.equal(probs[(stochastic, where, True)],
                                  probs[(stochastic, where, False)]),
                      f'(c) {tag} rank {r} stochastic={stochastic} '
                      f'{where}: captured probabilities != eager')
            if world == 1:
                check(torch.equal(probs[(stochastic, 'mesh', True)],
                                  probs[(stochastic, 'device', True)]),
                      f'(c) {tag}: the mesh of one != one device '
                      f'(stochastic={stochastic})')
        check(got['c']['launches'] == 8 * got['c']['batches'],
              f'(c) {tag} rank {r}: dequant launches {got["c"]["launches"]}')
    gap = max(float((c['probs'][(s, 'mesh', True)]
                     - c['probs'][(s, 'device', True)]).abs().max())
              for s in (False, True))
    phase(42, f'(c) {tag}: infer.make_predict over {c["batches"]} batches '
              f'of {DP_CLI_INFER_BS} of {sum(DP_CLI_PHOTOS)} JPEGs, '
              f'deterministic and stochastic, on one device and on the '
              f'mesh: captured probabilities bit-equal to eager '
              f'everywhere; mesh vs one device max |dp| {gap:.3e} '
              f'({"held at 0" if world == 1 else "printed"}); dequant '
              f'launches {c["launches"]} (one a call)')
    audits = [got['audit'] for got in ranks if got['audit'] is not None]
    if audits:
        a = audits[0]
        phase(42, f'(d) {tag}: every graph of every rank audited at its '
                  f'capture; rank 0: {a["graphs"]} graphs ({a["kinds"]}), '
                  f'{a["mesh_graphs"]} holding {a["collectives"]} '
                  f'collectives and {a["nccl_nodes"]} NCCL kernel nodes'
                  + (' (NCCL\'s one-rank path launches none)'
                     if world == 1 else ' (one a collective)')
                  + f', {a["dequant_nodes"]} dequant and '
                  f'{a["augment_nodes"]} augment nodes, each as its '
                  f'capture counted')
    records = {}
    model_s, train_s = cfgs['sweep']
    for (label, mode) in ranks[0]['speed']:
        rec = dp_graphs_speed_record(
            world, f'{label} ({model_s.compute_dtype}, global batch '
                   f'{train_s.batch_size})', mode, train_s.batch_size,
            model_s.compute_dtype, [got['speed'][(label, mode)]
                                    for got in ranks], smi)
        records[f'{label}_{mode}'] = rec
        print('dp_graphs_speed: ' + json.dumps(rec), flush=True)
    return dict(launches=dict(a=ranks[0]['a_launches'],
                              b_eval={str(d): v['launches']
                                      for d, v in ev.items()},
                              b_augment=ranks[0]['b_augment_launches'],
                              c=c['launches']),
                audit=ranks[0]['audit'], spawn_s=spawn_s, speed=records)


def mesh_graphs_phase(dev, smi, worlds, cfgs=None,
                      timeout_s=MESH_GRAPHS_TIMEOUT):
    """Phase 42: gltvae's compiled mesh dispatches as CUDA graphs with
    the NCCL collectives inside, at each of `worlds` ranks, one a card
    (NCCL; gloo on the CPU), spawned with a kill after `timeout_s`:
    ``mesh_graphs_rank`` on each, ``mesh_graphs_report`` of them. `cfgs`
    defaults to ``mesh_graph_cfgs()``. Returns each world's report."""
    import socket

    import torch
    from gltvae_torch.data.synthetic import write_celeba_corpus
    from gltvae_torch.parallel import mesh as pmesh
    t_phase = time.perf_counter()
    cfgs = cfgs or mesh_graph_cfgs()
    root = os.path.join(ROOT, 'build', 'chip_smoke_mesh_graphs')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    write_celeba_corpus(os.path.join(root, 'photos'), *DP_CLI_PHOTOS)
    photos = os.path.join(root, 'photos', 'img_align_celeba')
    cuda = dev.type == 'cuda'
    out = {}
    for world in worlds:
        leg_dir = os.path.join(root, f'd{world}')
        os.makedirs(leg_dir)
        if cuda:
            with socket.socket() as sk:     # a free port for the TCP store
                sk.bind(('127.0.0.1', 0))
                url = f'tcp://127.0.0.1:{sk.getsockname()[1]}'
            devices = [f'cuda:{r}' for r in range(world)]
        else:
            url = f'file://{os.path.join(leg_dir, "store")}'
            devices = ['cpu'] * world
        t0 = time.perf_counter()
        pmesh.spawn(mesh_graphs_rank, world,
                    (url, devices, cfgs, photos, leg_dir, ROOT, BATCH),
                    timeout_s)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(leg_dir, f'rank{r}.pt'),
                            weights_only=False) for r in range(world)]
        out[world] = mesh_graphs_report(world, ranks, smi, cfgs, spawn_s)
        phase(42, f'D = {world}: {world} rank(s) over '
                  f'{ranks[0]["backend"]}, {spawn_s:.1f} s with their '
                  f'start; card {smi}')
    out['wall_s'] = time.perf_counter() - t_phase
    phase(42, f'phase 42 wall {out["wall_s"]:.1f} s (worlds {worlds})')
    return out


#: Phase 43: a rank's bound on leaving its group with a captured program
#: alive (armed as a faulthandler dump and exit), and the kill of the
#: whole torchrun session.
TEARDOWN_BOUND = 60.0
TEARDOWN_TIMEOUT = 300.0


def teardown_worlds(worlds):
    """Phase 43's rank counts: those of `worlds` past one, or one where
    there is none (a card's NCCL group of one)."""
    return [w for w in worlds if w > 1] or [1]


def teardown_rank(report_dir, batch, device):
    """One rank of phase 43 under torchrun: ``config.dp_sweep()[0]``'s
    data-parallel sup step at global `batch` on this rank's rows of a
    seeded batch, made by default (captured over NCCL; on the CPU, over
    gloo, the static-buffer path, with nothing to capture) and run twice;
    then, with the step still held, ``parallel.mesh.shutdown`` under a
    TEARDOWN_BOUND-second faulthandler bound (a rank still inside dumps
    every thread's stack and exits 1), a timestamped line before and
    after; then the held step run once more, which must raise where it
    was captured. Writes ``<report_dir>/rank<r>.json``."""
    sys.path.insert(0, os.path.dirname(SCRIPT))
    import dataclasses
    import faulthandler

    import numpy as np
    import torch
    from gltvae_torch.config import apply_precision, dp_sweep
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train.graphs import JitStep
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import make_train_steps
    mesh = pmesh.create_mesh(device)
    rank, world = mesh.rank, mesh.world
    _, model_cfg, train_cfg = dp_sweep()[0]
    train_cfg = dataclasses.replace(train_cfg, batch_size=batch)
    apply_precision(model_cfg)
    r = np.random.RandomState(43)
    size = model_cfg.image_size
    x = r.randint(0, 256, (batch, size, size, 3)).astype(np.uint8)
    y = (r.rand(batch, model_cfg.y_dim) > 0.5).astype(np.float32)
    model = init_model(model_cfg, train_cfg, cooccurrence_gating_matrix(y),
                       mesh.device)
    state = shard_state(create_train_state(model, train_cfg), mesh)
    sup, _ = make_train_steps(model, train_cfg, DataParallel(mesh))
    rows = mesh.rows(batch)
    xr = torch.from_numpy(x[rows]).to(mesh.device)
    yr = torch.from_numpy(y[rows]).to(mesh.device)
    losses = []
    for _ in range(2):
        state, m = sup(state, xr, yr, 1.0)
        losses.append(float(m['loss']))
    program = (next(iter(sup.steps.values()))
               if isinstance(sup, JitStep) else None)
    captured = program is not None and program.graph is not None
    held = len(pmesh.registered())
    rank_line(43, rank, world, f'leaving the group with {held} registered '
                               f'program(s) alive, captured {captured}')
    faulthandler.dump_traceback_later(TEARDOWN_BOUND, exit=True)
    t0 = time.perf_counter()
    pmesh.shutdown()
    left_s = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    rank_line(43, rank, world, f'left the group in {left_s:.3f} s')
    raised = None
    if captured:
        try:
            sup(state, xr, yr, 1.0)
        except RuntimeError as e:
            raised = str(e)
    report = dict(rank=rank, world=world, backend=mesh.backend,
                  jit=program is not None, captured=captured,
                  registered=held,
                  collectives=program.collectives if program else 0,
                  released=bool(program and program.released),
                  left_s=left_s, raised=raised, losses=losses)
    with open(os.path.join(report_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)


def teardown_phase(dev, smi, worlds, batch=None):
    """Phase 43: ``teardown_rank`` through torchrun at each of `worlds`
    ranks (``teardown_worlds``), one a card over NCCL (gloo on the CPU),
    the session killed after TEARDOWN_TIMEOUT seconds. Held: every rank
    printed that it left its group within TEARDOWN_BOUND seconds, its
    losses finite and equal to rank 0's; on a card, its step captured by
    default, registered with the mesh, holding at least one collective,
    released at ``shutdown`` and raising when run again, naming the group
    it left. `batch` defaults to ``config.dp_sweep()[0]``'s global batch.
    Returns what each world measured."""
    from gltvae_torch.config import dp_sweep
    cuda = dev.type == 'cuda'
    batch = batch or dp_sweep()[0][2].batch_size
    root = os.path.join(ROOT, 'build', 'chip_smoke_teardown')
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for world in teardown_worlds(worlds):
        rep = os.path.join(root, f'd{world}')
        os.makedirs(rep)
        log = kept_log(f'teardown_d{world}.log')
        print(f'  phase 43 launch, {time.strftime("%H:%M:%S")}: {world} '
              f'rank(s)', flush=True)
        s = run_bounded(torchrun(world, SCRIPT, '--teardown-rank', rep,
                                 str(batch), 'cuda' if cuda else 'cpu'),
                        log, TEARDOWN_TIMEOUT)
        with open(log) as f:
            lines = [ln.rstrip() for ln in f if '[phase 43]' in ln]
        for ln in lines:
            print('  ' + ln[ln.index('[phase 43]'):], flush=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(rep, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        for r, got in enumerate(ranks):
            tag = f'D = {world} rank {r}'
            check(any(f'rank {r} of {world}: left the group' in ln
                      for ln in lines), f'{tag}: no line says it left')
            check(got['left_s'] < TEARDOWN_BOUND,
                  f'{tag}: left its group in {got["left_s"]:.1f} s')
            check(got['losses'] == r0['losses'] and all(
                math.isfinite(v) for v in got['losses']),
                f'{tag}: losses {got["losses"]}, rank 0 {r0["losses"]}')
            check(got['jit'] and got['backend'] == ('nccl' if cuda
                                                    else 'gloo'),
                  f'{tag}: step made with jit {got["jit"]} over '
                  f'{got["backend"]}')
            if cuda:
                check(got['captured'] and got['registered'] >= 1
                      and got['collectives'] >= 1 and got['released']
                      and 'left its process group' in (got['raised'] or ''),
                      f'{tag}: captured {got["captured"]}, registered '
                      f'{got["registered"]}, collectives '
                      f'{got["collectives"]}, released {got["released"]}, '
                      f'run after leaving: {got["raised"]}')
            else:       # the static-buffer path: nothing captured
                check(not got['captured'] and got['registered'] == 0,
                      f'{tag}: captured or registered on the CPU')
        out[world] = dict(seconds=s, left_s=[g['left_s'] for g in ranks],
                          registered=r0['registered'],
                          collectives=r0['collectives'],
                          captured=r0['captured'])
        made = (f'captured the sweep sup step at global batch {batch} '
                f'({r0["collectives"]} collective(s) in its graph)'
                if cuda else f'ran the sweep sup step at global batch '
                f'{batch} on the static-buffer path (nothing captured)')
        phase(43, f'D = {world}: {world} rank(s) over {r0["backend"]}, '
                  f'{s:.1f} s with their start: each {made}, kept it and '
                  f'left the group in '
                  + ', '.join(f'{v:.3f}' for v in out[world]['left_s'])
                  + f' s (bound {TEARDOWN_BOUND:.0f} s), releasing '
                  f'{r0["registered"]} registered program(s)'
                  + ('; the held step raised when run again' if cuda
                     else '') + f'; card {smi}')
    return out


def main(argv=None):
    import argparse
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ['--dp-cli-rank']:       # one process of phase 39
        profiled = argv[2:3] == ['--profiled']
        dp_cli_rank(argv[1], argv[2 + profiled:], profiled)
        return 0
    if argv[:1] == ['--teardown-rank']:     # one rank of phase 43
        teardown_rank(argv[1], int(argv[2]), argv[3])
        return 0
    p = argparse.ArgumentParser(description='Smoke run of the port on the '
                                'GPU (phases 1-43; see the module text).')
    p.add_argument('--sweep-only', action='store_true',
                   help='phases 1-2, 37, 42, 43 and 39 only: the sweep in '
                        'one process and, with 2 or more cards, on '
                        'min(cards, 4) NCCL ranks; the captured mesh '
                        'dispatches and the data-parallel CLI on 1 rank '
                        'and, with 2 or more cards, on 2 and min(cards, 4), '
                        'and leaving a group with a captured step alive '
                        'past one rank (the four-card check)')
    p.add_argument('--teardown-only', action='store_true',
                   help='phases 1-2 and 43 only: leaving a group with a '
                        'captured step alive, on 2 and min(cards, 4) NCCL '
                        'ranks (or --worlds)')
    p.add_argument('--worlds', default=None,
                   help='with --sweep-only or --teardown-only: the rank '
                        'counts of phases 42, 43 and 39, comma-separated '
                        '(default 1, 2 and min(cards, 4); never more than '
                        'the cards)')
    p.add_argument('--h2h-only', action='store_true',
                   help='phases 1-2, then the recorded head-to-head matrix '
                        'through the harness\'s port leg (13 runs of 12 '
                        'or 30 epochs on the 2,100-image parity corpus)')
    p.add_argument('--graphs-only', action='store_true',
                   help='phases 1-2, 40, 41 and 42 only: the captured train '
                        'steps, chunks, eval and ELBO passes and augmented '
                        'steps against the eager ones, and their speed, on '
                        'one device and on a mesh of one')
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

    audited = audit_graphs()

    if args.sweep_only or args.h2h_only or args.graphs_only \
            or args.teardown_only:
        if args.graphs_only:
            graphs = graphs_phase(dev, smi)
            dispatch = dispatch_phase(dev, smi, audited)
            audit_line(audited)
            mesh_graphs = mesh_graphs_phase(dev, smi, [1])
            print(json.dumps({'graphs': graphs, 'dispatch': {
                k: v for k, v in dispatch.items() if k != 'speed'},
                'graphs_audited': audited, 'mesh_graphs': mesh_graphs}),
                flush=True)
        if args.sweep_only:
            worlds = dp_cli_worlds(count, True, args.worlds)
            sweep = sweep_phase(dev, smi)
            mesh_graphs = mesh_graphs_phase(dev, smi, worlds)
            teardown = teardown_phase(dev, smi, worlds)
            dp_cli = dp_cli_phase(dev, smi, worlds)
            print(json.dumps({'sweep': sweep, 'dp_cli': dp_cli,
                              'mesh_graphs': mesh_graphs,
                              'teardown': teardown}), flush=True)
        if args.teardown_only:
            teardown = teardown_phase(
                dev, smi, dp_cli_worlds(count, True, args.worlds))
            print(json.dumps({'teardown': teardown}), flush=True)
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
    # the padded batches the captured chunks crop in their graphs
    check(aug_launches == 4 and aug_shapes == [(4, BATCH, PS, PS, 3)] * 4,
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
    # (captured steps: the resident run gathers each batch into a step's
    # static input, the shipped one copies it in)
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

    # ------------------------------------------------------------- 39
    dp_cli = dp_cli_phase(dev, smi, dp_cli_worlds(count, False))

    # ------------------------------------------------------------- 40
    graphs = graphs_phase(dev, smi)

    # ------------------------------------------------------------- 41
    dispatch = dispatch_phase(dev, smi, audited)
    audit_line(audited)

    # ------------------------------------------------------------- 42
    mesh_graphs = mesh_graphs_phase(dev, smi, [1])
    mesh1 = mesh_graphs[1]['launches']

    # ------------------------------------------------------------- 43
    teardown_phase(dev, smi, dp_cli_worlds(count, False))

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
        # phase 39: the data-parallel CLI through torchrun, each rank's
        # launches a world (the one process's beside them), and dequant
        # at a rank's rows of a 4096 batch on 4 and on 2 cards
        'launches_dp_cli_per_rank': {
            str(w): r['launches_per_rank']
            for w, r in dp_cli['worlds'].items()},
        'launches_dp_cli_one_process': dp_cli['one_process']['launches'],
        'shape_1024': dp_cli['shapes'][0],
        'shape_2048': dp_cli['shapes'][1],
        # phase 40: the captured steps of (a) and (b), one launch a
        # replay, and the captured Trainer run of (c)
        'launches_graphs': graphs['plain'],
        'launches_graphs_128': graphs['128'],
        'launches_graphs_trainer': graphs['trainer'],
        # phase 41: the captured eval and ELBO passes of (a) (n a replay),
        # the chunk graphs of (b), the Trainer at steps_per_dispatch 4
        # captured and eager (d)
        'launches_dispatch_eval': dispatch['eval'],
        'launches_dispatch_chunks': dispatch['chunks'],
        'launches_dispatch_trainer': dispatch['trainer'],
        'graphs_audited': audited,
        # phase 42: on a mesh of one over NCCL, counted at the replays:
        # each train leg of (a) (16 steps), the eval and ELBO passes of
        # (b) (eager, captured), inference (c); the ranks' graph audit
        'launches_mesh_graphs_train': mesh1['a'],
        'launches_mesh_graphs_eval': mesh1['b_eval'],
        'launches_mesh_graphs_infer': mesh1['c'],
        'mesh_graphs_audited': mesh_graphs[1]['audit'],
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
        # phase 41: (c) eager, per-step replays and chunk replays, and
        # (d) the augmented Trainer captured and eager (augment, dequant)
        'launches_dispatch_augment': dispatch['augment'],
        'launches_dispatch_trainer_augment': dispatch['trainer_augment'],
        # phase 42 (b): the augmented steps on a mesh of one, (dequant,
        # augment) eager, per-step replays, chunk replays
        'launches_mesh_graphs_augment': mesh1['b_augment'],
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': card_name,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
