"""Benchmark harness of the port, the twin of bench.py: ELBO train
images/sec on the CelebA-64 model (plus eval, end-to-end and traversal
rates), printed as ONE JSON line.

    python -m gltvae_torch.bench [--dtype float32 --scan 1 --input-s2d off
        --output-s2d off] [--image-size 128] [--device cpu]

It takes bench.py's flags but ``--prng`` (torch cannot replay threefry or
rbg), ``--no-compilation-cache`` and ``--platform`` (no torch.compile;
``--device`` picks the device), and adds ``--eval-images`` (the eval
benches' split size; bench.py fixes it at 16,384). ``--init-timeout`` is a
deadline on CUDA initialisation. Without CUDA it prints bench.py's error
line and exits 1 unless ``--device cpu`` is given; it never falls back to
the CPU.

Each bench draws its inputs from ``np.random.RandomState(0)`` in bench.py's
order (μ, then x, then y, then the per-slot stacks), so both harnesses
step identical data. Every timed loop ends in a host fetch of a value that
depends on its last step (bench.py:4-8), which waits for the device.

The JSON line has bench.py's keys but ``prng``, plus ``device`` (the
card's name). ``peak_hbm_mb`` is ``torch.cuda.max_memory_allocated`` over
the train-step bench. ``roofline`` holds the FLOPs of one step counted by
``torch.utils.flop_counter.FlopCounterMode`` on one extra step outside the
timed loop, and the rate they give at the timed step time; PyTorch has no
counterpart of XLA's cost analysis of bytes accessed, so
``step_mbytes_accessed`` and ``achieved_hbm_gbytes_per_sec`` are null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from gltvae_torch import resolve_device
from gltvae_torch.config import (ModelConfig, TrainConfig, apply_precision,
                                 celeba128)
from gltvae_torch.train.state import create_train_state, init_model

#: The reference's training rate, images/sec (BASELINE.md, derived).
BASELINE_IMAGES_PER_SEC = 700.0


def _to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def _labels(rng, *shape) -> np.ndarray:
    return (rng.rand(*shape) > 0.5).astype(np.float32)


def _images(rng, *shape) -> np.ndarray:
    return rng.randint(0, 256, shape).astype(np.uint8)


def train_inputs(rng, batch_size: int, image_size: int, y_dim: int,
                 scan: int) -> dict:
    """bench_train_step's draws in bench.py's order: μ (unit diagonal), x,
    y, and with scan > 1 the per-slot stacks xs, ys."""
    mu = rng.rand(y_dim, y_dim).astype(np.float32)
    np.fill_diagonal(mu, 1.0)
    out = {'mu': mu,
           'x': _images(rng, batch_size, image_size, image_size, 3),
           'y': _labels(rng, batch_size, y_dim)}
    if scan > 1:
        out['xs'] = _images(rng, scan, batch_size, image_size, image_size, 3)
        out['ys'] = _labels(rng, scan, batch_size, y_dim)
    return out


def eval_inputs(rng, batch_size: int, scan: int) -> dict:
    """bench_eval's draws: μ, then the stacked eval batches."""
    return {'mu': rng.rand(18, 18).astype(np.float32),
            'xs': _images(rng, scan, batch_size, 64, 64, 3),
            'ys': _labels(rng, scan, batch_size, 18)}


def resident_eval_inputs(rng, batch_size: int, n_images: int,
                         batches_per_dispatch: int) -> dict:
    """bench_eval_resident's draws: μ, the split's images and labels, one
    dispatch's [n, B] row indices."""
    return {'mu': rng.rand(18, 18).astype(np.float32),
            'images': _images(rng, n_images, 64, 64, 3),
            'labels': _labels(rng, n_images, 18),
            'idxs': rng.randint(0, n_images, (batches_per_dispatch,
                                              batch_size))}


def count_flops(fn) -> float:
    """FLOPs of one call of fn, counted by FlopCounterMode (convolutions
    and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def roofline(flops_per_step: float, secs_per_step: float) -> dict:
    """bench.py's roofline keys; bytes accessed has no PyTorch source."""
    return {'step_gflops': round(flops_per_step / 1e9, 3),
            'step_mbytes_accessed': None,
            'achieved_tflops_per_sec':
                round(flops_per_step / secs_per_step / 1e12, 3),
            'achieved_hbm_gbytes_per_sec': None}


def _model_config(image_size: int, compute_dtype: str, input_s2d: bool,
                  output_s2d: bool) -> ModelConfig:
    cfg = (celeba128()[0] if image_size == 128 else ModelConfig())
    return dataclasses.replace(cfg, compute_dtype=compute_dtype,
                               input_s2d=input_s2d, output_s2d=output_s2d)


def _model(cfg: ModelConfig, train_cfg: TrainConfig, mu, dev):
    apply_precision(cfg)
    return init_model(cfg, train_cfg, mu, dev)


def bench_train_step(batch_size: int, steps: int, warmup: int,
                     compute_dtype: str, supervised: bool = True,
                     scan: int = 0, image_size: int = 64,
                     semi_sup_period: int = 0, remat: str = 'none',
                     input_s2d: bool = False, output_s2d: bool = False,
                     device=None):
    """(images/sec, final loss, roofline) of the full train step at
    `batch_size`, data resident on the device as uint8: per-step dispatch
    (scan <= 1) or chunks of `scan` steps on distinct per-slot batches,
    all supervised or the semi-sup mix (1 supervised step per
    `semi_sup_period`)."""
    from gltvae_torch.train.steps import (make_mixed_scan_train_step,
                                          make_scan_train_steps,
                                          make_train_steps)
    dev = resolve_device(device)
    cfg = _model_config(image_size, compute_dtype, input_s2d, output_s2d)
    train_cfg = TrainConfig(batch_size=batch_size, remat=remat)
    ins = train_inputs(np.random.RandomState(0), batch_size, image_size,
                       cfg.y_dim, scan)
    model = _model(cfg, train_cfg, ins['mu'], dev)
    state = create_train_state(model, train_cfg)
    x, y = _to(dev, ins['x'], ins['y'])
    if scan > 1:
        xs, ys = _to(dev, ins['xs'], ins['ys'])
        if semi_sup_period > 1:
            # the reference's interleave as one mixed chunk: step i
            # supervised iff i % period == 0
            mixed = make_mixed_scan_train_step(model, train_cfg)
            mask = (np.arange(scan) % semi_sup_period == 0).tolist()

            def step(s):
                s, ms = mixed(s, xs, ys, mask, 1.0)
                return s, ms['loss'][-1]
        else:
            fn = make_scan_train_steps(model, train_cfg)[0 if supervised
                                                         else 1]

            def step(s):
                s, ms = fn(s, xs, ys, 1.0)
                return s, ms['loss'][-1]
        per_call = scan
    else:
        fn = make_train_steps(model, train_cfg)[0 if supervised else 1]

        def step(s):
            s, m = fn(s, x, y, 1.0)
            return s, m['loss']
        per_call = 1

    for _ in range(warmup):
        state, loss = step(state)
    float(loss)                     # fence: waits for the warmup's steps
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state)
    final_loss = float(loss)        # fence: depends on the last step
    dt = time.perf_counter() - t0
    flops = count_flops(lambda: step(state)) / per_call
    secs = dt / (steps * per_call)
    return batch_size / secs, final_loss, roofline(flops, secs)


def bench_eval(batch_size: int, iters: int = 20, scan: int = 64,
               input_s2d: bool = False, output_s2d: bool = False,
               device=None):
    """(images/sec, roofline) of stochastic eval over stacked batches (the
    chunked path of Trainer.evaluate: make_scan_eval_step), bf16."""
    from gltvae_torch.train.steps import make_scan_eval_step
    dev = resolve_device(device)
    cfg = ModelConfig(compute_dtype='bfloat16', input_s2d=input_s2d,
                      output_s2d=output_s2d)
    tc = TrainConfig(batch_size=batch_size)
    ins = eval_inputs(np.random.RandomState(0), batch_size, scan)
    model = _model(cfg, tc, ins['mu'], dev)
    ev = make_scan_eval_step(model, tc)
    xs, ys = _to(dev, ins['xs'], ins['ys'])
    gen = torch.Generator(device=dev).manual_seed(1)
    run = lambda: ev(model, xs, ys, gen, 0.3)
    total = run().sum() * 0.0 + run().sum()
    float(total)                    # fence
    t0 = time.perf_counter()
    total = total * 0.0
    for _ in range(iters):
        total = total + run().sum()
    float(total)                    # fence: depends on every iteration
    dt = time.perf_counter() - t0
    return (batch_size * scan * iters / dt,
            roofline(count_flops(run) / scan, dt / (iters * scan)))


def bench_eval_resident(batch_size: int = 256, n_images: int = 16384,
                        dispatches: int = 5, batches_per_dispatch: int = 384,
                        input_s2d: bool = False, output_s2d: bool = False,
                        device=None):
    """(images/sec, roofline) of device-resident eval: the split on the
    device as uint8 rows (copied outside the timed loop), each dispatch
    gathering `batches_per_dispatch` batches by index (the path
    Trainer.evaluate takes for splits that fit), bf16."""
    from gltvae_torch.train.steps import make_resident_eval_step
    dev = resolve_device(device)
    cfg = ModelConfig(compute_dtype='bfloat16', input_s2d=input_s2d,
                      output_s2d=output_s2d)
    tc = TrainConfig(batch_size=batch_size)
    ins = resident_eval_inputs(np.random.RandomState(0), batch_size,
                               n_images, batches_per_dispatch)
    model = _model(cfg, tc, ins['mu'], dev)
    ev = make_resident_eval_step(model, tc)
    images, labels, idxs = _to(dev, ins['images'], ins['labels'],
                               ins['idxs'])
    gen = torch.Generator(device=dev).manual_seed(1)
    run = lambda: ev(model, images, labels, idxs, gen, 0.3)
    total = run().sum() * 0.0 + run().sum()
    float(total)                    # fence
    t0 = time.perf_counter()
    total = total * 0.0
    for _ in range(dispatches):
        total = total + run().sum()
    float(total)                    # fence: depends on every dispatch
    dt = time.perf_counter() - t0
    nb = batches_per_dispatch
    return (batch_size * nb * dispatches / dt,
            roofline(count_flops(run) / nb, dt / (dispatches * nb)))


def bench_trainer_eval(batch_size: int = 256, n_images: int = 16384,
                       epochs: int = 3, input_s2d: bool = False,
                       output_s2d: bool = False, device=None):
    """(resident, chunked) images/sec of whole ``Trainer.evaluate`` epochs,
    each path paying what it pays in use: the resident path its index
    copy, the chunked one (64 batches a dispatch) its host fetch and
    copy of the whole split."""
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.train.loop import Trainer
    cfg = ModelConfig(compute_dtype='bfloat16', input_s2d=input_s2d,
                      output_s2d=output_s2d)
    tc = TrainConfig(batch_size=batch_size)
    rng = np.random.RandomState(0)
    mu = rng.rand(18, 18).astype(np.float32)
    images = _images(rng, n_images, 64, 64, 3)
    labels = _labels(rng, n_images, 18)
    out = []
    for mode in ('auto', 'off'):
        t = Trainer(cfg, tc, mu_init=mu, resident_eval=mode,
                    steps_per_dispatch=64, device=device)
        loader = BatchLoader(ArrayDataset(images, labels), batch_size,
                             seed=0)
        t.evaluate(loader)          # first call (and the resident copy)
        t0 = time.perf_counter()
        for _ in range(epochs):
            t.evaluate(loader)      # returns a host float: a fence
        out.append(epochs * n_images / (time.perf_counter() - t0))
    return tuple(out)


def bench_e2e(batch_size: int = 256, n_train: int = 2048,
              compute_dtype: str = 'bfloat16', device=None):
    """(cold, cached, resident) images/sec of whole training epochs
    through the real input stack: JPEG decode (CelebAReader's threaded
    BatchLoader), the host-to-device copy and chunks of supervised steps.
    'cold' decodes every image (epoch 1), 'cached' is epochs 2-4 from the
    in-RAM uint8 cache, 'resident' copies the split to the device once and
    sends index tensors (the Trainer's default). Makes its own corpus of
    218x178 JPEGs at quality 90 (make_bench_corpus) in a temporary
    directory."""
    import tempfile

    from gltvae_torch.config import DataConfig
    from gltvae_torch.data.celeba import CelebAReader
    from gltvae_torch.data.synthetic import make_bench_corpus
    from gltvae_torch.train.steps import (make_resident_scan_train_steps,
                                          make_scan_train_steps)
    dev = resolve_device(device)
    nv = max(batch_size, n_train // 8)
    with tempfile.TemporaryDirectory() as d:
        make_bench_corpus(d, n_train + 2 * nv)
        dcfg = DataConfig(data_dir=d, n_train=n_train, n_valid=nv,
                          n_test=nv, num_workers=os.cpu_count() or 1,
                          cache_decoded=True)
        reader = CelebAReader(dcfg, sup_frac=1.0, batch_size=batch_size)
        loader = reader.setup_data_loaders()['sup']
        nb = loader.epoch_batches

        cfg = ModelConfig(compute_dtype=compute_dtype)
        tc = TrainConfig(batch_size=batch_size)
        rng = np.random.RandomState(0)
        mu = rng.rand(cfg.y_dim, cfg.y_dim).astype(np.float32)
        np.fill_diagonal(mu, 1.0)
        model = _model(cfg, tc, mu, dev)
        state = create_train_state(model, tc)
        sup = make_scan_train_steps(model, tc)[0]
        # a first chunk on arrays of the real shapes, so epoch 1 times
        # decode + copy + steps, not first-call planning; the decode cache
        # stays cold (nothing here touches the loader)
        wx, wy = _to(dev, _images(rng, nb, batch_size, 64, 64, 3),
                     _labels(rng, nb, batch_size, cfg.y_dim))
        state, ms = sup(state, wx, wy, 1.0)
        float(ms['loss'][-1])

        it = iter(loader)           # the workers start decoding here

        def one_epoch(s):
            bx, by = zip(*(next(it) for _ in range(nb)))
            return sup(s, *_to(dev, np.stack(bx), np.stack(by)), 1.0)

        try:
            t0 = time.perf_counter()
            state, ms = one_epoch(state)      # epoch 1 decodes every JPEG
            float(ms['loss'][-1])
            t1 = time.perf_counter()
            warm_epochs = 3
            for _ in range(warm_epochs):      # epochs 2+: the RAM cache
                state, ms = one_epoch(state)
            float(ms['loss'][-1])
            t2 = time.perf_counter()
        finally:
            it.close()

        ds = loader.dataset
        images, labels = _to(dev, *ds.fetch(np.arange(len(ds))))
        res_sup = make_resident_scan_train_steps(model, tc)[0]

        def one_epoch_resident(s):
            idxs = np.stack([loader._next_batch_idxs() for _ in range(nb)])
            return res_sup(s, images, labels, *_to(dev, idxs), 1.0)

        state, ms = one_epoch_resident(state)             # first call
        float(ms['loss'][-1])
        res_epochs = 3
        t3 = time.perf_counter()
        for _ in range(res_epochs):
            state, ms = one_epoch_resident(state)
        float(ms['loss'][-1])
        t4 = time.perf_counter()
    return (nb * batch_size / (t1 - t0),
            warm_epochs * nb * batch_size / (t2 - t1),
            res_epochs * nb * batch_size / (t4 - t3))


def bench_traversal(n_steps: int = 8, iters: int = 20, device=None) -> float:
    """ms per latent-traversal grid (45 dims x `n_steps` = 360 images at
    the default) of the CelebA-64 model."""
    from gltvae_torch.eval.traversal import make_traversal_fn
    dev = resolve_device(device)
    cfg = ModelConfig()
    model = _model(cfg, TrainConfig(), np.eye(18, dtype=np.float32), dev)
    fn = make_traversal_fn(model, n_steps=n_steps)
    z = torch.zeros(cfg.z_dim, device=dev)
    float(fn(z).sum())              # first call + fence
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(z)
    # device work runs in stream order: fencing the last grid fences all
    float(out.sum())
    return (time.perf_counter() - t0) / iters * 1000.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--steps', type=int, default=50)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--scan', type=int, default=32,
                   help='steps per dispatch, each on its own batch '
                        '(1 = per-step dispatch)')
    p.add_argument('--image-size', type=int, default=64, choices=[64, 128])
    p.add_argument('--semi-sup-period', type=int, default=0, metavar='P',
                   help='bench the mixed semi-sup chunk: 1 supervised step '
                        'per P (5 ~ the sup=0.2 schedule); needs --scan > 1')
    p.add_argument('--remat', default='none',
                   choices=['none', 'full', 'dots'],
                   help='recompute the loss forward in the backward pass '
                        '(TrainConfig.remat)')
    p.add_argument('--input-s2d', default='on', choices=['on', 'off'],
                   help="space-to-depth form of the encoder's first conv "
                        '(ModelConfig.input_s2d); on as in bench.py')
    p.add_argument('--output-s2d', default='on', choices=['on', 'off'],
                   help="space-to-depth form of the decoder's last conv "
                        '(ModelConfig.output_s2d); on as in bench.py')
    p.add_argument('--skip-traversal', action='store_true',
                   help='skip the traversal and the eval rows')
    p.add_argument('--skip-e2e', action='store_true',
                   help='skip the end-to-end (JPEG decode included) rows')
    p.add_argument('--e2e-train-images', type=int, default=2048,
                   help='train-corpus size for the e2e rows (whole epochs '
                        'are timed; a multiple of --batch-size)')
    p.add_argument('--eval-images', type=int, default=16384,
                   help='eval split size N: the chunked eval bench steps '
                        'N/B batches a dispatch, the resident one gathers '
                        '6N/B a dispatch from N rows, the Trainer bench '
                        'evaluates N images (bench.py: 16384)')
    p.add_argument('--init-timeout', type=float, default=600.0,
                   help='seconds to wait for CUDA initialisation before '
                        'printing an error line and exiting 1')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def _metric(args) -> str:
    kind = ('semi-sup 1/%d mix' % args.semi_sup_period
            if args.semi_sup_period > 1 else 'sup step')
    return ('ELBO train images/sec/chip (CelebA-%d, %s, bs %d, %s)'
            % (args.image_size, kind, args.batch_size, args.dtype))


def _init_device(args):
    """(device, device name) or (None, error text): CUDA initialised in a
    thread under the --init-timeout deadline, unless --device cpu."""
    dev = torch.device(args.device)
    if dev.type == 'cpu':
        return dev, 'cpu'
    done, box = threading.Event(), {}

    def init():
        try:
            if not torch.cuda.is_available():
                box['error'] = ('no CUDA device (pass --device cpu to bench '
                                'the CPU)')
            else:
                torch.cuda.init()
                box['name'] = torch.cuda.get_device_name(dev)
        except Exception as e:               # reported on the error line
            box['error'] = f'{type(e).__name__}: {e}'
        done.set()

    threading.Thread(target=init, daemon=True).start()
    if not done.wait(args.init_timeout):
        return None, (f'CUDA initialisation still blocked after '
                      f'{args.init_timeout:.0f}s')
    if 'error' in box:
        return None, box['error']
    return dev, box['name']


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.semi_sup_period > 1 and args.scan <= 1:
        raise SystemExit('--semi-sup-period benches the mixed chunk and '
                         'requires --scan > 1')
    dev, name = _init_device(args)
    if dev is None:
        print(json.dumps({'metric': _metric(args), 'value': None,
                          'unit': 'images/sec', 'vs_baseline': None,
                          'error': name}), flush=True)
        return 1
    cuda = dev.type == 'cuda'
    s2d, os2d = args.input_s2d == 'on', args.output_s2d == 'on'
    bs = args.batch_size
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ips, loss, roof = bench_train_step(
        bs, args.steps, args.warmup, args.dtype, scan=args.scan,
        image_size=args.image_size, semi_sup_period=args.semi_sup_period,
        remat=args.remat, input_s2d=s2d, output_s2d=os2d, device=dev)
    peak = (round(torch.cuda.max_memory_allocated(dev) / 2**20, 1) if cuda
            else None)
    traversal_ms = (None if args.skip_traversal
                    else bench_traversal(device=dev))
    # the eval benches build the 64 px model: at --image-size 128 their
    # rows would describe another model than the train row
    skip_eval = args.skip_traversal or args.image_size != 64
    n_eval = args.eval_images
    eval_ips = eval_roof = eval_res_ips = eval_res_roof = None
    tr_res = tr_chk = None
    if not skip_eval:
        eval_ips, eval_roof = bench_eval(bs, scan=max(1, n_eval // bs),
                                         input_s2d=s2d, output_s2d=os2d,
                                         device=dev)
        eval_res_ips, eval_res_roof = bench_eval_resident(
            bs, n_images=n_eval, batches_per_dispatch=max(1, 6 * n_eval // bs),
            input_s2d=s2d, output_s2d=os2d, device=dev)
        tr_res, tr_chk = bench_trainer_eval(bs, n_images=n_eval,
                                            input_s2d=s2d, output_s2d=os2d,
                                            device=dev)
    e2e = (None, None, None)
    if not args.skip_e2e and args.image_size == 64:
        try:
            e2e = bench_e2e(bs, n_train=args.e2e_train_images,
                            compute_dtype=args.dtype, device=dev)
        except Exception as e:  # e2e needs PIL, a decoder and scratch disk
            print(f'# e2e bench skipped: {type(e).__name__}: {e}',
                  flush=True)
    r1 = lambda v: None if v is None else round(v, 1)
    print(json.dumps({
        'metric': _metric(args),
        'value': round(ips, 1),
        'unit': 'images/sec',
        'vs_baseline': round(ips / BASELINE_IMAGES_PER_SEC, 2),
        'backend': dev.type,
        'device': name,
        'remat': args.remat,
        'input_s2d': args.input_s2d,
        'output_s2d': args.output_s2d,
        'final_loss': round(loss, 2),
        'traversal_ms_per_grid': (None if traversal_ms is None
                                  else round(traversal_ms, 3)),
        'peak_hbm_mb': peak,
        'peak_hbm_source': 'torch.cuda.max_memory_allocated' if cuda
        else None,
        'eval_images_per_sec': r1(eval_ips),
        'eval_images_per_sec_resident': r1(eval_res_ips),
        'trainer_eval_images_per_sec_resident': r1(tr_res),
        'trainer_eval_images_per_sec_chunked': r1(tr_chk),
        'e2e_images_per_sec': r1(e2e[0]),
        'e2e_images_per_sec_cached': r1(e2e[1]),
        'e2e_images_per_sec_resident': r1(e2e[2]),
        'roofline': roof,
        'eval_roofline': eval_roof,
        'eval_roofline_resident': eval_res_roof,
    }), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
