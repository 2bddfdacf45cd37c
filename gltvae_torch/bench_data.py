"""Input-pipeline benchmark (counterpart of tools/bench_data.py, the same
rows): images/sec for decode+resize+batch across backends (PIL one at a
time ~= the reference's loader, cv2, the C++ native pool, the train-path
loaders per --decode-backend, cv2 + cache_decoded). Generates its own
JPEG corpus (``data/synthetic.py::make_bench_corpus``, the JAX tool's
bytes) so it runs anywhere.

    python -m gltvae_torch.bench_data --n 512 [--device-resize] \\
        [--device cpu]

With --device-resize it adds the device leg: one host->device copy of a
uint8 batch + one supervised train step (bf16, bs 256), with host-resized
batches (--out-size px) or full-resolution 218x178 batches resized on the
device, fenced by a device synchronize and a fetched loss. The decode rows
run on the host; the ship+step rows on ``cuda`` unless --device cpu.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def make_corpus(root, n, size=(218, 178)):
    """CelebA-format corpus: root/img_align_celeba/*.jpg + attr CSV, so
    the training-wired loader benches can use CelebAReader itself."""
    from gltvae_torch.data.synthetic import make_bench_corpus
    return make_bench_corpus(root, n, size)


def bench_training_loader(root, n, out_size, batch_size, backend, workers,
                          cache_decoded=False):
    """images/sec through the loader stack the CLI wires for
    --decode-backend: CelebAReader -> (BatchLoader worker threads | native
    C++ pool | grain-ordered loader) -> stacked uint8 batches. None where
    the backend is unavailable.

    cache_decoded warms a FULL epoch first so the timed loop measures
    the steady-state (epoch 2+) in-RAM cached path."""
    from gltvae_torch.config import DataConfig
    from gltvae_torch.data.celeba import CelebAReader
    nv = max(1, n // 8)
    cfg = DataConfig(data_dir=root, image_size=out_size,
                     n_train=n - 2 * nv, n_valid=nv, n_test=nv,
                     num_workers=workers, decode_backend=backend,
                     cache_decoded=cache_decoded)
    try:
        reader = CelebAReader(cfg, sup_frac=1.0, batch_size=batch_size)
        loader = reader.setup_data_loaders()['sup']
    except (RuntimeError, ValueError):
        return None          # backend unavailable
    it = iter(loader)
    nb = loader.epoch_batches
    for _ in range(nb if cache_decoded else min(2, nb)):
        next(it)             # warm workers / prefetch (+ fill the cache)
    total = 0
    t0 = time.perf_counter()
    for _ in range(nb * 3):
        x, _ = next(it)
        total += len(x)
    rate = total / (time.perf_counter() - t0)
    if hasattr(it, 'close'):
        it.close()
    return rate


def bench_pil_sequential(paths, out_size):
    """The reference's access pattern (its utils_data.py:48-63)."""
    import PIL.Image
    t0 = time.perf_counter()
    for p in paths:
        img = PIL.Image.open(p)
        img = np.array(img)
        img = np.array(PIL.Image.fromarray(img).resize((out_size, out_size)),
                       dtype=np.float32) / 255.0
    return len(paths) / (time.perf_counter() - t0)


def bench_cv2_sequential(paths, out_size):
    import cv2
    t0 = time.perf_counter()
    for p in paths:
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (out_size, out_size))
    return len(paths) / (time.perf_counter() - t0)


def bench_native(paths, out_size, threads):
    from gltvae_torch.data import native_loader
    if not native_loader.is_available():
        return None
    native_loader.decode_batch(paths[:16], out_size, num_threads=threads)
    t0 = time.perf_counter()
    native_loader.decode_batch(paths, out_size, num_threads=threads)
    return len(paths) / (time.perf_counter() - t0)


def bench_ship_and_step(out_size, batch_size=256, iters=20, full_res=False,
                        device='cuda'):
    """End-to-end device leg: host->device copy of a uint8 batch + one
    supervised train step, with either host-resized (out_size px) or
    FULL-RES (218x178) batches resized on the device (steps._prep_image ->
    ops/resize). Fenced by a device synchronize and a fetch of the loss.
    Returns images/sec."""
    import dataclasses

    import torch
    from gltvae_torch import resolve_device
    from gltvae_torch.config import ModelConfig, TrainConfig, celeba128
    from gltvae_torch.train.state import create_train_state, init_model
    from gltvae_torch.train.steps import make_train_steps

    dev = resolve_device(device)
    if out_size == 128:
        cfg, _ = celeba128()
        cfg = dataclasses.replace(cfg, compute_dtype='bfloat16')
    else:
        cfg = ModelConfig(compute_dtype='bfloat16')
    tc = TrainConfig(batch_size=batch_size)
    rng = np.random.RandomState(0)
    mu = rng.rand(cfg.z_classify, cfg.y_dim).astype(np.float32)
    model = init_model(cfg, tc, mu, dev)
    state = create_train_state(model, tc)
    sup, _ = make_train_steps(model, tc)

    shape = ((batch_size, 218, 178, 3) if full_res
             else (batch_size, out_size, out_size, 3))
    host_batches = [rng.randint(0, 256, shape, dtype=np.uint8)
                    for _ in range(4)]
    y = torch.from_numpy((rng.rand(batch_size, cfg.y_dim) > 0.5)
                         .astype(np.float32)).to(dev)

    def fence(m):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        return float(m['loss'])

    state, m = sup(state, torch.from_numpy(host_batches[0]).to(dev), y, 1.0)
    fence(m)                                   # warm: cuDNN plans, builds
    t0 = time.perf_counter()
    for i in range(iters):
        x = torch.from_numpy(host_batches[i % 4]).to(dev)   # fresh ship
        state, m = sup(state, x, y, 1.0)
    fence(m)                                   # completion fence
    return batch_size * iters / (time.perf_counter() - t0)


def row_names(out_size, threads, device_resize):
    """The result rows' names, in print order."""
    names = ['pil_sequential (reference pattern)', 'cv2_sequential',
             f'native_cpp_x{threads} (raw pool)']
    names += [f'train-path {b} x{threads}' for b in ('cv2', 'native',
                                                      'grain')]
    names.append('train-path cv2 + cache_decoded (epoch 2+)')
    if device_resize:
        names += [f'ship{out_size}px+step (host resize)',
                  'ship218x178+step (device resize)']
    return names


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--n', type=int, default=512)
    p.add_argument('--out-size', type=int, default=64)
    p.add_argument('--threads', type=int, default=os.cpu_count() or 1)
    p.add_argument('--device-resize', action='store_true',
                   help='also bench the host->device ship + train step '
                        'with host-resize vs full-res device-resize')
    p.add_argument('--device', default='cuda',
                   help="device of the ship+step rows: 'cuda' or 'cpu'")
    args = p.parse_args(argv)
    if args.device_resize:
        from gltvae_torch import resolve_device
        resolve_device(args.device)        # no card: fail before decoding

    with tempfile.TemporaryDirectory() as d:
        paths = make_corpus(d, args.n)
        rates = [bench_pil_sequential(paths, args.out_size),
                 bench_cv2_sequential(paths, args.out_size),
                 bench_native(paths, args.out_size, args.threads)]
        # the loader stacks exactly as the CLI's --decode-backend wires them
        bs = min(64, args.n // 4)
        for backend in ('cv2', 'native', 'grain'):
            rates.append(bench_training_loader(d, args.n, args.out_size, bs,
                                               backend, args.threads))
        rates.append(bench_training_loader(d, args.n, args.out_size, bs,
                                           'cv2', args.threads,
                                           cache_decoded=True))
    if args.device_resize:
        rates.append(bench_ship_and_step(args.out_size, full_res=False,
                                         device=args.device))
        rates.append(bench_ship_and_step(args.out_size, full_res=True,
                                         device=args.device))
    results = dict(zip(row_names(args.out_size, args.threads,
                                 args.device_resize), rates))
    for k, v in results.items():
        print(f'{k:45s} {"n/a" if v is None else f"{v:8.0f} img/s"}')
    return results


if __name__ == '__main__':
    main()
