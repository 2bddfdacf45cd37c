"""Where a train step's time goes on the card: torch.profiler over a few
steps of a full-width model (bs 256, sup and unsup steps alternating).

    python -m gltvae_torch.profile_step [--steps 4] [--out build/profile] \\
        [--image-size 128 --compute-dtype bfloat16 --input-s2d on \\
         --output-s2d on --remat dots] [--resident-train off]

``--image-size 64`` is the CelebA-64 model, 128 the celeba128 one. With
``--resident-train auto`` (the Trainer's default) each step gathers its
batch from a device-resident split, as the Trainer's resident path does;
``off`` steps on batches already on the device (the shipped path without
its host-to-device copy). Prints the wall time per step (profiler off), the
device time per step (the sum of its kernels, from a second, profiled
run), the kernel launches per step and the kernels that take the most
device time, and writes a Chrome trace under --out. Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--steps', type=int, default=4)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--top', type=int, default=12)
    p.add_argument('--image-size', type=int, default=64, choices=[64, 128])
    p.add_argument('--compute-dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--input-s2d', default='off', choices=['on', 'off'])
    p.add_argument('--output-s2d', default='off', choices=['on', 'off'])
    p.add_argument('--remat', default='none', choices=['none', 'full', 'dots'])
    p.add_argument('--resident-train', default='auto', choices=['auto', 'off'])
    p.add_argument('--out', default=os.path.join('build', 'profile'))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step needs a CUDA device')
    from torch.profiler import ProfilerActivity, profile

    from gltvae_torch.config import celeba128, default_celeba64
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer

    bs = args.batch_size
    configs = default_celeba64 if args.image_size == 64 else celeba128
    model_cfg, train_cfg = configs(sup=0.5, batch_size=bs, remat=args.remat)
    model_cfg = dataclasses.replace(
        model_cfg, compute_dtype=args.compute_dtype,
        input_s2d=args.input_s2d == 'on', output_s2d=args.output_s2d == 'on')
    splits = synthetic_splits(n_train=2 * bs, n_valid=bs, n_test=bs,
                              sup_frac=0.5, image_size=args.image_size,
                              y_dim=model_cfg.y_dim, learnable_signal=True)
    trainer = Trainer(model_cfg, train_cfg,
                      mu_init=cooccurrence_gating_matrix(
                          splits['sup'].labels), device='cuda')
    kinds = ('sup', 'unsup')
    data = [trainer._place((splits[k].images, splits[k].labels))
            for k in kinds]
    if args.resident_train == 'auto':
        # one gathered batch a step: the resident chunk of one step
        idx = torch.arange(bs, device='cuda')[None]
        fns = [trainer._get_resident_train_fn(k) for k in kinds]
        steps = [lambda s, t, f=f, d=d: f(s, *d, idx, t)
                 for f, d in zip(fns, data)]
    else:
        steps = [lambda s, t, f=f, d=d: f(s, *d, t) for f, d in
                 zip((trainer._sup_step, trainer._unsup_step), data)]

    def run(n):
        for i in range(n):
            trainer.state, _ = steps[i % 2](trainer.state, 1.0)

    run(4)                                   # warm-up: cuDNN plans, builds
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(args.steps)                          # wall time, profiler off
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(args.steps)
        torch.cuda.synchronize()

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    print(f'card: {torch.cuda.get_device_name(0)}')
    print(f'config: {args.image_size} px, {args.compute_dtype}, input_s2d '
          f'{args.input_s2d}, output_s2d {args.output_s2d}, remat '
          f'{args.remat}, resident_train {args.resident_train}')
    print(f'per step (mean of {args.steps}, sup/unsup alternating, '
          f'bs {bs}): wall {wall_ms:.3f} ms (profiler off), device '
          f'{dev_us / 1e3 / args.steps:.3f} ms (sum of kernel times, '
          f'profiled run) = {dev_us / 1e3 / args.steps / wall_ms:.1%} busy, '
          f'{n_kernels / args.steps:.0f} kernel launches')
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f'{"device ms/step":>14} {"calls/step":>10}  kernel')
    for e in events[:args.top]:
        print(f'{e.self_device_time_total / 1e3 / args.steps:14.4f} '
              f'{e.count / args.steps:10.1f}  {e.key[:90]}')
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, 'train_step_trace.json')
    prof.export_chrome_trace(trace)
    print(f'trace: {trace}')


if __name__ == '__main__':
    main()
