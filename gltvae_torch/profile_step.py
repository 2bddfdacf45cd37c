"""Where a train step's time goes on the card: torch.profiler over a few
steps of the full-width CelebA-64 model (bs 256, sup and unsup steps).

    python -m gltvae_torch.profile_step [--steps 4] [--out build/profile]

Prints the wall time per step (profiler off), the device time per step
(the sum of its kernels, from a second, profiled run), the kernel launches
per step and the kernels that take the most device time, and writes a
Chrome trace under --out. Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--steps', type=int, default=4)
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--top', type=int, default=12)
    p.add_argument('--out', default=os.path.join('build', 'profile'))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_step needs a CUDA device')
    from torch.profiler import ProfilerActivity, profile

    from gltvae_torch.config import default_celeba64
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.train.loop import Trainer

    bs = args.batch_size
    model_cfg, train_cfg = default_celeba64(sup=0.5, batch_size=bs)
    splits = synthetic_splits(n_train=2 * bs, n_valid=bs, n_test=bs,
                              sup_frac=0.5, learnable_signal=True)
    trainer = Trainer(model_cfg, train_cfg,
                      mu_init=cooccurrence_gating_matrix(
                          splits['sup'].labels), device='cuda')
    batches = [trainer._place((splits[k].images[:bs], splits[k].labels[:bs]))
               for k in ('sup', 'unsup')]
    steps = [trainer._sup_step, trainer._unsup_step]

    def run(n):
        for i in range(n):
            x, y = batches[i % 2]
            trainer.state, _ = steps[i % 2](trainer.state, x, y, 1.0)

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
