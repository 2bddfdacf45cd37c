"""Where a step's time goes on the card: torch.profiler over a few
dispatches of a full-width model (counterpart of tools/profile_train.py).

    python -m gltvae_torch.profile_step [--mode train-step] [--steps 4] \\
        [--out build/profile] [--summary build/profile/summary.json] \\
        [--image-size 128 --compute-dtype bfloat16 --input-s2d on \\
         --output-s2d on --remat dots] [--resident-train off] \\
        [--scan 8] [--eval-images 16384] [--device cpu]

Modes (``--mode``):
  train-step     one train step a dispatch, sup and unsup alternating
                 (the default; bs 256)
  train-scan     a chunk of ``--scan`` supervised steps a dispatch (the
                 Trainer's ``steps_per_dispatch`` chunk)
  eval-resident  one eval pass over ``--eval-images`` images held on the
                 device, each batch gathered there (the Trainer's resident
                 eval)
  eval-chunked   one eval pass over ``--eval-images`` images staged on the
                 device as stacked [n, B, ...] batches (the Trainer's
                 chunked eval, without its host copies)

``--image-size 64`` is the CelebA-64 model, 128 the celeba128 one. With
``--resident-train auto`` (the Trainer's default) each train step gathers
its batch from a device-resident split, as the Trainer's resident path
does; ``off`` steps on batches already on the device (the shipped path
without its host-to-device copy). Prints the wall time per dispatch
(profiler off), the device time per dispatch (the sum of its kernels,
from a second, profiled run), the kernel launches per dispatch and the
kernels that take the most device time, and writes a Chrome trace under
--out. The profiled run records the program's spans too (the tracer,
``gltvae_torch.trace``, records under any profiler): they are in the
profiler's trace where it records host events (on the CPU), beside it as
``<mode>_spans.json``, and in the summary as each span's milliseconds a
dispatch. ``--summary PATH`` also writes those numbers as JSON under the
mode's key of PATH (other modes' entries in PATH are kept): the port's
form of profile_train.py's xprof summary. Runs on ``cuda`` unless
``--device cpu`` is given; on the CPU the times are the CPU's op times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

MODES = ('train-step', 'train-scan', 'eval-resident', 'eval-chunked')


def _trainer(args, dev):
    """The Trainer of the chosen model over synthetic splits (sup 0.5: bs
    sup rows and bs unsup rows) and its data on the device."""
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
                          splits['sup'].labels), device=dev)
    data = [trainer._place((splits[k].images, splits[k].labels))
            for k in ('sup', 'unsup')]
    return trainer, data


def build_train_step(args, dev):
    """One train step a dispatch, sup and unsup alternating."""
    trainer, data = _trainer(args, dev)
    bs = args.batch_size
    if args.resident_train == 'auto':
        # one gathered batch a step: the resident chunk of one step
        idx = torch.arange(bs, device=dev)[None]
        fns = [trainer._get_resident_train_fn(k) for k in ('sup', 'unsup')]
        steps = [lambda s, t, f=f, d=d: f(s, *d, idx, t)
                 for f, d in zip(fns, data)]
    else:
        steps = [lambda s, t, f=f, d=d: f(s, *d, t) for f, d in
                 zip((trainer._sup_step, trainer._unsup_step), data)]
    count = [0]

    def run():
        trainer.state, m = steps[count[0] % 2](trainer.state, 1.0)
        count[0] += 1
        return m['loss']
    return run, 1


def build_train_scan(args, dev):
    """A chunk of ``args.scan`` supervised steps a dispatch: the resident
    chunk (index rows gathered on the device) or the shipped chunk on a
    stacked [n, B, ...] batch already on the device."""
    from gltvae_torch.train.steps import make_scan_train_steps
    trainer, data = _trainer(args, dev)
    n, bs = max(args.scan, 1), args.batch_size
    x, y = data[0]
    if args.resident_train == 'auto':
        fn = trainer._get_resident_train_fn('sup')
        idx = torch.arange(bs, device=dev).repeat(n, 1)
        step = lambda s: fn(s, x, y, idx, 1.0)
    else:
        scan, _ = make_scan_train_steps(trainer.model, trainer.cfg)
        xs = x[None].repeat((n,) + (1,) * x.dim())
        ys = y[None].repeat(n, 1, 1)
        step = lambda s: scan(s, xs, ys, 1.0)

    def run():
        trainer.state, m = step(trainer.state)
        return m['loss']
    return run, n


def _eval_fixtures(args, dev):
    """(trainer, images [N, H, W, 3] u8, labels [N, y], index rows [nb, B])
    for ``args.eval_images`` images, on the device."""
    import numpy as np
    trainer, _ = _trainer(args, dev)
    n_images, bs = args.eval_images, args.batch_size
    nb = n_images // bs
    if nb < 1:
        raise SystemExit(f'--eval-images {n_images} is under one batch of '
                         f'{bs}')
    rng = np.random.RandomState(0)
    size, y_dim = args.image_size, trainer.model.cfg.y_dim
    images = rng.randint(0, 256, (n_images, size, size, 3)).astype(np.uint8)
    labels = (rng.rand(n_images, y_dim) > 0.5).astype(np.float32)
    idxs = rng.permutation(n_images)[:nb * bs].reshape(nb, bs)
    return (trainer, torch.from_numpy(images).to(dev),
            torch.from_numpy(labels).to(dev),
            torch.from_numpy(idxs.astype(np.int64)).to(dev))


def build_eval_resident(args, dev):
    """One resident eval pass a dispatch: every batch gathered from the
    images held on the device."""
    trainer, images, labels, idxs = _eval_fixtures(args, dev)

    def run():
        return trainer._resident_eval_step(trainer.model, images, labels,
                                           idxs, trainer._eval_gen, 0.3)
    return run, len(idxs)


def build_eval_chunked(args, dev):
    """One chunked eval pass a dispatch over stacked [n, B, ...] batches
    staged on the device."""
    trainer, images, labels, idxs = _eval_fixtures(args, dev)
    xs, ys = images[idxs], labels[idxs]

    def run():
        return trainer._scan_eval(trainer.model, xs, ys, trainer._eval_gen,
                                  0.3)
    return run, len(idxs)


SETUPS = {'train-step': build_train_step,
          'train-scan': build_train_scan,
          'eval-resident': build_eval_resident,
          'eval-chunked': build_eval_chunked}


def kernel_table(events, dispatches: int, top: int) -> dict:
    """The summary of one profiled run: the total self time and calls of
    `events` (``key_averages()`` entries of the run's device) per dispatch
    and the `top` entries by self time."""
    rows = sorted(((e.key, _self_us(e), e.count) for e in events),
                  key=lambda r: r[1], reverse=True)
    total_us = sum(r[1] for r in rows)
    return {
        'dispatches': dispatches,
        'device_ms_total': total_us / 1e3,
        'device_ms_per_dispatch': total_us / 1e3 / dispatches,
        'launches_per_dispatch': sum(r[2] for r in rows) / dispatches,
        'top_kernels': [{'name': k, 'device_ms_per_dispatch':
                         us / 1e3 / dispatches,
                         'calls_per_dispatch': c / dispatches}
                        for k, us, c in rows[:top]],
    }


def span_table(records, dispatches: int) -> dict:
    """Milliseconds a dispatch of each span name in `records`
    (``trace.records()``), summed over the spans of that name."""
    out = {}
    for r in records:
        if r['end_ns']:
            out[r['name']] = (out.get(r['name'], 0.0)
                              + (r['end_ns'] - r['start_ns']) / 1e6)
    return {k: v / dispatches for k, v in sorted(out.items())}


def _self_us(e) -> float:
    return (e.self_device_time_total
            if e.device_type == torch.autograd.DeviceType.CUDA
            else e.self_cpu_time_total)


def write_summary(path: str, mode: str, record: dict) -> dict:
    """Set `mode`'s entry of the JSON object at `path` to `record`, keeping
    the other modes' entries; returns the whole object."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out[mode] = record
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'w') as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--mode', default='train-step', choices=MODES)
    p.add_argument('--steps', type=int, default=4,
                   help='dispatches timed and profiled')
    p.add_argument('--batch-size', type=int, default=256)
    p.add_argument('--top', type=int, default=12)
    p.add_argument('--image-size', type=int, default=64, choices=[64, 128])
    p.add_argument('--compute-dtype', default='float32',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--input-s2d', default='off', choices=['on', 'off'])
    p.add_argument('--output-s2d', default='off', choices=['on', 'off'])
    p.add_argument('--remat', default='none', choices=['none', 'full', 'dots'])
    p.add_argument('--resident-train', default='auto', choices=['auto', 'off'])
    p.add_argument('--scan', type=int, default=8,
                   help='inner steps per dispatch (train-scan)')
    p.add_argument('--eval-images', type=int, default=16384,
                   help='images per eval pass (eval-resident, eval-chunked)')
    p.add_argument('--out', default=os.path.join('build', 'profile'))
    p.add_argument('--summary', default=None, metavar='PATH',
                   help="write the run's numbers as JSON under the mode's "
                        'key of PATH')
    p.add_argument('--device', default='cuda', help="'cuda' or 'cpu'")
    args = p.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from gltvae_torch import resolve_device, trace
    dev = resolve_device(args.device)
    cuda = dev.type == 'cuda'
    wait = torch.cuda.synchronize if cuda else (lambda: None)
    run, inner = SETUPS[args.mode](args, dev)

    for _ in range(4):                       # warm-up: cuDNN plans, builds
        out = run()
    float(out.flatten()[-1])
    wait()
    t = time.perf_counter()
    for _ in range(args.steps):              # wall time, profiler off
        out = run()
    wait()
    wall_ms = (time.perf_counter() - t) * 1e3 / args.steps
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    trace.reset()
    with profile(activities=[activity]) as prof:
        for _ in range(args.steps):
            out = run()
        wait()
    spans = span_table(trace.records(), args.steps)
    # the spans' own ranges are host time, not the device's
    events = [e for e in prof.key_averages()
              if e.device_type == kind and e.key not in spans]
    table = kernel_table(events, args.steps, args.top)
    dev_ms, n_kernels = (table['device_ms_per_dispatch'],
                         table['launches_per_dispatch'])
    bs = args.batch_size
    card = torch.cuda.get_device_name(dev) if cuda else 'cpu'
    print(f'card: {card}')
    print(f'config: {args.image_size} px, {args.compute_dtype}, input_s2d '
          f'{args.input_s2d}, output_s2d {args.output_s2d}, remat '
          f'{args.remat}, resident_train {args.resident_train}')
    unit = 'step'
    if args.mode == 'train-step':
        print(f'per step (mean of {args.steps}, sup/unsup alternating, '
              f'bs {bs}): wall {wall_ms:.3f} ms (profiler off), device '
              f'{dev_ms:.3f} ms (sum of kernel times, profiled run) = '
              f'{dev_ms / wall_ms:.1%} busy, {n_kernels:.0f} kernel '
              f'launches')
    else:
        unit = 'dispatch'
        scan = args.mode == 'train-scan'
        what = (f'{inner} sup steps' if scan
                else f'{inner} eval batches, {inner * bs} images')
        print(f'mode {args.mode}: per dispatch ({what}; mean of '
              f'{args.steps}, bs {bs}): wall {wall_ms:.3f} ms (profiler '
              f'off), device {dev_ms:.3f} ms (sum of kernel times, '
              f'profiled run) = {dev_ms / wall_ms:.1%} busy, '
              f'{n_kernels:.0f} kernel launches; per '
              f'{"step" if scan else "batch"} {dev_ms / inner:.3f} ms '
              f'device')
    print(f'{"device ms/" + unit:>14} {"calls/" + unit:>10}  kernel')
    for k in table['top_kernels']:
        print(f'{k["device_ms_per_dispatch"]:14.4f} '
              f'{k["calls_per_dispatch"]:10.1f}  {k["name"][:90]}')
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out,
                              f'{args.mode.replace("-", "_")}_trace.json')
    prof.export_chrome_trace(trace_path)
    print(f'trace: {trace_path}')
    spans_path = os.path.join(args.out,
                              f'{args.mode.replace("-", "_")}_spans.json')
    trace.write(spans_path)
    print(f'spans: {spans_path}')
    for name, ms in spans.items():
        print(f'{ms:14.4f} ms/{unit}  span {name}')
    record = dict(table, mode=args.mode, card=card, device=str(dev),
                  batch_size=bs, steps_per_dispatch=(
                      inner if args.mode.startswith('train') else None),
                  eval_batches_per_dispatch=(
                      inner if args.mode.startswith('eval') else None),
                  wall_ms_per_dispatch=wall_ms,
                  config={k: getattr(args, k) for k in (
                      'image_size', 'compute_dtype', 'input_s2d',
                      'output_s2d', 'remat', 'resident_train')},
                  trace=trace_path, spans=spans, spans_trace=spans_path)
    if args.summary:
        write_summary(args.summary, args.mode, record)
        print(f'summary -> {args.summary}')
    return record


if __name__ == '__main__':
    main()
