"""Data-parallel training over one process a chip, as ``cli.py --mesh``
builds it: each rank joins the group (``initialize_multihost`` with a
coordinator on a port picked free at run time, then
``parallel.mesh.create_mesh``), host-shards its loaders, trains its
``Trainer(mesh=..., local_batches=True)`` and leaves through
``parallel.mesh.shutdown``.

The cell's command spawns the ranks and waits for them. Rank 0's
timeline gives the window and the intervals; each rank traces the same
epoch. The ranks hand their readings back in files (rank 0's Adam moments
with ``torch.save`` beside its JSON record); once they have left, this
process runs the reference at the global batch on chip 0.

Traffic keys: as ``train_epochs``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import torch

import harness as H
import checks as C
from drivers.train_epochs import train_record
from session import TrainSession

#: seconds a rank may take, set-up included
RANK_TIMEOUT_S = 330


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run(ctx) -> dict:
    cell, world = ctx.cell, ctx.cell.chips
    port = free_port()
    # one OpenMP thread a rank unless the caller says otherwise, as
    # torchrun starts the command line's ranks
    env = dict(os.environ)
    env.setdefault('OMP_NUM_THREADS', '1')
    procs, files = [], []
    for r in range(world):
        out = os.path.join(ctx.tmp, f'rank{r}.json')
        logf = open(os.path.join(ctx.tmp, f'rank{r}.log'), 'w')
        files.append((out, logf))
        argv = [sys.executable, os.path.join(H.BENCH, 'run.py'),
                '--workload', cell.name, '--seed', str(ctx.seed),
                '--seconds', str(ctx.seconds), '--trace', str(int(ctx.trace)),
                '--rank', str(r), '--world', str(world), '--port', str(port),
                '--t0', repr(ctx.t0_wall), '--rank-out', out,
                '--device', ctx.device.type]
        if ctx.sizes:
            argv += ['--sizes', json.dumps(ctx.sizes)]
        procs.append(subprocess.Popen(argv, stdout=logf, env=env,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for _, logf in files:
            logf.close()
    results = []
    for r, (p, (out, logf)) in enumerate(zip(procs, files)):
        if p.returncode != 0 or not os.path.exists(out):
            with open(logf.name) as f:
                H.log(f'rank {r} exited {p.returncode}:\n' + f.read()[-6000:])
            raise RuntimeError(f'rank {r} of {world} failed')
        with open(out) as f:
            results.append(json.load(f))
    r0 = results[0]
    bad = sorted({m for r in results for m in r['forbidden']})
    if bad:
        raise RuntimeError(f'a rank loaded {bad}')
    H.log(r0['log'])
    for r, res in enumerate(results):
        t = res['trace']
        if t:
            H.log(f'rank {r} trace: busy {t["busy_ns"] / 1e6:.3f} of '
                  f'{t["window_ns"] / 1e6:.3f} ms, NCCL '
                  f'{t["nccl_ns"] / 1e6:.3f} ms, H2D {t["h2d_ns"] / 1e6:.3f} '
                  f'ms over {t["steps"]} steps')
    out = {'e2e': r0['e2e'], 'attempted': r0['attempted'], 'failed': 0,
           'memory_peak_bytes': max(r['memory_peak_bytes'] for r in results)}
    out['record'] = train_record(cell, r0['win'],
                                 [r['trace'] for r in results if r['trace']],
                                 r0['eval_batches'])
    r0['prog']['m'] = torch.load(moments_path(files[0][0]),
                                 map_location=ctx.device)
    splits = H.make_splits(cell, ctx.seed, ctx.device)
    ref = C.train_reference(cell, ctx.seed, splits, ctx.device,
                            r0['prog']['first'], r0['prog']['steps'])
    out['checks'] = C.train_checks(r0['prog'], ref)
    return out


def moments_path(rank_out: str) -> str:
    """Where a rank's Adam moments go, beside its JSON record."""
    return rank_out + '.m.pt'


def rank_main(args, cell) -> None:
    """One rank: join, warm up, the window, the trace, the readout; then
    leave the group and write the readings to ``args.rank_out``."""
    from gltvae_torch.parallel import mesh as pmesh
    pmesh.initialize_multihost(f'tcp://localhost:{args.port}', args.world,
                               args.rank, device=args.device)
    mesh = pmesh.create_mesh(args.device)
    tmp = os.path.dirname(args.rank_out)
    try:
        s = TrainSession(cell, args.seed, mesh.device, tmp, mesh)
        s.warm_up()
        setup_s = time.time() - args.t0
        win = s.window(args.seconds)
        cuda = mesh.device.type == 'cuda'
        rec = {'e2e': {'setup_s': setup_s,
                       'train_img_per_s': win['images'] / win['window_s'],
                       'step_ms_p95': H.p95(win['intervals_ms'])},
               'attempted': win['dispatches'],
               'log': (f'window: {win["epochs"]} epochs, '
                       f'{win["dispatches"]} dispatches, {win["images"]} '
                       f'global images in {win["window_s"]:.3f} s on rank 0; '
                       f'step_ms_p95 over {len(win["intervals_ms"])} '
                       f'intervals'),
               'win': {k: v for k, v in win.items()
                       if k not in ('intervals_ms',)},
               'trace': None}
        if args.trace:
            tr = cell.traffic['trace']
            rec['trace'] = s.trace(tr['skip'], tr.get('count'))
        rec['memory_peak_bytes'] = (torch.cuda.max_memory_allocated(
            mesh.device) if cuda else 0)
        rec['eval_batches'] = s.eval_batches()
        rec['prog'] = s.program_readout()
        m = rec['prog'].pop('m')
        if args.rank == 0:
            torch.save({n: v.cpu() for n, v in m.items()},
                       moments_path(args.rank_out))
        s.close()
    finally:
        pmesh.shutdown()
    rec['forbidden'] = H.forbidden_modules()
    with open(args.rank_out, 'w') as f:
        json.dump(rec, f)
