"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``perfbench/workloads/<cell>.json`` over its configuration in
``perfbench/configs/``. The run makes its data and weights on the chip
from the seed, builds ``gltvae_torch``'s Trainer, warms it up (its first
epoch, whose first steps the plain reference in ``perfbench/reference``
follows), measures whole epochs or passes for ``--seconds`` seconds, and
with ``--trace 1`` traces a further segment for the per-layer metrics.
It prints the comparison's other numbers, then each compared number
beside its limit, as its last lines on standard error and, as the last
line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end ones,
or with ``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

It exits non-zero and prints no result where there is no CUDA device or
fewer than the cell asks for, or where a module of JAX or of the JAX
package was loaded.
"""

import time

T0 = time.perf_counter()
T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # a mesh rank, started by its cell's own command
    p.add_argument('--rank', type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument('--world', type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument('--port', type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument('--t0', type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument('--rank-out', default=None, help=argparse.SUPPRESS)
    p.add_argument('--device', default='cuda', help=argparse.SUPPRESS)
    p.add_argument('--sizes', default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Context:
    """What a driver gets: the cell, the run's arguments, its device, its
    clock and a scratch directory under TMPDIR."""

    def __init__(self, cell, seed, seconds, trace, device, sizes=None):
        import torch
        # numpy's seeded streams, the program's loaders among them, take
        # 32 bits
        self.cell, self.seed, self.seconds = cell, seed % 2 ** 32, seconds
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.sizes = sizes
        self.t0, self.t0_wall = T0, T0_WALL
        self.clock = time.perf_counter
        self.tmp = tempfile.mkdtemp(prefix='perfbench-')

    def memory_peak(self) -> int:
        import torch
        return torch.cuda.max_memory_allocated() if self.cuda else 0


def execute(name, seed, seconds, trace, device='cuda', sizes=None) -> dict:
    """Run cell `name` once on `device`; the result line's object, or
    raise. On the CPU (a rehearsal at small `sizes`) the metrics are left
    out: no device number comes from it."""
    import harness as H
    from checks import judge
    cell = H.load_cell(name, sizes)
    ctx = Context(cell, seed, seconds, trace, device, sizes)
    driver = H.load_module(
        os.path.join(BENCH, 'drivers', f'{cell.workload["driver"]}.py'),
        f'drivers.{cell.workload["driver"]}')
    try:
        out = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    e2e_units = {m['name']: m['unit'] for m in H.e2e_specs(name)}
    rec = out['record']
    traces = rec.get('traces') or []
    if trace:
        rec['complete'] = trace_complete(rec)
        if not rec['complete']:
            H.log(f'trace: {[len(t["dequant_ns"]) for t in traces]} dequant '
                  f'kernels traced of {want_dequant(rec)}: the profiler '
                  f'missed kernels of the captured graphs; the metrics read '
                  f'from the device trace are left out of this run')
        metrics = H.read_per_layer(name, list(e2e_units), rec)
    else:
        metrics = {n: {'value': out['e2e'][n], 'unit': u}
                   for n, u in e2e_units.items()}
    for n, (value, detail) in out['checks'].items():
        if n not in cell.workload['limits']:
            H.log(f'reading {n}: {value:.6g} (no limit) [{detail}]')
    correct, table, lines = judge(out['checks'], cell.workload['limits'])
    dev = H.device_info(cell.chips, ctx.cuda)
    dev['memory_peak_bytes'] = int(out['memory_peak_bytes'])
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if trace and traces:
        dev['busy_s'] = sum(t['busy_ns'] for t in traces) / len(traces) / 1e9
        dev['window_s'] = sum(t['window_ns'] for t in traces) / len(
            traces) / 1e9
        result['breakdown'] = {'device_ops': traces[0]['device_ops'],
                               'idle_gaps': traces[0]['idle_gaps']}
    if not ctx.cuda:
        result['metrics'] = {}
        result['rehearsal'] = {'e2e': out['e2e'], 'per_layer': metrics}
    result['checks'] = table
    result['_lines'] = lines
    return result


def want_dequant(rec: dict) -> list:
    """The dequant launches each trace's segment made: one a train step
    and one an eval batch."""
    if rec['kind'] == 'train':
        return [t['steps'] + (rec['eval_batches'] if t['validation'] else 0)
                for t in rec['traces']]
    return [t['batches'] for t in rec['traces']]


def trace_complete(rec: dict) -> bool:
    """Whether every trace holds every dequant launch its segment made
    (the profiler can miss kernels of captured graphs in some
    windows)."""
    return all(len(t['dequant_ns']) == w
               for t, w in zip(rec['traces'], want_dequant(rec)))


def main(argv=None) -> int:
    args = parse(argv)
    import harness as H
    sizes = json.loads(args.sizes) if args.sizes else None
    if args.rank is not None:
        from drivers.mesh_train_epochs import rank_main
        rank_main(args, H.load_cell(args.workload, sizes))
        return 0
    import torch
    cell = H.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        H.log(f'{args.workload} needs {cell.chips} CUDA device(s); this '
              f'machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    result = execute(args.workload, args.seed, args.seconds, args.trace)
    bad = H.forbidden_modules()
    if bad:
        H.log(f'loaded in this process: {", ".join(bad)}')
        return 3
    for line in result.pop('_lines'):
        H.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
