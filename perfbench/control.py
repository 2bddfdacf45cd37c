"""The readings a cell's limits are set from, beside the program's own:
the control (the reference put in the program's place, computed in the
next precision below the configuration's) and the faults the comparison
must catch, planted in the reference put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--device cuda] [--passes 400]

Prints one JSON line a seed and reading: the cell, the seed, what stood
in the program's place, the verdict that the harness's own comparison
(``checks.judge``) gives it under the cell's limits, and the numbers
compared with their limits. A test cell's control and fault read a
sample of ``--passes`` passes, as a window of that many would.

``controls/<cell>.jsonl`` keeps these lines as read on the chip at the
cell's own size; a test feeds them through the comparison again.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

#: the precision a control computes in, by the configuration's
CONTROL = {'float32': 'tf32', 'bfloat16': 'fp8'}


def train_faults(cell) -> list:
    """The faults a train cell can have; the exchange only across chips."""
    return ['state_unchanged', 'half_batch'] + (
        ['no_exchange'] if cell.chips > 1 else [])


def readings(name: str, seed: int, device: str = 'cuda', sizes=None,
             passes: int = 400) -> list:
    """[(stand-in, checks)] for cell `name` on `seed`: the control and
    each fault against the f32 reference."""
    import harness as H
    import checks as C
    cell = H.load_cell(name, sizes)
    splits = H.make_splits(cell, seed, device)
    low = CONTROL[cell.model['compute_dtype']]
    out = []
    if cell.workload['driver'] == 'test_passes':
        picks = C.sample_passes(passes, seed, cell.traffic['check_passes'])
        ref = C.test_reference(cell, seed, splits, device, picks)
        ctl = C.test_reference(cell, seed, splits, device, picks, low)
        out.append((f'control {low}', C.test_checks(ctl, ref)))
        bad = C.test_reference(cell, seed, splits, device, picks,
                               fault='answer_altered')
        out.append(('fault answer_altered', C.test_checks(bad, ref)))
        return out
    steps = 3
    ref = C.train_reference(cell, seed, splits, device, 1, steps)
    ctl = C.train_reference(cell, seed, splits, device, 1, steps, low)
    out.append((f'control {low}', C.train_checks(ctl, ref)))
    for fault in train_faults(cell):
        bad = C.train_reference(cell, seed, splits, device, 1, steps,
                                fault=fault)
        out.append((f'fault {fault}', C.train_checks(bad, ref)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    p.add_argument('--passes', type=int, default=400)
    args = p.parse_args(argv)
    import harness as H
    from checks import judge
    limits = H.load_cell(args.workload).workload['limits']
    for seed in args.seeds:
        t = time.perf_counter()
        for who, chk in readings(args.workload, seed, args.device,
                                 passes=args.passes):
            correct = judge(chk, limits)[0]
            print(json.dumps({
                'cell': args.workload, 'seed': seed, 'in_place': who,
                'correct': correct,
                'checks': {k: {'value': v, 'at': d,
                               'limit': limits.get(k)}
                           for k, (v, d) in chk.items()},
                'seconds': round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
