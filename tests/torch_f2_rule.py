"""Fault F2's rule (fixed/one-one sup=1.0, relu locs, 12 epochs, the
2,100-image parity corpus, bs 64), judged from the committed records.

    python -m tests.torch_f2_rule [--json out.json]
    python -m tests.torch_f2_rule --fresh [--json out.json]

- A: the port's card seeds 0-19
  (``docs/artifacts/posterior_locs_seed_panel_torch.json`` for 0-4,
  ``one_one_seed_panel_torch.json`` for 5-19);
- B: gltvae's seeds 0-19, each trained by gltvae (its TPU legs 0-4 in
  ``posterior_locs_seed_panel.json``, its CPU legs 5-19 in
  ``one_one_seed_panel_gltvae_cpu.json``);
- C: the port's training from gltvae's initial parameters, seeds 0-19 (the
  ``gltvae_init`` column of ``one_one_init_report_cpu.json``).

R1: Welch's t of mean(A) - mean(B) under 2.0 in size, and both means
within 0.06 of the reference's five-seed mean 0.648. R2: in
``one_one_init_census_cpu.json`` each census statistic's KS p at least
0.01/3 and each tensor's at least 0.001/(number of tensors). R3: d = C - B,
|mean(d)| under 2·sd(d)/sqrt(20) and under 0.03. Standard deviations are
sample ones (n - 1). F2 closes as seed variance only if all three hold.

``--fresh`` judges R1' instead, the same statistic over fresh seeds
40-69, 30 a side: A2 the port's card runs
(``one_one_seed_panel_torch_fresh.json``, ``python -m
gltvae_torch.seed_panel --seeds 40 ... 69 --locs relu``), B2 gltvae's CPU
runs (``one_one_seed_panel_gltvae_cpu_fresh.json``, ``python
tools/seed_panel.py --platform cpu --seeds 40 ... 69 --locs relu``). F2
closes as seed variance if R1' holds, and stays open as a gap of the whole
pipeline, confirmed on fresh seeds, if it fails.

Beside the rule, ``one_one_twin_cpu.json`` (``tests/torch_f2_twin.py
--legs twin``: the port's training from gltvae's init with gltvae's draws
injected) splits d into twin - B (the two frameworks' arithmetic alone)
and C - twin (the port's draws against gltvae's, one machinery).
"""

import argparse
import json
import math
import os

import numpy as np

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'docs', 'artifacts')
REFERENCE_MEAN = 0.648
SEEDS = range(20)
FRESH_SEEDS = range(40, 70)


def _panel(name, seeds):
    with open(os.path.join(ART, name)) as f:
        d = json.load(f)
    return [d[f'locs=relu/seed={s}']['test_accuracy'] for s in seeds]


def records():
    a = (_panel('posterior_locs_seed_panel_torch.json', range(5))
         + _panel('one_one_seed_panel_torch.json', range(5, 20)))
    b = (_panel('posterior_locs_seed_panel.json', range(5))
         + _panel('one_one_seed_panel_gltvae_cpu.json', range(5, 20)))
    with open(os.path.join(ART, 'one_one_init_report_cpu.json')) as f:
        report = json.load(f)
    c = [report[str(s)]['gltvae_init'] for s in SEEDS]
    return np.asarray(a), np.asarray(b), np.asarray(c)


def fresh_records():
    """(A2, B2): the port's card runs and gltvae's CPU runs at seeds
    40-69."""
    return (np.asarray(_panel('one_one_seed_panel_torch_fresh.json',
                              FRESH_SEEDS)),
            np.asarray(_panel('one_one_seed_panel_gltvae_cpu_fresh.json',
                              FRESH_SEEDS)))


def fresh_verdict(r):
    """F2's verdict from R1' alone."""
    return ('closed as seed variance (R1\' holds)' if r['holds'] else
            'open: R1\' failed, a gap of the whole pipeline confirmed on '
            'fresh seeds')


def r1_line(name, x, n):
    return (f"{name}: mean({'A2' if n == 30 else 'A'}) {x['mean_a']:.4f} "
            f"(sd {x['sd_a']:.4f}), mean({'B2' if n == 30 else 'B'}) "
            f"{x['mean_b']:.4f} (sd {x['sd_b']:.4f}); Welch t "
            f"{x['welch_t']:.3f} (|t| < 2.0); "
            f"{'A2' if n == 30 else 'A'} {x['a_off_reference']:+.4f} and "
            f"{'B2' if n == 30 else 'B'} {x['b_off_reference']:+.4f} off "
            f"0.648 (within 0.06): {'holds' if x['holds'] else 'FAILS'}")


def r1(a, b):
    se = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    t = (a.mean() - b.mean()) / se
    return {'mean_a': a.mean(), 'sd_a': a.std(ddof=1), 'mean_b': b.mean(),
            'sd_b': b.std(ddof=1), 'welch_t': t, 't_limit': 2.0,
            'a_off_reference': a.mean() - REFERENCE_MEAN,
            'b_off_reference': b.mean() - REFERENCE_MEAN,
            'reference_tol': 0.06,
            'holds': bool(abs(t) < 2.0
                          and abs(a.mean() - REFERENCE_MEAN) <= 0.06
                          and abs(b.mean() - REFERENCE_MEAN) <= 0.06)}


def r2(census):
    stats_ok = {k: v['ks_p'] >= census['statistic_threshold']
                for k, v in census['statistics'].items()}
    worst = min(census['tensors'].items(), key=lambda kv: kv[1]['ks_p'])
    return {'statistics': {k: {'ks_d': v['ks_d'], 'ks_p': v['ks_p']}
                           for k, v in census['statistics'].items()},
            'statistic_threshold': census['statistic_threshold'],
            'tensors': len(census['tensors']),
            'tensor_threshold': census['tensor_threshold'],
            'lowest_tensor': worst[0], 'lowest_tensor_p': worst[1]['ks_p'],
            'seeds': census['seeds'],
            'holds': bool(all(stats_ok.values()) and worst[1]['ks_p']
                          >= census['tensor_threshold'])}


def r3(b, c):
    d = c - b
    se2 = 2 * d.std(ddof=1) / math.sqrt(len(d))
    return {'d': d.tolist(), 'mean_d': d.mean(), 'sd_d': d.std(ddof=1),
            'two_se': se2, 'abs_limit': 0.03,
            'negative': int((d < 0).sum()),
            'holds': bool(abs(d.mean()) < se2 and abs(d.mean()) < 0.03)}


def split_d(b, c):
    """d = C - B as (twin - B) + (C - twin), each with its mean, sample sd
    and 2·sd/sqrt(n)."""
    with open(os.path.join(ART, 'one_one_twin_cpu.json')) as f:
        twin = json.load(f)
    t = np.asarray([twin[str(s)]['twin']['test_accuracy'] for s in SEEDS])
    out = {'twin': t.tolist()}
    for name, x in (('twin_minus_b', t - b), ('c_minus_twin', c - t)):
        out[name] = {'mean': x.mean(), 'sd': x.std(ddof=1),
                     'two_se': 2 * x.std(ddof=1) / math.sqrt(len(x)),
                     'negative': int((x < 0).sum())}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--json', default=None)
    p.add_argument('--fresh', action='store_true',
                   help="R1' over the fresh seeds 40-69 instead")
    args = p.parse_args(argv)
    if args.fresh:
        a2, b2 = fresh_records()
        out = {'R1_fresh': r1(a2, b2), 'seeds': list(FRESH_SEEDS),
               'a2': a2.tolist(), 'b2': b2.tolist()}
        print(r1_line("R1'", out['R1_fresh'], len(a2)))
        out['verdict'] = fresh_verdict(out['R1_fresh'])
        print(f"F2: {out['verdict']}")
    else:
        out = judge()
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(out, f, indent=2, default=float)
    return out


def judge():
    """R1-R3 and the verdict from the committed records, printed."""
    a, b, c = records()
    with open(os.path.join(ART, 'one_one_init_census_cpu.json')) as f:
        census = json.load(f)
    out = {'R1': r1(a, b), 'R2': r2(census), 'R3': r3(b, c)}
    print(r1_line('R1', out['R1'], len(a)))
    x = out['R2']
    print('R2: ' + ', '.join(f'{k} KS p {v["ks_p"]:.4g}' for k, v in
                             x['statistics'].items())
          + f" (>= {x['statistic_threshold']:.4g}); lowest tensor "
          f"{x['lowest_tensor']} p {x['lowest_tensor_p']:.4g} (>= "
          f"{x['tensor_threshold']:.4g} over {x['tensors']} tensors): "
          f"{'holds' if x['holds'] else 'FAILS'}")
    x = out['R3']
    print(f"R3: mean(d) {x['mean_d']:+.4f}, sd(d) {x['sd_d']:.4f}, "
          f"2·sd/sqrt(20) {x['two_se']:.4f}, {x['negative']} of 20 "
          f"negative; |mean(d)| < {x['two_se']:.4f} and < 0.03: "
          f"{'holds' if x['holds'] else 'FAILS'}")
    verdict = ('closed as seed variance' if all(v['holds'] for v in
                                                 out.values())
               else 'open: ' + ', '.join(k for k, v in out.items()
                                         if not v['holds']) + ' failed')
    out['verdict'] = verdict
    print(f'F2: {verdict}')
    out['split_d'] = split_d(b, c)
    for name in ('twin_minus_b', 'c_minus_twin'):
        x = out['split_d'][name]
        print(f"{name.replace('_', ' ')}: mean {x['mean']:+.4f}, sd "
              f"{x['sd']:.4f}, 2·sd/sqrt(20) {x['two_se']:.4f}, "
              f"{x['negative']} of 20 negative")
    return out


if __name__ == '__main__':
    main()
