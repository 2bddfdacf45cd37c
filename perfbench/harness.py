"""What every cell shares: its files, its inputs made from the seed, the
program built as its command line builds it, the per-dispatch meter, the
trace's reduction and the result line.

A cell is ``workloads/<name>.json`` (its configuration, chips, driver and
traffic) over ``configs/<config>.json`` (the model and its training
settings); the traffic's ``train`` block overrides the configuration's.
The driver ``drivers/<driver>.py`` runs it; each per-layer metric is read
by ``metrics/<metric>.py`` from the run's record.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: top-level modules that may not be loaded in a run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'gltvae')


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict

    @property
    def model(self) -> dict:
        return self.config['model']

    @property
    def train(self) -> dict:
        t = dict(self.config['train'])
        t.update(self.workload['traffic'].get('train', {}))
        return t

    @property
    def traffic(self) -> dict:
        return self.workload['traffic']

    @property
    def chips(self) -> int:
        return self.workload['chips']


def load_cell(name: str, sizes: Optional[dict] = None) -> Cell:
    """The cell `name`; `sizes` replaces values of a CPU rehearsal: the
    model's (its compute dtype), the batch and supervision, or the
    traffic's (split sizes, trace segment)."""
    w = _json(os.path.join(BENCH, 'workloads', f'{name}.json'))
    c = _json(os.path.join(BENCH, 'configs', f'{w["config"]}.json'))
    for k, v in (sizes or {}).items():
        if k in c['model']:
            c['model'][k] = v
        elif k in ('batch_size', 'perc_supervision'):
            w['traffic'].setdefault('train', {})[k] = v
        else:
            w['traffic'][k] = v
    return Cell(name, w, c)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, 'BENCHMARK.json'))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split('.')[0] for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------ inputs ------------------------------
def make_splits(cell: Cell, seed: int, device) -> Dict[str, tuple]:
    """{'sup', 'unsup', 'valid', 'test'}: (uint8 images [N, S, S, C],
    float32 labels [N, y]) on the host, made on `device` from `seed`:
    uniform pixels, and labels that follow four hidden binary factors
    (each label on with p 0.8 when its factor is on, else 0.15; no row
    without a label), so the gating init has structure. The sup split is
    the first ⌊sup·n_train⌋ train rows."""
    t, m = cell.traffic, cell.model
    n_train, n_valid, n_test = t['n_train'], t['n_valid'], t['n_test']
    n = n_train + n_valid + n_test
    s, c, y = m['image_size'], m['channels'], m['y_dim']
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    images = np.empty((n, s, s, c), np.uint8)
    chunk = max(1, (1 << 30) // (s * s * c))
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        part = torch.randint(0, 256, (b - a, s, s, c), generator=g,
                             device=device, dtype=torch.uint8)
        torch.from_numpy(images[a:b]).copy_(part)
    factors = torch.rand((n, 4), generator=g, device=device) > 0.5
    assign = torch.randint(0, 4, (y,), generator=g, device=device)
    probs = torch.where(factors[:, assign], 0.8, 0.15)
    lab = (torch.rand((n, y), generator=g, device=device) < probs).float()
    pick = torch.randint(0, y, (n,), generator=g, device=device)
    empty = lab.sum(1) == 0
    lab[empty, pick[empty]] = 1.0
    labels = lab.cpu().numpy()
    k = int(n_train * cell.train['perc_supervision'])
    e = n_train + n_valid
    return {'sup': (images[:k], labels[:k]),
            'unsup': (images[k:n_train], labels[k:n_train]),
            'valid': (images[n_train:e], labels[n_train:e]),
            'test': (images[e:], labels[e:])}


def reset_peak(device) -> None:
    """Start the device's memory peak after the inputs are made, so that
    it is the program's."""
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)


def _limit(shape) -> float:
    """Glorot-uniform's limit for a kernel, 0.01 for a bias."""
    if len(shape) == 4:
        return math.sqrt(6.0 / (shape[0] * 16 + shape[1] * 16))
    if len(shape) == 2:
        return math.sqrt(6.0 / (shape[0] + shape[1]))
    return 0.01


def make_weights(cell: Cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter but μ, float32 on `device`, from `seed` in one draw:
    kernels glorot-uniform, biases U(±0.01), the classifier's weights
    U(±0.0866) (std 0.05), the conditional prior's locations U(±0.1) and
    scales 1 + U(±0.1)."""
    from reference.ccvae import param_shapes
    shapes = {n: s for n, s in param_shapes(cell.model).items() if n != 'mu'}
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(seed + 7)
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for n, s in shapes.items():
        w = flat[at:at + math.prod(s)].view(s)
        at += math.prod(s)
        if n.startswith('classifier'):
            w = w * 0.0866
        elif n.startswith('cond_prior.scale'):
            w = 1.0 + 0.1 * w
        elif n.startswith('cond_prior'):
            w = 0.1 * w
        else:
            w = w * _limit(s)
        out[n] = w.contiguous()
    return out


# ------------------------------ program ------------------------------
def model_config(cell: Cell):
    from gltvae_torch.config import ModelConfig
    m = dict(cell.model)
    for k in ('enc_features', 'dec_features'):
        m[k] = tuple(m[k])
    return ModelConfig(**m)


def train_config(cell: Cell, seed: int):
    from gltvae_torch.config import TrainConfig
    t = cell.train
    keys = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(seed=seed, **{k: v for k, v in t.items()
                                     if k in keys})


def build_program(cell: Cell, splits: dict, seed: int, device, tmp: str,
                  mesh=None):
    """(trainer, loaders): the program as its command line builds it from
    in-memory splits (``cli.make_loaders``' synthetic path and
    ``cli.run``'s Trainer, with no checkpoint directory), its weights
    then loaded from `seed` through ``Trainer.load_params``."""
    from gltvae_torch.data.pipeline import ArrayDataset, BatchLoader
    from gltvae_torch.ops.gating import gating_matrix_from_labels
    from gltvae_torch.train.loop import Trainer
    mcfg, tcfg = model_config(cell), train_config(cell, seed)
    shard = (mesh.rank, mesh.world) if mesh is not None and mesh.world > 1 \
        else None
    loaders = {k: BatchLoader(ArrayDataset(*v), tcfg.batch_size, seed=seed,
                              reshuffle_each_epoch=True, shard=shard)
               for k, v in splits.items() if len(v[0])}
    mu = gating_matrix_from_labels(
        splits['sup'][1] if 'sup' in loaders else None, splits['valid'][1],
        mcfg.y_dim, tcfg.perc_supervision)
    trainer = Trainer(mcfg, tcfg, mu_init=mu, checkpoint_dir=None,
                      metrics_path=os.path.join(tmp, 'metrics.csv'),
                      steps_per_dispatch=cell.train.get('steps_per_dispatch',
                                                        1),
                      device=None if mesh is not None else device,
                      mesh=mesh, local_batches=shard is not None)
    w = make_weights(cell, seed, trainer.device)
    w['mu'] = trainer.model.mu.detach().clone()
    trainer.load_params(w)
    return trainer, loaders


def free_program() -> None:
    """Collect what the caller dropped and give its device memory back."""
    import gc
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def meter_class():
    """The Trainer's images/s meter with a hook at each dispatch: a CUDA
    event recorded on the current stream after it (while ``events`` is a
    list), then the callbacks in ``hooks``."""
    from gltvae_torch.train.metrics import Throughput

    class Meter(Throughput):
        def __init__(self, cuda: bool):
            super().__init__()
            self.cuda = cuda
            self.dispatches = 0
            self.images = 0
            self.events: Optional[list] = None
            #: called after each dispatch with the meter
            self.hooks: List[Callable] = []

        def step(self, batch_images: int):
            super().step(batch_images)
            self.dispatches += 1
            self.images += batch_images
            if self.events is not None:
                self.events.append(stamp(self.cuda))
            for hook in list(self.hooks):
                hook(self)
    return Meter


def stamp(cuda: bool):
    """A point on the device's timeline (a recorded CUDA event), or the
    host clock on the CPU."""
    if cuda:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return time.perf_counter()


def intervals_ms(stamps: list, cuda: bool) -> List[float]:
    """Milliseconds between consecutive stamps."""
    if cuda:
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


# ------------------------------- trace -------------------------------
def profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
                'cuLaunchKernelEx', 'cudaGraphLaunch', 'cudaMemcpyAsync',
                'cudaMemcpy', 'cudaMemsetAsync', 'cudaMemset',
                'cudaLaunchCooperativeKernel')


def _merge(iv):
    iv.sort()
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(prof, t0_ns: int, t1_ns: int) -> dict:
    """What the metrics read from one rank's trace of the window [t0, t1]
    (the profiler's clock): device busy time (any kernel, copy or set on
    any stream), host-to-device copy time, NCCL kernel time, the dequant
    kernels' times, host launches (CUDA runtime calls that enqueue work),
    the device ops that took most time, and the idle gaps by the host op
    in flight."""
    cuda_t = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns(), e.duration_ns()
        if a + d < t0_ns or a > t1_ns:
            continue
        (dev if e.device_type() == cuda_t else cpu).append(
            (e.name(), a, a + d))
    busy = _merge([[max(a, t0_ns), min(b, t1_ns)] for _, a, b in dev])
    by_name: Dict[str, float] = {}
    h2d = nccl = 0
    dequant = []
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0) + (b - a)
        if n.startswith('Memcpy HtoD'):
            h2d += b - a
        if 'nccl' in n.lower():
            nccl += b - a
        if 'dequant_kernel' in n:
            dequant.append(b - a)
    launches = sum(1 for n, _, _ in cpu if n in LAUNCH_CALLS)
    gaps, at = [], t0_ns
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1_ns:
        gaps.append((at, t1_ns))
    by_gap: Dict[str, float] = {}
    host = sorted((a, b, n) for n, a, b in cpu
                  if not n.startswith('ProfilerStep'))
    active, i = [], 0
    for a, b in gaps:           # in time order: a sweep over host ops
        mid = (a + b) // 2
        if b - a < 20_000:
            key = 'gaps under 20 us'
        else:
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            key = (min(active, key=lambda h: h[1] - h[0])[2] if active
                   else 'no traced host op')
        by_gap[key] = by_gap.get(key, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {'window_ns': t1_ns - t0_ns,
            'busy_ns': sum(b - a for a, b in busy),
            'h2d_ns': h2d, 'nccl_ns': nccl, 'dequant_ns': dequant,
            'launches': launches,
            'device_ops': [[n[:120], v / 1e9] for n, v in top],
            'idle_gaps': [[n[:120], v / 1e9] for n, v in
                          sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]]}


def traced(cuda: bool, run: Callable[[], None]):
    """Run `run` under the profiler, synchronized at both ends; returns
    the profile and the window's ends on the profiler's clock (Unix
    nanoseconds)."""
    sync(cuda)
    prof = profiler(cuda)
    prof.start()
    sync(cuda)
    t0 = time.time_ns()
    run()
    sync(cuda)
    t1 = time.time_ns()
    prof.stop()
    return prof, t0, t1


# ------------------------------- judge -------------------------------
def leaf_norms(d: Dict[str, torch.Tensor], scale: float = 1.0) -> dict:
    return {n: float(v.double().norm()) * scale for n, v in d.items()}


# ------------------------------- output -------------------------------
def device_info(chips: int, cuda: bool) -> dict:
    if not cuda:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips, 'memory_peak_bytes': 0,
            'power_limit': power_limit()}


def power_limit() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ''
    except (OSError, subprocess.SubprocessError, IndexError):
        return ''


def per_layer_names(cell_name: str, e2e: List[str]) -> List[str]:
    """The per-layer metrics this cell reports: those that list it, or,
    with no list, those whose end-to-end metric it reports."""
    out = []
    for m in benchmark()['per_layer']:
        cells = m.get('workloads')
        if (cell_name in cells) if cells else (m['moves'] in e2e):
            out.append(m['name'])
    return out


def e2e_specs(cell_name: str) -> List[dict]:
    return [m for m in benchmark()['end_to_end']
            if cell_name in m.get('workloads', [cell_name])]


def read_per_layer(cell_name: str, e2e: List[str], rec: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    units = {m['name']: m['unit'] for m in benchmark()['per_layer']}
    out = {}
    for name in per_layer_names(cell_name, e2e):
        mod = load_module(os.path.join(BENCH, 'metrics', f'{name}.py'),
                          'perfbench_metric_' + name.replace('.', '_'))
        v = mod.read(rec)
        if v is None:
            log(f'{name}: nothing to read in this run')
            continue
        out[name] = {'value': v, 'unit': units[name]}
    return out
