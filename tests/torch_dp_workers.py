"""Ranks of the port's data-parallel tests (tests/test_torch_dp*.py).

Torch only, so the spawned interpreters never import JAX. ``launch``
spawns `world` gloo ranks on the CPU, each running one scenario of
``SCENARIOS`` on its rank of the mesh and saving what it returns to
``<out>/<scenario>_rank<r>.pt``; each scenario also runs in the test's own
process with ``mesh=None`` (plain one-device steps, no group), which is
the reference the ranks are held to."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import gltvae_torch.config as tcfg

SMALL = dict(image_size=16, z_dim=8, y_dim=4, enc_features=(8, 8),
             enc_hidden=16, dec_features=(16, 8))
B, K, LR = 16, 4, 1e-3
#: the mixed chunk of the step scenarios
MASK = [True, False, False, True]


def configs(**train):
    """The tiny model of tests/test_shardmap.py and its TrainConfig."""
    return (tcfg.ModelConfig(**SMALL),
            tcfg.TrainConfig(batch_size=B, lr=LR, classifier_mc_samples=K,
                             **train))


def launch(scenario: str, world: int, tmp, timeout_s: float = 120.0,
           join: bool = True, **kw) -> list:
    """Run `scenario` on `world` gloo ranks (a file:// store under `tmp`);
    returns each rank's result, in rank order. Each rank runs torch on this
    process's thread count: the CPU kernels' sums follow it, so only then
    does a rank repeat this process's arithmetic bit for bit. With
    ``join=False`` the ranks join no group: the scenario gets ``mesh=None``
    and its rank's (rank, world, store) as ``where=`` and joins by
    itself."""
    from gltvae_torch.parallel.mesh import spawn
    out = os.path.join(str(tmp), f'{scenario}_{world}')
    os.makedirs(out, exist_ok=True)
    spawn(_rank, world, (os.path.join(out, 'store'), out, scenario, join,
                         torch.get_num_threads(), kw), timeout_s)
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
            for r in range(world)]


def _rank(rank: int, world: int, store: str, out: str, scenario: str,
          join: bool, threads: int, kw: dict) -> None:
    from gltvae_torch.parallel import mesh as pmesh
    torch.set_num_threads(threads)
    try:
        if join:
            pmesh.initialize_multihost(f'file://{store}', world, rank,
                                       device='cpu')
            mesh = pmesh.create_mesh('cpu')
            assert (mesh.rank, mesh.world, mesh.backend) == (rank, world,
                                                             'gloo')
            result = SCENARIOS[scenario](mesh, **kw)
        else:
            result = SCENARIOS[scenario](None, where=(rank, world, store),
                                         **kw)
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
    finally:
        pmesh.shutdown()


def _state(state) -> dict:
    return {k: v for k, v in state.state_dict().items()}


def _rows(mesh, a):
    return a if mesh is None else a[mesh.rows(len(a))]


def steps(mesh, params: dict, batches: list, kinds: list,
          chunk_mask: list, noise: Optional[list] = None,
          train: Optional[dict] = None, jit: Optional[bool] = None) -> dict:
    """One step of each of `kinds` (True: sup) on `batches` (global (x, y)
    numpy pairs) from `params`, then one mixed chunk over the next
    len(chunk_mask) batches; each step's noise drawn from the state's
    generator, or the global draws `noise` (one dict a step) injected;
    the makers' `jit`. Returns each step's metrics, the final state and
    whether the steps were captured ones."""
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train import steps as tsteps
    from gltvae_torch.train.state import create_train_state
    model_cfg, train_cfg = configs(**(train or {}))
    model = CCVAE(model_cfg, mu_init=params['mu'].numpy())
    model.load_state_dict(params)
    state = create_train_state(model, train_cfg)
    dp = None
    if mesh is not None:
        shard_state(state, mesh)
        dp = DataParallel(mesh)
    draw = tsteps.draw_noise
    if noise is not None:
        draws = iter(noise)
        tsteps.draw_noise = lambda *a, **k: {
            n: torch.as_tensor(v) for n, v in next(draws).items()}
    try:
        sup, unsup = tsteps.make_train_steps(model, train_cfg, dp, jit)
        chunk = tsteps.make_mixed_scan_train_step(model, train_cfg, dp, jit)
        mets = []
        for (x, y), kind in zip(batches, kinds):
            state, m = (sup if kind else unsup)(
                state, torch.from_numpy(_rows(mesh, x)),
                torch.from_numpy(_rows(mesh, y)), 1.0)
            mets.append({k: v.clone() for k, v in m.items()})
        rest = batches[len(kinds):len(kinds) + len(chunk_mask)]
        if rest:
            xs = np.stack([_rows(mesh, x) for x, _ in rest])
            ys = np.stack([_rows(mesh, y) for _, y in rest])
            state, m = chunk(state, torch.from_numpy(xs),
                             torch.from_numpy(ys), chunk_mask, 1.0)
            mets.append(m)
    finally:
        tsteps.draw_noise = draw
    return {'metrics': mets, 'state': _state(state),
            'jit_steps': isinstance(sup, tsteps.JitStep)}


def shardmap(mesh, params: dict, batch) -> dict:
    """One sup step of ``make_shardmap_train_steps`` from `params`."""
    from gltvae_torch.models.ccvae import CCVAE
    from gltvae_torch.parallel.dp import shard_state
    from gltvae_torch.parallel.shardmap import make_shardmap_train_steps
    from gltvae_torch.train.state import create_train_state
    model_cfg, train_cfg = configs()
    model = CCVAE(model_cfg, mu_init=params['mu'].numpy())
    model.load_state_dict(params)
    state = shard_state(create_train_state(model, train_cfg), mesh)
    sup, _ = make_shardmap_train_steps(model, train_cfg, mesh)
    x, y = batch
    state, m = sup(state, torch.from_numpy(_rows(mesh, x)),
                   torch.from_numpy(_rows(mesh, y)), 1.0)
    return {'metrics': m, 'state': _state(state)}


def loaders(mesh, local: bool = False, pad: int = 0, sup: float = 0.5,
            n_train: int = 64):
    """The synthetic splits' loaders at the global batch B; host-sharded
    (each rank fetches its rows) with `local`."""
    from gltvae_torch.data.pipeline import BatchLoader
    from gltvae_torch.data.synthetic import synthetic_splits
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    # 35-row eval splits: 3 wrap-around batches, and 18 resident rows a
    # rank of 2, one of them padding
    splits = synthetic_splits(n_train=n_train, n_valid=35, n_test=35,
                              sup_frac=sup, image_size=16, y_dim=4,
                              train_pad=pad)
    shard = (mesh.rank, mesh.world) if local and mesh is not None else None
    lds = {k: BatchLoader(v, B, seed=0, shard=shard)
           for k, v in splits.items()}
    return lds, cooccurrence_gating_matrix(splits['sup'].labels)


def trainer(mesh, local: bool = False, pad: int = 0, epochs: int = 2,
            run_dir: Optional[str] = None, resume: bool = False,
            **trainer_kw) -> dict:
    """Trainer.train for `epochs`, then test accuracy and test ELBO; every
    crop the augment leg makes is kept."""
    from gltvae_torch.train.loop import Trainer
    model_cfg, train_cfg = configs(perc_supervision=0.5, n_epochs=epochs,
                                   augment_pad=pad)
    lds, mu = loaders(mesh, local, pad)
    kw = dict(device='cpu', mesh=mesh, local_batches=local)
    if pad and 'jit' not in trainer_kw:
        # crops made eagerly, so that they can be kept (a captured step
        # makes them inside its graph)
        kw['jit'] = False
    if run_dir is not None:
        kw.update(checkpoint_dir=os.path.join(run_dir, 'checkpoints'),
                  metrics_path=os.path.join(run_dir, 'metrics.csv'))
    tr = Trainer(model_cfg, train_cfg, mu_init=mu, **kw, **trainer_kw)
    crops = []
    augment = tr._augment
    tr._augment = lambda u8: crops.append(augment(u8)) or crops[-1]
    res = tr.train(lds, param_dir=run_dir, log_every=1, resume=resume)
    out = {'state': _state(tr.state), 'history': res['history'],
           'rows': [{k: v for k, v in r.items() if k != 'time'}
                    for r in tr.metrics.rows],
           'test_acc': tr.test(lds['test']),
           'test_elbo': tr.test_elbo(lds['test']),
           'crops': crops, 'gating_temp': tr.gating_temp}
    out['resident'] = {k: tuple(tr._resident_data[id(ld)][1].shape)
                       for k, ld in lds.items()
                       if id(ld) in tr._resident_data}
    if mesh is not None:
        from gltvae_torch.parallel.dp import replicas_agree
        out['replicas_agree'] = replicas_agree(tr.state, mesh)
    return out


#: the Trainer runs of ``trainer_set``: the resident default, both splits
#: shipped (global batches, then host-sharded loaders), and the augmented
#: path in chunks of 2 (shipped)
TRAINER_RUNS = {
    'resident': {},
    'shipped': dict(resident_train='off', resident_eval='off'),
    'shipped_local': dict(resident_train='off', resident_eval='off',
                          local=True),
    'augmented': dict(pad=2, steps_per_dispatch=2),
}


def trainer_set(mesh, runs=tuple(TRAINER_RUNS)) -> dict:
    """``trainer`` for each of `runs` (names of TRAINER_RUNS), and
    ``evaluate``."""
    out = {name: trainer(mesh, **TRAINER_RUNS[name]) for name in runs}
    out['evaluate'] = evaluate(mesh)
    return out


def evaluate(mesh) -> dict:
    """A fresh Trainer's validation accuracy and ELBO, resident and
    shipped, and its test accuracy, each from the same initial state."""
    from gltvae_torch.train.loop import Trainer
    model_cfg, train_cfg = configs(perc_supervision=0.5)
    out = {}
    for name, kw in (('resident', {}), ('shipped', dict(resident_eval='off'))):
        lds, mu = loaders(mesh)
        tr = Trainer(model_cfg, train_cfg, mu_init=mu, device='cpu',
                     mesh=mesh, **kw)
        out[name] = (tr.evaluate(lds['valid']), tr.test_elbo(lds['valid']),
                     tr.test(lds['test']))
    return out


def debug_nans(mesh) -> dict:
    """A sup step under ``debug_nans`` with a NaN encoder weight on rank 0
    only (rank 1's rows are clean): what each rank raises."""
    from gltvae_torch.train.loop import Trainer
    model_cfg, train_cfg = configs()
    tr = Trainer(model_cfg, train_cfg, mu_init=np.full((4, 4), 0.5,
                                                       np.float32),
                 device='cpu', mesh=mesh, debug_nans=True)
    if mesh.rank == 0:
        with torch.no_grad():
            tr.model.encoder.conv1.weight[0, 0, 0, 0] = float('nan')
    r = np.random.RandomState(mesh.rank)
    x = torch.from_numpy(r.randint(0, 256, (B // mesh.world, 16, 16, 3))
                         .astype(np.uint8))
    y = torch.from_numpy((r.rand(B // mesh.world, 4) > 0.5)
                         .astype(np.float32))
    try:
        tr._sup_step(tr.state, x, y, 1.0)
    except FloatingPointError as e:     # the outcome under test
        return {'raised': str(e)}
    return {'raised': None}


def cli(mesh, where, argv: list) -> dict:
    """``gltvae_torch.cli.main`` with this rank's --dist-* flags (the
    coordinator a file:// store): the CLI joins the group itself."""
    from gltvae_torch import cli as tcli
    rank, world, store = where
    return {'result': tcli.main(argv + [
        '--dist-coordinator', f'file://{store}', '--dist-num-processes',
        str(world), '--dist-process-id', str(rank)])}


def cli_files(mesh, where, argv: list, slow_rank0: bool = False) -> dict:
    """``cli`` on this rank with its end-of-training and restored states'
    digests (``chip_smoke.state_digest``), the paths it wrote and, just
    after ``cli.main`` returns, whether the run's result.json exists. With
    `slow_rank0` rank 0 sleeps before writing result.json, so a rank that
    does not wait for it returns first."""
    import time

    import chip_smoke
    from gltvae_torch import cli as tcli
    from gltvae_torch.train.loop import Trainer
    trainers, final, written = [], {}, []

    def on_train(fn):
        def run(self, *a, **k):
            trainers.append(self)
            out = fn(self, *a, **k)
            final['digest'] = chip_smoke.state_digest(self.state)
            return out
        return run

    def slow(fn):
        def run(*a, **k):
            time.sleep(2.0)
            return fn(*a, **k)
        return run
    undo = [chip_smoke.patched(Trainer, 'train', on_train),
            chip_smoke.written_paths(written)]
    if slow_rank0 and where[0] == 0:
        undo.append(chip_smoke.patched(tcli, '_write_result_json', slow))
    try:
        result = cli(None, where, argv)['result']
    finally:
        for u in reversed(undo):
            u()
    out_dir = os.path.abspath(argv[argv.index('--output-dir') + 1])
    run_dir = os.path.join(out_dir, 'params_0.5_learnable')
    return {'result': result, 'final': final['digest'],
            'restored': chip_smoke.state_digest(trainers[-1].state),
            'written': sorted({os.path.relpath(p, out_dir) for p in written
                               if p.startswith(out_dir + os.sep)}),
            'result_json_on_return': os.path.exists(
                os.path.join(run_dir, 'result.json'))}


def fake_graphs(events: list):
    """A capture function standing in for CUDA graphs on the CPU: the
    capture records nothing (no run), each replay runs the device part
    and writes its results into the outputs, and ``reset`` appends
    ('reset', the graph's id) to `events`."""
    def capture(fn, pool, error_mode='global'):
        out = {}

        class Graph:
            def replay(self):
                out.update(fn())

            def reset(self):
                events.append(('reset', id(self)))
        return Graph(), out
    return capture


def _shapes(program) -> list:
    """A program's static inputs' names, shapes and dtypes."""
    return sorted((k, tuple(v.shape), str(v.dtype))
                  for k, v in vars(program).items()
                  if isinstance(v, torch.Tensor))


def cli_release(mesh, where, argv: list) -> dict:
    """``cli`` on this rank as chip_smoke.py's phase 39 runs it (host-
    sharded loaders past one rank, the best-checkpoint restore and the
    test pass), every program captured through ``fake_graphs`` and every
    Trainer held past ``cli.main``, as phase 39 holds them. Returns the
    programs in the order of their captures, the collectives in the order
    they were issued, the events (each graph's reset, the group's
    destroy), whether the process left its group, whether each program
    was released and what a held program raises when run again."""
    import torch.distributed as dist

    import chip_smoke
    from gltvae_torch.parallel import mesh as pmesh
    from gltvae_torch.train import graphs
    from gltvae_torch.train.loop import Trainer
    events, programs, calls, trainers, graph_ids = [], [], [], [], []

    def on_capture(fn):
        def run(self, owner):
            fn(self, owner)
            programs.append(self)
            graph_ids.append(id(self.graph))
        return run

    def issued(name):
        def wrap(fn):
            def run(t, *a, **k):
                calls.append((name, tuple(t.shape), str(t.dtype)))
                return fn(t, *a, **k)
            return run
        return wrap

    def destroyed(fn):
        def run(*a, **k):
            events.append(('destroy', len(pmesh.registered())))
            return fn(*a, **k)
        return run

    def on_train(fn):
        def run(self, *a, **k):
            trainers.append(self)
            return fn(self, *a, **k)
        return run
    undo = [chip_smoke.patched(graphs, 'graph_capture',
                               lambda f: lambda dev: fake_graphs(events)),
            chip_smoke.patched(graphs.Captured, '_capture', on_capture),
            chip_smoke.patched(dist, 'destroy_process_group', destroyed),
            chip_smoke.patched(Trainer, 'train', on_train)]
    undo += [chip_smoke.patched(dist, n, issued(n)) for n in (
        'all_reduce', 'broadcast', 'all_gather_into_tensor')]
    try:
        result = cli(None, where, argv)['result']
    finally:
        for u in reversed(undo):
            u()
    raised = []
    for p in programs:
        try:
            p(p.owner)
            raised.append(None)
        except RuntimeError as e:
            raised.append(str(e))
    tr = trainers[-1]
    return {'result': result, 'jit': tr._jit,
            'mesh': (tr.mesh.rank, tr.mesh.world, tr.mesh.backend),
            'local_batches': tr.local_batches,
            'programs': [(type(p).__name__, getattr(p, 'mask', None),
                          _shapes(p)) for p in programs],
            'collectives': calls,
            'events': [(e[0], graph_ids.index(e[1])) if e[0] == 'reset'
                       else e for e in events],
            'left': not dist.is_initialized(),
            'released': [p.released and p.graph is None for p in programs],
            'registered_after': len(pmesh.registered()),
            'raised': raised}


def infer_slow(mesh, argv: list) -> dict:
    """``infer`` with rank 0 sleeping before each batch's rows are written;
    this rank's count of CSV rows just after ``infer.main`` returns."""
    import time

    from gltvae_torch import infer as tinfer
    write = tinfer.write_rows

    def slow(*a, **k):
        time.sleep(1.0)
        return write(*a, **k)
    if mesh.rank == 0:
        tinfer.write_rows = slow
    try:
        out = tinfer.main(argv)
    finally:
        tinfer.write_rows = write
    with open(out) as f:
        return {'rows_on_return': len(f.read().splitlines())}


def resume(mesh, run_dir: str) -> dict:
    """2 epochs, then a new Trainer resumed into a 4-epoch schedule (the
    JAX package's tests/test_trainer_mesh_e2e.py resume case)."""
    first = trainer(mesh, run_dir=run_dir, epochs=2)
    second = trainer(mesh, run_dir=run_dir, epochs=4, resume=True)
    return {'first': first, 'second': second}


def infer(mesh, argv: list) -> dict:
    """``gltvae_torch.infer.main(argv)`` on every rank (its --mesh joins
    the initialized group)."""
    from gltvae_torch import infer as tinfer
    return {'output': tinfer.main(argv)}


def sweep(mesh, batch: int, batches: list) -> list:
    """``config.dp_sweep()[0]`` (the full-width model) at global batch
    `batch` in f32: one sup step and one unsup step, each from the initial
    state, on the global (x, y) `batches`. Returns each step's metrics and
    state, and the initial params."""
    import dataclasses
    from gltvae_torch.config import dp_sweep
    from gltvae_torch.ops.gating import cooccurrence_gating_matrix
    from gltvae_torch.parallel.dp import DataParallel, shard_state
    from gltvae_torch.train import steps as tsteps
    from gltvae_torch.train.state import create_train_state, init_model
    _, model_cfg, train_cfg = dp_sweep()[0]
    model_cfg = dataclasses.replace(model_cfg, compute_dtype='float32')
    train_cfg = dataclasses.replace(train_cfg, batch_size=batch)
    mu = cooccurrence_gating_matrix(batches[0][1]).astype(np.float32)
    out = []
    for (x, y), sup in zip(batches, (True, False)):
        model = init_model(model_cfg, train_cfg, mu)
        state = create_train_state(model, train_cfg)
        dp = None
        if mesh is not None:
            shard_state(state, mesh)
            dp = DataParallel(mesh)
        p0 = {k: v.clone() for k, v in model.state_dict().items()}
        step = tsteps.make_train_steps(model, train_cfg, dp)[0 if sup else 1]
        state, m = step(state, torch.from_numpy(_rows(mesh, x)),
                        torch.from_numpy(_rows(mesh, y)), 1.0)
        out.append({'metrics': {k: float(v) for k, v in m.items()},
                    'state': _state(state), 'p0': p0})
    return out


def _model(params: dict, train: Optional[dict] = None):
    from gltvae_torch.models.ccvae import CCVAE
    model_cfg, train_cfg = configs(**(train or {}))
    model = CCVAE(model_cfg, mu_init=params['mu'].numpy())
    model.load_state_dict(params)
    return model, train_cfg


def _fresh_state(mesh, params: dict, train: Optional[dict] = None):
    """A TrainState from `params`, rank 0's on every rank."""
    from gltvae_torch.parallel.dp import shard_state
    from gltvae_torch.train.state import create_train_state
    model, train_cfg = _model(params, train)
    return shard_state(create_train_state(model, train_cfg), mesh), train_cfg


def _t(mesh, a, stacked: bool = False):
    """This rank's rows of a global numpy batch (axis 1 when `stacked`),
    as a tensor."""
    if stacked:
        a = a[:, mesh.rows(a.shape[1])]
    else:
        a = _rows(mesh, a)
    return torch.from_numpy(np.ascontiguousarray(a))


def _clone(m: dict) -> dict:
    return {k: v.clone() for k, v in m.items()}


def _graph_data(seed: int = 0) -> dict:
    """dp_graphs' global data: 8 train batches of B, sup and unsup
    resident splits of 32 rows, a 35-row eval split (a padding row a rank
    of 2) and index rows into each."""
    r = np.random.RandomState(seed)
    img = lambda n: r.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    lab = lambda n: (r.rand(n, 4) > 0.5).astype(np.float32)
    return dict(batches=[(img(B), lab(B)) for _ in range(8)],
                sup=(img(32), lab(32)), unsup=(img(32), lab(32)),
                evals=(img(35), lab(35)),
                idxs=np.stack([r.permutation(32)[:B] for _ in range(4)]),
                eval_idxs=r.permutation(35)[:2 * B].reshape(2, B))


def graph_makers(mesh, params: dict, jit: bool, data: dict) -> dict:
    """Every data-parallel maker of train/steps.py, the shardmap steps
    and ``infer.make_predict`` with ``jit``, each from `params` on
    `data` (``_graph_data``); what each returns."""
    from gltvae_torch import infer as tinfer
    from gltvae_torch.parallel.dp import DataParallel, place_resident_split
    from gltvae_torch.parallel.shardmap import make_shardmap_train_steps
    from gltvae_torch.train import steps as ts
    from gltvae_torch.train.state import step_seed
    dp = DataParallel(mesh)
    bs = data['batches']
    stack = lambda part, i: _t(mesh, np.stack([b[i] for b in part]), True)
    out = {}

    # single steps, a mixed chunk, a uniform chunk
    state, train_cfg = _fresh_state(mesh, params, dict(perc_supervision=0.5))
    sup, unsup = ts.make_train_steps(state.model, train_cfg, dp, jit)
    mixed = ts.make_mixed_scan_train_step(state.model, train_cfg, dp, jit)
    _, scan_unsup = ts.make_scan_train_steps(state.model, train_cfg, dp, jit)
    mets = []
    for (x, y), kind in zip(bs[:3], (True, False, True)):
        state, m = (sup if kind else unsup)(state, _t(mesh, x), _t(mesh, y),
                                            1.0)
        mets.append(_clone(m))
    for part, fn, extra in ((bs[3:7], mixed, (MASK,)),
                            (bs[6:8], scan_unsup, ())):
        state, m = fn(state, stack(part, 0), stack(part, 1), *extra, 1.0)
        mets.append(m)
    out['train'] = {'metrics': mets, 'state': _state(state)}

    # resident chunks: this rank's rows of the splits, rows exchanged
    state, train_cfg = _fresh_state(mesh, params, dict(perc_supervision=0.5))
    rmixed = ts.make_resident_mixed_scan_train_step(state.model, train_cfg,
                                                    dp, jit)
    rsup, _ = ts.make_resident_scan_train_steps(state.model, train_cfg, dp,
                                                jit)
    split = {k: place_resident_split(*data[k], mesh) for k in ('sup', 'unsup')}
    idxs = torch.from_numpy(data['idxs'])
    state, m1 = rmixed(state, *split['sup'], *split['unsup'], idxs, MASK, 1.0)
    state, m2 = rsup(state, *split['sup'], idxs[:3], 1.0)
    out['resident'] = {'metrics': [m1, m2], 'state': _state(state)}

    # eval and ELBO passes, one generator throughout
    model = _fresh_state(mesh, params)[0].model
    _, train_cfg = configs()
    det_cfg = configs(deterministic_eval=True)[1]
    make = lambda name, cfg=train_cfg: getattr(ts, f'make_{name}')(
        model, cfg, dp, jit)
    gen = torch.Generator().manual_seed(3)
    x0, y0 = (_t(mesh, a) for a in bs[0])
    xs, ys = (stack(bs[:3], i) for i in (0, 1))
    ximg, ylab = place_resident_split(*data['evals'], mesh)
    eidx = torch.from_numpy(data['eval_idxs'])
    vals = [make('eval_step')(model, x0, y0, gen, 0.7),
            make('eval_step', det_cfg)(model, x0, y0, gen, 0.7),
            make('elbo_eval_step')(model, x0, gen, 0.7),
            make('scan_eval_step')(model, xs, ys, gen, 0.7),
            make('scan_eval_step', det_cfg)(model, xs, ys, gen, 0.7),
            make('scan_elbo_step')(model, xs, gen, 0.7),
            make('resident_eval_step')(model, ximg, ylab, eidx, gen, 0.7),
            make('resident_elbo_step')(model, ximg, eidx, gen, 0.7)]
    out['eval'] = {'values': vals, 'generator': gen.get_state()}

    # the shardmap steps (per-rank noise)
    state, train_cfg = _fresh_state(mesh, params)
    sm = make_shardmap_train_steps(state.model, train_cfg, mesh, jit)
    mets = []
    for (x, y), fn in zip(bs[:2], sm):
        state, m = fn(state, _t(mesh, x), _t(mesh, y), 1.0)
        mets.append(_clone(m))
    out['shardmap'] = {'metrics': mets, 'state': _state(state)}

    # inference: the global batch's probabilities, gathered
    probs = []
    for stochastic in (False, True):
        predict = tinfer.make_predict(model, stochastic, 0.3, dp, jit)
        for b, (x, _) in enumerate(bs[:2]):
            g = torch.Generator().manual_seed(step_seed(0, b))
            probs.append(predict(_t(mesh, x), g))
    out['infer'] = probs
    return out


#: dp_graphs' Trainer runs (``trainer``'s arguments): chunks of 4 (resident
#: train and eval), and the augmented path per step and in chunks of 2
GRAPH_TRAINERS = {'trainer_chunks': dict(steps_per_dispatch=4),
                  'trainer_augment': dict(pad=2),
                  'trainer_augment_chunks': dict(pad=2, steps_per_dispatch=2)}


def _program_log(log: list):
    """Log each captured program of this process at its first run (its
    kind, mask and static inputs' shapes and dtypes: where a card
    captures it); returns the undo."""
    import weakref
    from gltvae_torch.train import graphs
    call = graphs.Captured.__call__
    seen = weakref.WeakSet()

    def run(self, owner):
        if self not in seen:
            seen.add(self)
            log.append((type(self).__name__, getattr(self, 'mask', None),
                        _shapes(self)))
        return call(self, owner)
    graphs.Captured.__call__ = run
    return lambda: setattr(graphs.Captured, '__call__', call)


def dp_graphs(mesh, params: dict) -> dict:
    """``graph_makers`` and the GRAPH_TRAINERS runs, eagerly
    (``jit=False``) and on the static-buffer path (``jit=True``, each
    captured program logged in the order of its first run)."""
    data = _graph_data()
    out = {}
    for jit in (False, True):
        log = []
        undo = _program_log(log)
        try:
            got = graph_makers(mesh, params, jit, data)
            for name, kw in GRAPH_TRAINERS.items():
                got[name] = trainer(mesh, jit=jit, **kw)
        finally:
            undo()
        got['programs'] = log
        out[jit] = got
    return out


def graphs_vs_gltvae(mesh, params: dict, x, y, noise: list) -> dict:
    """The captured eval and ELBO steps and ``infer.make_predict``
    (stochastic) on this rank's rows of the global batch (x, y), each
    with the global draws `noise` (eval, ELBO, predict) injected."""
    from gltvae_torch import infer as tinfer
    from gltvae_torch.parallel.dp import DataParallel
    from gltvae_torch.train import steps as ts
    model, train_cfg = _model(params)
    dp = DataParallel(mesh)
    draws = iter(noise)
    take = lambda *a, **k: {n: torch.as_tensor(v)
                            for n, v in next(draws).items()}
    real = ts.draw_eval_noise, ts.draw_noise
    ts.draw_eval_noise = ts.draw_noise = take
    try:
        xr, yr = _t(mesh, x), _t(mesh, y)
        acc = ts.make_eval_step(model, train_cfg, dp, jit=True)(
            model, xr, yr, None, 0.7)
        elbo = ts.make_elbo_eval_step(model, train_cfg, dp, jit=True)(
            model, xr, None, 0.7)
    finally:
        ts.draw_eval_noise, ts.draw_noise = real
    predict = tinfer.make_predict(model, True, 0.3, dp, jit=True)
    probs = predict(xr, noise=take())
    return {'acc': acc, 'elbo': elbo, 'probs': probs}


def debug_nans_dp(mesh) -> dict:
    """``debug_nans`` (captured, the static-buffer path) with a count of
    ``DataParallel.average``'s calls: a NaN on rank 0's weights makes the
    dispatch and then every rank's op-by-op replay, which must be the
    data-parallel eager step, one average each."""
    from gltvae_torch.parallel import dp as pdp
    calls = [0]
    real = pdp.DataParallel.average

    def average(self, *a, **k):
        calls[0] += 1
        return real(self, *a, **k)
    pdp.DataParallel.average = average
    try:
        from gltvae_torch.train.graphs import JitStep
        out = debug_nans(mesh)
        from gltvae_torch.train.loop import Trainer
        model_cfg, train_cfg = configs()
        tr = Trainer(model_cfg, train_cfg, mu_init=np.eye(4, dtype=np.float32),
                     device='cpu', mesh=mesh, debug_nans=True)
        out['captured'] = isinstance(tr._sup_step.__wrapped__, JitStep)
    finally:
        pdp.DataParallel.average = real
    out['average_calls'] = calls[0]
    return out


SCENARIOS = {'steps': steps, 'sweep': sweep, 'shardmap': shardmap,
             'trainer': trainer, 'trainer_set': trainer_set,
             'debug_nans': debug_nans, 'resume': resume, 'infer': infer,
             'cli': cli, 'cli_files': cli_files, 'infer_slow': infer_slow,
             'cli_release': cli_release,
             'dp_graphs': dp_graphs, 'graphs_vs_gltvae': graphs_vs_gltvae,
             'debug_nans_dp': debug_nans_dp}
