"""Leaving a process group releases the captured programs that hold its
collectives (gltvae_torch/parallel/mesh.py ``shutdown``, ``register``;
train/graphs.py ``Captured.release``), on the CPU.

A graph that holds NCCL's kernels keeps NCCL from destroying its
communicator, so a process that left its group with such a graph alive
blocked in ``destroy_process_group``. Here the graphs are stand-ins
(``tests/torch_dp_workers.py::fake_graphs``: nothing is recorded, a
replay runs the device part, ``reset`` is logged) injected through
``graphs.graph_capture``, on a gloo group of one in this process, and on
2 gloo ranks running the data-parallel CLI as chip_smoke.py's phase 39
runs it (its Trainers held past ``cli.main``).

Held:
- ``shutdown`` resets the graph of every registered program (a train
  step, a chunk, an eval pass, inference's forward) before the group is
  destroyed, whoever holds the program;
- the registry holds no program alive;
- a released program raises when run again, naming the group it left,
  and nothing of it runs (no eager fallback);
- programs captured with no process group are not registered;
- an error inside a release propagates out of ``shutdown``;
- on 2 ranks, through ``cli.main``: both ranks capture the same programs
  and issue the same collectives in the same order, every rank leaves
  its group, and every program of each rank was released before it left.
"""

import gc
import weakref

import pytest
import torch
import torch.distributed as dist

from tests import torch_dp_workers as W
from tests.test_torch_dp_cli import _cli_argv
from tests.test_torch_graphs import CPU, batches, configs, mu_init

from gltvae_torch import infer as tinfer
from gltvae_torch.parallel import mesh as pmesh
from gltvae_torch.parallel.dp import DataParallel
from gltvae_torch.parallel.mesh import Mesh
from gltvae_torch.train import graphs
from gltvae_torch.train import steps as tsteps
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(1)

KINDS = ['step', 'chunk', 'eval', 'predict']


#: weak references to the programs captured in this test, in order
MADE = []


@pytest.fixture
def events(monkeypatch):
    """The resets of the stand-in graphs, injected for every program made
    from here on, and the group's destroy (with the count of programs
    still registered), in order; the registry starts empty, and each
    captured program is noted (weakly) in MADE."""
    log = []
    MADE.clear()
    monkeypatch.setattr(pmesh, '_captured', weakref.WeakSet())
    monkeypatch.setattr(graphs, 'graph_capture',
                        lambda dev: W.fake_graphs(log))
    capture = graphs.Captured._capture

    def noted(self, owner):
        capture(self, owner)
        MADE.append(weakref.ref(self))
    monkeypatch.setattr(graphs.Captured, '_capture', noted)
    destroy = dist.destroy_process_group

    def destroyed(*a, **k):
        log.append(('destroy', len(pmesh.registered())))
        return destroy(*a, **k)
    monkeypatch.setattr(dist, 'destroy_process_group', destroyed)
    return log


@pytest.fixture
def group(tmp_path):
    """A gloo group of one in this process, destroyed after the test if
    the test left it standing; its mesh."""
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            world_size=1, rank=0)
    try:
        yield pmesh.create_mesh('cpu')
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _state():
    model_cfg, train_cfg = configs()
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    return create_train_state(model, train_cfg), train_cfg


def _program(kind, state, train_cfg, dp):
    """One program of `kind` made with `dp` and run once (captured there);
    returns (the maker's function, a call that runs it again, and the
    captured program)."""
    (x, y), (x2, y2) = batches(2)
    model = state.model
    gen = torch.Generator().manual_seed(0)
    if kind == 'step':
        fn = tsteps.make_train_steps(model, train_cfg, dp)[0]

        def call():
            return fn(state, x, y, 1.0)
    elif kind == 'chunk':
        fn = tsteps.make_mixed_scan_train_step(model, train_cfg, dp)
        xs, ys = torch.stack([x, x2]), torch.stack([y, y2])

        def call():
            return fn(state, xs, ys, [True, False], 1.0)
    elif kind == 'eval':
        fn = tsteps.make_eval_step(model, train_cfg, dp)

        def call():
            return fn(model, x, y, gen, 1.0)
    else:
        fn = tinfer.make_predict(model, True, 0.3, dp)

        def call():
            return fn(x, gen)
    call()
    program, = [ref() for ref in MADE]
    return fn, call, program


@pytest.mark.parametrize('kind', KINDS)
def test_shutdown_resets_every_registered_graph_before_it_destroys(
        events, group, kind):
    state, train_cfg = _state()
    fn, call, program = _program(kind, state, train_cfg, DataParallel(group))
    graph = program.graph
    assert graph is not None
    assert pmesh.registered() == [program]
    assert not events
    pmesh.shutdown()                # `fn` and `program` are still held
    assert events == [('reset', id(graph)), ('destroy', 0)]
    assert program.released and program.graph is None
    assert program.outputs is None and program.pool is None
    assert not dist.is_initialized()
    assert pmesh.registered() == []


@pytest.mark.parametrize('kind', KINDS)
def test_a_released_program_raises_and_runs_nothing(events, group,
                                                    monkeypatch, kind):
    state, train_cfg = _state()
    fn, call, program = _program(kind, state, train_cfg, DataParallel(group))
    pmesh.shutdown()
    before = ({k: v.clone() for k, v in state.model.state_dict().items()},
              state.step, state.adam_count)
    ran = []
    monkeypatch.setattr(type(program), '_run',
                        lambda self, owner: ran.append(1))
    with pytest.raises(RuntimeError, match='left its process group'):
        call()
    with pytest.raises(RuntimeError, match='left its process group'):
        program(program.owner)
    assert not ran
    after = state.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before[0].items())
    assert (state.step, state.adam_count) == before[1:]


def test_the_registry_keeps_no_program_alive(events, group):
    state, train_cfg = _state()
    fn, call, program = _program('step', state, train_cfg,
                                 DataParallel(group))
    ref = weakref.ref(program)
    assert pmesh.registered() == [program]
    del fn, call, program
    gc.collect()
    assert ref() is None
    assert pmesh.registered() == []
    pmesh.shutdown()
    assert events == [('destroy', 0)]


@pytest.mark.parametrize('where', ['one_device', 'no_group'])
def test_a_program_captured_with_no_group_is_not_registered(events, where):
    """Captured with no mesh, or on a mesh of one with no process group:
    nothing to release, so nothing is registered and shutdown (with no
    group) resets nothing."""
    state, train_cfg = _state()
    dp = None if where == 'one_device' else DataParallel(Mesh(0, 1, CPU))
    fn, call, program = _program('step', state, train_cfg, dp)
    assert program.graph is not None and not program.released
    assert pmesh.registered() == []
    pmesh.shutdown()
    assert events == []
    call()                          # still runs
    assert not program.released


def test_an_error_in_a_release_propagates(events, group, monkeypatch):
    state, train_cfg = _state()
    fn, call, program = _program('step', state, train_cfg,
                                 DataParallel(group))

    def broken():
        raise RuntimeError('injected reset failure')
    monkeypatch.setattr(program.graph, 'reset', broken)
    with pytest.raises(RuntimeError, match='injected reset failure'):
        pmesh.shutdown()
    assert not any(e[0] == 'destroy' for e in events)
    assert dist.is_initialized()


def test_a_program_of_a_mesh_with_nothing_to_capture_is_not_registered(
        group, monkeypatch):
    """On the CPU nothing is captured (the static-buffer path runs
    eagerly): registering and releasing are no-ops."""
    monkeypatch.setattr(pmesh, '_captured', weakref.WeakSet())
    state, train_cfg = _state()
    sup = tsteps.make_train_steps(state.model, train_cfg,
                                  DataParallel(group))[0]
    (x, y), = batches(1)
    sup(state, x, y, 1.0)
    program, = sup.steps.values()
    assert program.capture is None and program.graph is None
    assert pmesh.registered() == []
    pmesh.shutdown()
    assert not program.released and not dist.is_initialized()


# ------------------------------------------- the CLI on 2 gloo ranks
@pytest.fixture(scope='module')
def cli_ranks(tmp_path_factory):
    """The data-parallel CLI on 2 gloo ranks (the --dist-* triple), every
    program captured through the stand-in graphs and the Trainers held
    past ``cli.main``."""
    tmp = tmp_path_factory.mktemp('release_cli')
    return W.launch('cli_release', 2, tmp / 'ranks', join=False,
                    argv=_cli_argv(tmp / 'run'))


def test_the_cli_runs_as_phase_39_does(cli_ranks):
    for r, got in enumerate(cli_ranks):
        assert got['mesh'] == (r, 2, 'gloo')
        assert got['jit'] and got['local_batches']
        assert got['result'] == cli_ranks[0]['result']


def test_both_ranks_capture_and_issue_the_same_in_the_same_order(
        cli_ranks):
    r0, r1 = cli_ranks
    assert r0['programs'] == r1['programs']
    kinds = {kind for kind, _, _ in r0['programs']}
    assert kinds == {'CapturedStep', 'CapturedPass'}
    assert r0['collectives'] == r1['collectives']
    assert len(r0['collectives']) > len(r0['programs'])


def test_every_rank_leaves_its_group(cli_ranks):
    for got in cli_ranks:
        assert got['left']
        assert got['registered_after'] == 0


def test_every_program_of_each_rank_was_released_before_it_left(cli_ranks):
    for got in cli_ranks:
        n = len(got['programs'])
        assert n > 0 and all(got['released'])
        assert sorted(got['events'][:n]) == [('reset', i) for i in range(n)]
        assert got['events'][n:] == [('destroy', 0)]
        assert all(m is not None and 'left its process group' in m
                   for m in got['raised'])
