"""The traversal's captured decode (gltvae_torch/eval/traversal.py
``CapturedTraversal``, the counterpart of gltvae's ``@jax.jit def
traverse``) on the CPU, where the captured path is the static-buffer path
run eagerly and a stand-in graph replays its capture's function.

Held: against gltvae's jitted ``make_traversal_fn`` on the same params
(the bridge) within 1e-5 (tests/test_torch_traversal.py's), for every
latent dim and for a dims subset; against ``jit=False`` bit for bit (the
same ops on the same values); a captured traversal refuses another model;
the grid and decode read
nothing back to the host; ``latent_traversal``, ``render.traversal`` and
the bench twin's ``bench_traversal`` run the captured form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gltvae.eval import traversal as jtrav
from tests.test_torch_graphs import HOST_BUILDS, HOST_READS, _refuse
from tests.test_torch_traversal import TOL, _models

from gltvae_torch import bench, render
from gltvae_torch.eval import traversal as ttrav
from gltvae_torch.train import graphs

torch.set_num_threads(2)

SUBSET = dict(n_steps=5, lo=-2.0, hi=1.5)


def _kw(dims, z_dim):
    return {} if dims == 'all' else dict(SUBSET, dims=[0, z_dim - 1, 2])


@pytest.fixture
def stand_in(monkeypatch):
    """Programs captured by a stand-in graph, whose replay runs the
    captured function again into the capture's outputs; returns the
    count of captures and replays."""
    count = {'captures': 0, 'replays': 0}

    def capture(fn, pool):
        out = fn()
        count['captures'] += 1

        class Graph:
            def replay(self):
                for k, v in fn().items():
                    out[k].copy_(v)
                count['replays'] += 1
        return Graph(), out
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: capture)
    return count


@pytest.mark.parametrize('name', ['small', 'celeba64'])
@pytest.mark.parametrize('dims', ['all', 'subset'])
def test_captured_traversal_matches_gltvae(name, dims):
    jmodel, params, port = _models(name)
    z_dim = port.cfg.z_dim
    kw = _kw(dims, z_dim)
    fn, jfn = (ttrav.make_traversal_fn(port, **kw),
               jtrav.make_traversal_fn(jmodel, **kw))
    for seed in (0, 1):
        z = np.random.RandomState(seed).randn(z_dim).astype(np.float32)
        got = fn(torch.from_numpy(z))
        want = np.asarray(jfn(params, jnp.asarray(z)))
        assert got.shape == want.shape and not got.requires_grad
        assert want.shape[:2] == (len(kw.get('dims', range(z_dim))),
                                  kw.get('n_steps', 8))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize('capture', ['static', 'stand-in graph'])
@pytest.mark.parametrize('dims', ['all', 'subset'])
def test_captured_equals_eager_bit_for_bit(request, capture, dims):
    """Three anchors through one traversal (a graph captures at the first
    and replays at the others): each grid equal to ``jit=False``'s bit for
    bit, and a new tensor each time."""
    _, _, port = _models('small')
    kw = _kw(dims, port.cfg.z_dim)
    eager = ttrav.make_traversal_fn(port, jit=False, **kw)
    count = (request.getfixturevalue('stand_in')
             if capture == 'stand-in graph' else None)
    fn = ttrav.make_traversal_fn(port, **kw)
    grids = []
    for seed in (0, 1, 0):
        z = torch.from_numpy(np.random.RandomState(seed)
                             .randn(port.cfg.z_dim).astype(np.float32))
        grids.append(fn(z))
        assert torch.equal(grids[-1], eager(z)), seed
    assert grids[0].data_ptr() != grids[2].data_ptr()
    assert torch.equal(grids[0], grids[2])
    if count is not None:
        assert count == {'captures': 1, 'replays': 3}


def test_another_model_raises(stand_in):
    """A captured traversal reads the parameters of the model it was
    captured on: after its capture, another model raises and its own
    still runs."""
    _, _, port = _models('small')
    _, _, other = _models('small')
    program = ttrav.CapturedTraversal(
        lambda m, z: m.decode(z[None]), port.cfg.z_dim, torch.device('cpu'))
    program.z_base.zero_()
    with torch.no_grad():
        first = program(port)['images']
        with pytest.raises(ValueError, match='another model'):
            program(other)
        assert torch.equal(program(port)['images'], first)
    assert stand_in == {'captures': 1, 'replays': 2}


def test_the_program_reads_nothing_back(monkeypatch):
    """After a first call, the grid and the decode run with every Tensor
    method that reads a value back to the host, and every tensor
    constructor from host data, raising."""
    _, _, port = _models('small')
    fn = ttrav.make_traversal_fn(port, dims=[1, 3, 5])
    z = torch.from_numpy(np.random.RandomState(3).randn(port.cfg.z_dim)
                         .astype(np.float32))
    want = fn(z)
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, _refuse(name))
        for name in HOST_BUILDS:
            m.setattr(torch, name, _refuse(name))
        got = fn(z)
    assert torch.equal(got, want)


def test_the_callers_run_the_captured_form(stand_in, monkeypatch):
    """latent_traversal (render.traversal through it) and bench_traversal
    each capture their decode once and replay it; render's grid equals the
    eager decode of the same anchor bit for bit."""
    _, _, port = _models('small')
    z = torch.zeros(port.cfg.z_dim)
    got = ttrav.latent_traversal(port, z_base=z, n_steps=3)
    assert torch.equal(got, ttrav.latent_traversal(port, z_base=z, n_steps=3,
                                                   jit=False))
    assert stand_in == {'captures': 1, 'replays': 1}
    grid = render.traversal(port, anchor='prior', n_steps=3)
    dims = list(range(port.cfg.z_style, port.cfg.z_dim))
    want = ttrav.make_traversal_fn(port, n_steps=3, dims=dims, jit=False)(
        render.prior_anchor(port, (), 0))
    assert torch.equal(grid, want)
    assert stand_in == {'captures': 2, 'replays': 2}
    assert bench.bench_traversal(n_steps=1, iters=2, device='cpu') > 0
    assert stand_in == {'captures': 3, 'replays': 5}
