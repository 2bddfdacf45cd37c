"""chip_smoke.py phase 42's helpers on the CPU: the graph audit's NCCL
kernel nodes against a stand-in dump, and the ``dp_graphs_speed:``
record.

A stand-in graph (tests/test_torch_graphs.py's ``fake_capture``) replays
by running the device part again; its dump is written by the test. The
mesh is rank 0 of 2 with a stand-in group whose all-reduce does nothing,
so that the data-parallel step issues its one collective (the gradient
average) through ``Mesh.all_reduce_`` without a process group. The whole
phase rehearses on gloo CPU ranks by hand (``mesh_graphs_phase(cpu, ...,
cfgs=<tiny configurations>)``; about 80 s at D = 1 and 2).
"""

import pytest
import torch

import chip_smoke
from gltvae_torch.parallel.dp import DataParallel
from gltvae_torch.parallel.mesh import Mesh
from gltvae_torch.train import graphs
from gltvae_torch.train import steps as tsteps
from tests.test_torch_graphs import (CPU, batches, configs,
                                     counted,  # noqa: F401 (a fixture)
                                     fake_capture, mu_init)
from gltvae_torch.train.state import create_train_state, init_model

torch.set_num_threads(2)


def _node(i, kind, name=''):
    """One node's record as ``cudaGraphDebugDotPrint`` writes it."""
    return (f'"graph_1_node_{i}"[style="solid" shape="record" label="{{\n'
            f'{kind}\n| {{ID | {i} | {i}}}\n| {{{name}}}\n}}"];\n')


def test_nccl_nodes_counts_the_kernel_records_that_run_nccl():
    text = ('digraph dot {\n'
            + _node(0, 'KERNEL', 'dequant_kernel')
            + _node(1, 'KERNEL',
                    'ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernel'
                    'ArgsStorage&lt;4096ul&gt;)')
            + _node(2, 'MEMCPY', '')
            + _node(3, 'KERNEL', '_Z38ncclDevKernel_AllGather_RING_LL'
                                 '24ncclDevKernelArgsStorageILm4096EE')
            + _node(4, 'KERNEL', 'void at::native::elementwise_kernel')
            + '"graph_1_node_0" -> "graph_1_node_1" [style="solid"];\n}\n')
    assert chip_smoke.nccl_nodes(text) == 2
    assert chip_smoke.nccl_nodes(text.replace('nccl', 'xxxx')) == 0
    assert text.count(chip_smoke.DEQUANT_KERNEL) == 1


@pytest.mark.parametrize('nodes', [1, 0])
def test_the_audit_holds_a_mesh_graph_to_its_collectives(monkeypatch,
                                                         tmp_path, counted,
                                                         nodes):
    """A data-parallel step's graph on a mesh of 2 issues one collective
    (the gradient average) at its capture, which is made in the
    thread_local error mode: a dump holding one NCCL kernel node is
    tallied, one holding none fails the capture. On a mesh of one the
    audit wants none."""
    monkeypatch.setattr(chip_smoke, 'ROOT', str(tmp_path))
    # audit_graphs patches these for the rest of its process
    monkeypatch.setattr(graphs, '_cuda_capture', graphs._cuda_capture)
    monkeypatch.setattr(graphs.Captured, '_capture',
                        graphs.Captured._capture)
    monkeypatch.setattr(torch.distributed, 'all_reduce',
                        lambda t, op=None, group=None: None)
    monkeypatch.setattr(chip_smoke, 'mesh_world', lambda: 2)
    tally = chip_smoke.audit_graphs()
    model_cfg, train_cfg = configs()
    model = init_model(model_cfg, train_cfg, mu_init(), CPU)
    state = create_train_state(model, train_cfg)
    mesh = Mesh(0, 2, CPU, 'gloo', group=object())
    sup, _ = tsteps.make_train_steps(model, train_cfg, DataParallel(mesh),
                                     jit=True)
    stand_in = fake_capture(state)
    modes = []

    def capture(fn, pool, error_mode='global'):
        modes.append(error_mode)
        graph, out = stand_in(fn, pool)

        def dump(path):
            with open(path, 'w') as f:
                f.write(_node(0, 'KERNEL', 'dequant_kernel')
                        + _node(1, 'KERNEL', 'ncclDevKernel_AllReduce_Sum_'
                                             'f32_RING_LL') * nodes)
        graph.debug_dump = dump
        return graph, out
    monkeypatch.setattr(graphs, 'graph_capture', lambda dev: capture)
    (x, y), = batches(1)
    x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
    if nodes:
        sup(state, x, y, 1.0)
        assert modes == ['thread_local']
        assert {k: tally[k] for k in ('graphs', 'dequant_nodes',
                                      'nccl_nodes', 'collectives',
                                      'mesh_graphs')} == {
            'graphs': 1, 'dequant_nodes': 1, 'nccl_nodes': 1,
            'collectives': 1, 'mesh_graphs': 1}
        cs, = sup.steps.values()
        assert cs.collectives == 1
    else:
        with pytest.raises(RuntimeError, match='holds 0 NCCL kernel nodes; '
                                               'its capture issued 1 '
                                               'collectives'):
            sup(state, x, y, 1.0)
        monkeypatch.setattr(chip_smoke, 'mesh_world', lambda: 1)
        sup2, _ = tsteps.make_train_steps(model, train_cfg,
                                          DataParallel(mesh), jit=True)
        sup2(state, x, y, 1.0)          # one rank: NCCL puts no node
        assert tally['nccl_nodes'] == 0 and tally['collectives'] == 1


def test_the_speed_record_takes_the_slowest_rank():
    """dp_graphs_speed: rank 0's walls, img/s and host launches; the
    device and NCCL ms of the rank with the most device time and the busy
    share of rank 0's wall it fills; the largest peak memory."""
    def rank(device_ms, nccl_ms, peak):
        return dict(images=4096, first_call_ms=300.0, wall_ms=10.0,
                    img_s=409600.0, pipelined_ms=9.5,
                    pipelined_img_s=431157.9, device_ms=device_ms,
                    nccl_ms=nccl_ms, launches={'cudaGraphLaunch': 1.0},
                    launches_total=29.0, peak_mib=peak, units=10,
                    profiled=3)
    rec = chip_smoke.dp_graphs_speed_record(
        2, 'step', 'captured', 4096, 'bfloat16',
        [rank(8.0, 0.05, 900.0), rank(9.0, 0.07, 800.0)], 'card, 700 W')
    assert rec == {
        'phase': 42, 'world': 2, 'dispatch': 'step', 'mode': 'captured',
        'batch': 4096, 'rows_per_rank': 2048, 'dtype': 'bfloat16',
        'images': 4096, 'first_call_ms': 300.0, 'wall_ms_median': 10.0,
        'img_s': 409600.0, 'pipelined_ms': 9.5,
        'pipelined_img_s': 431157.9, 'device_ms': 9.0, 'device_rank': 1,
        'nccl_ms': 0.07, 'busy': 0.9,
        'host_launches': {'cudaGraphLaunch': 1.0},
        'host_launches_total': 29.0, 'peak_mib': 900.0, 'units': 10,
        'profiled_units': 3, 'card': 'card, 700 W'}
