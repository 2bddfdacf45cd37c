"""The data-parallel mesh: one process per device over ``torch.distributed``
(counterpart of gltvae/parallel/mesh.py).

A JAX mesh is one process driving N devices, and XLA inserts the gradient
all-reduce. Here a mesh is a process group: each rank runs the whole
program on its own device and the collectives are explicit, NCCL on CUDA
devices and gloo on the CPU. ``Mesh`` records what a rank needs to know:
its rank, the world size, its device, the backend and the group.

Ranks start under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``; ``create_mesh`` joins the group, one process too), or
with ``initialize_multihost`` given the coordinator's address, the number
of processes and this process's id (train.py's ``--dist-*`` flags). A
process with neither is a world of 1 with no group, whose collectives are
no-ops.

Gloo takes CUDA tensors only in ``all_reduce`` and ``broadcast``, so
``all_gather`` on gloo is an ``all_reduce`` SUM of a zero-filled buffer
holding this rank's block: exact for every value but -0.0, which comes
back +0.0 (the gathered rows are uint8 images, 0/1 matches and
probabilities, none of which is -0.0). NCCL refuses two ranks on one GPU,
so ranks that share a card use gloo.

The collectives read nothing back to the host, so on NCCL they run
inside a CUDA graph (``capturable``; train/graphs.py captures the
data-parallel dispatches with them), once an eager collective has made
the group's communicator. A graph cannot hold gloo's trip through host
memory, so a gloo mesh over CUDA tensors runs eagerly. ``collectives``
counts the collective calls made through a ``Mesh`` in this process (one
a backend call; a capture's recording is one, a graph's replay makes
none), so that a capture can say how many its graph holds.

A graph that holds NCCL's kernels holds the communicator too: NCCL's
destroy waits until every such graph is gone, so a process that left its
group with one alive would block there for good. Each program captured
with the group's collectives is therefore registered here (``register``,
weakly: the registry keeps nothing alive), and ``shutdown`` releases every
live one (its graph reset and dropped) before it destroys the group,
whoever still holds the program. A released program raises if it is run
again; nothing runs eagerly in its place.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
import weakref
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from gltvae_torch import resolve_device, trace

DATA_AXIS = 'data'

#: Collective calls made through a ``Mesh`` with a group in this process
#: (one a backend call; a gloo ``all_gather`` is its one ``all_reduce``).
collectives = 0


#: The live programs whose graphs hold this process's group's collectives
#: (``register``), weakly held.
_captured: 'weakref.WeakSet' = weakref.WeakSet()


def _issued() -> None:
    global collectives
    collectives += 1


def register(program) -> None:
    """Have ``shutdown`` release `program` (a ``train.graphs.Captured``
    whose graph was captured with this group's collectives) before it
    leaves the group. The registry holds it weakly: a program its holders
    drop leaves the registry."""
    _captured.add(program)


def registered() -> list:
    """The live registered programs."""
    return list(_captured)


def release_captured() -> None:
    """Release every live registered program (``Captured.release``: its
    graph reset and dropped, a later run raises) and empty the registry.
    An error in a release propagates."""
    for program in list(_captured):
        program.release()
        _captured.discard(program)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D data-parallel mesh. ``group`` is None for a world
    of 1 with no process group."""
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the run's files; the others pass a barrier."""
        return self.rank == 0

    @property
    def capturable(self) -> bool:
        """Whether this rank's collectives can run inside a CUDA graph:
        NCCL's can (with the communicator made by an eager collective
        first), and so can a world of 1 with no group (no collective).
        Gloo's cannot: it moves CUDA tensors through host memory."""
        return self.backend in (None, 'nccl')

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of `n` global rows, in rank order."""
        if n % self.world:
            raise ValueError(
                f'global batch dim {n} not divisible by process_count '
                f'{self.world}: rows would be silently dropped')
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce_(self, t: torch.Tensor, op: str = 'sum') -> torch.Tensor:
        """In place over the ranks ('sum' or 'max'); a no-op with no group."""
        if self.group is not None:
            _issued()
            dist.all_reduce(t, {'sum': dist.ReduceOp.SUM,
                                'max': dist.ReduceOp.MAX}[op],
                            group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place."""
        if self.group is not None:
            _issued()
            dist.broadcast(t, src, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated on dim 0 in rank order."""
        if self.group is None:
            return t
        t = t.contiguous()
        if self.backend == 'gloo':
            out = t.new_zeros((self.world * t.shape[0],) + t.shape[1:])
            out[self.rows(out.shape[0])] = t
            return self.all_reduce_(out)
        out = t.new_empty((self.world * t.shape[0],) + t.shape[1:])
        _issued()
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def barrier(self) -> None:
        """Every rank waits here for the others (one tiny all_reduce on the
        rank's device, so NCCL needs no barrier device list)."""
        with trace.span('wait.barrier'):
            self.all_reduce_(torch.zeros(1, device=self.device))


def _rank_device(device, local_rank: int) -> torch.device:
    """`device` ('cuda' by default), a bare 'cuda' resolved to this rank's
    card, made the current CUDA device."""
    dev = resolve_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _backend(dev: torch.device) -> str:
    return 'nccl' if dev.type == 'cuda' else 'gloo'


def _launched() -> bool:
    """This process is a rank that torchrun started: ``env://`` has the
    rank and the rendezvous address it needs, or the world is larger than
    one."""
    return (int(os.environ.get('WORLD_SIZE', '1')) > 1
            or ('RANK' in os.environ and 'MASTER_ADDR' in os.environ))


def create_mesh(device=None) -> Mesh:
    """The mesh of this process: from an initialized default group, else
    from torchrun's environment (joins the group, NCCL on CUDA, gloo on
    the CPU; a single torchrun process is a group of one), else a world of
    1 with no group. A bare 'cuda' device becomes the rank's card,
    ``LOCAL_RANK`` (or the rank modulo the cards), and the current CUDA
    device, before the group is joined."""
    if not dist.is_initialized() and _launched():
        dev = _rank_device(device, int(os.environ.get('LOCAL_RANK', '0')))
        dist.init_process_group(_backend(dev), init_method='env://')
    if not dist.is_initialized():
        return Mesh(0, 1, _rank_device(device, 0))
    rank = dist.get_rank()
    dev = _rank_device(device, int(os.environ.get('LOCAL_RANK', rank)))
    return Mesh(rank, dist.get_world_size(), dev, dist.get_backend(),
                dist.group.WORLD)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None, backend: Optional[str] = None
                         ) -> None:
    """Join this process to the mesh's group before ``create_mesh``: NCCL
    on a CUDA device, gloo on the CPU (or `backend`). The coordinator is
    ``host:port`` (a TCP store that process 0 serves) or a ``tcp://`` or
    ``file://`` URL.

    With no process count, or one process and no coordinator, this is a
    no-op, as in gltvae. One process with a coordinator makes a world-1
    group, so the collectives run through the backend on one device."""
    if num_processes is None or (num_processes <= 1
                                 and coordinator_address is None):
        return
    if coordinator_address is None or process_id is None:
        raise ValueError('initialize_multihost needs coordinator_address '
                         'and process_id with num_processes')
    dev = _rank_device(device, process_id)
    url = (coordinator_address if '://' in coordinator_address
           else f'tcp://{coordinator_address}')
    dist.init_process_group(backend or _backend(dev), init_method=url,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the default group, if this process is in one. The captured
    programs this process no longer references are freed first
    (``gc.collect``: a Trainer's graphs may sit in a reference cycle), the
    device finishes its work, and every program still registered is
    released (``release_captured``), so that no live graph holds NCCL's
    kernels when the group is destroyed (NCCL's destroy would wait for
    it). A caller may keep its Trainer or predict function: its captured
    programs raise if run after this."""
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        release_captured()
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (),
          timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes (the spawn
    start method; `fn` must be importable) and wait for all of them. A rank
    that raises or exits non-zero raises here with its traceback, and the
    others are stopped; ranks still running after `timeout_s` seconds are
    killed and TimeoutError is raised."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method='spawn')
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f'{world} ranks of {fn.__qualname__} still running '
                    f'after {timeout_s} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
