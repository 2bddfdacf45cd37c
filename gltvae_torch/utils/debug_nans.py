"""``--debug-nans``: name the first op that made a NaN (the counterpart of
JAX's ``jax_debug_nans``, train.py's ``--debug-nans``).

JAX checks the outputs of each jitted call; when one holds a NaN it runs
the call again op by op and raises ``FloatingPointError`` at the first
primitive whose output is NaN. A NaN that stays inside a call, such as an
intermediate that a ``where`` masks out, never trips it.

``nan_checked(fn)`` does the same for one dispatch of the port (a train
step or chunk, an eval pass). After the call it checks every floating
tensor in the result and, for a ``TrainState`` argument, the new
parameters and Adam moments (a NaN gradient reaches the moments through
``m = b1·m + (1-b1)·g``). On a NaN it puts back what the call changed (the
state's parameters, moments, step and count, and the state of each
``torch.Generator`` argument), runs the call again under
``torch.autograd.set_detect_anomaly(True)`` and a dispatch mode that raises
``FloatingPointError`` naming the first aten op whose floating output has
a NaN, forward or backward (anomaly mode adds the forward call that made
the failing backward node). The op-by-op check is on only for that replay,
so a clean dispatch never stops at a masked NaN (the μ≥1 hardening in
``ops/sampling.py``). A clean dispatch pays a copy of the state and one
wait for the device. A captured dispatch (a train step or chunk, an eval
or ELBO pass; train/graphs.py) launches a graph, not ops, so its replay
runs the eager counterpart instead (``replay=``), from the same state and
the same draws: the per-step generators are seeded by the step, and the
eval generator is put back first.

On a mesh (``nan_checked(fn, mesh)``) the dispatch holds collectives, so
every rank must replay or none: the "a NaN is present" decision is
all-reduced (MAX) first, eagerly between two dispatches (a captured
dispatch's collectives are inside its graph). A captured dispatch's
replay is then its eager data-parallel counterpart on every rank, so
every rank meets the same collectives. The replay then records the first NaN op instead
of raising at it, so that every rank reaches the replay's collectives,
and each rank raises after it: naming its first NaN op, or saying that
its own replay made none (the NaN came from another rank's rows through
the averaged gradient).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from gltvae_torch.train.state import TrainState


#: Ops whose output is uninitialized memory (a kernel fills it later, as
#: the dequant wrapper's output), which may hold any bit pattern.
_UNINITIALIZED = frozenset({'empty', 'empty_like', 'empty_strided',
                            'new_empty', 'new_empty_strided'})


class _FirstNaN(TorchDispatchMode):
    """Raises FloatingPointError after the first op with a NaN output, or,
    with ``record``, keeps its message in ``first`` and goes on."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.record = record
        self.first: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.first is None \
                and func.overloadpacket.__name__ not in _UNINITIALIZED \
                and any(bool(t.isnan().any()) for t in _floats(out)):
            self.first = f'invalid value (nan) encountered in {func}'
            if not self.record:
                raise FloatingPointError(self.first)
        return out


def _flat(tensors) -> torch.Tensor:
    """The tensors (of one device) as one f32 vector: a few launches,
    whatever their number."""
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _floats(tree):
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def _state_tensors(state: TrainState):
    return (list(state.model.parameters()) + list(state.adam_m.values())
            + list(state.adam_v.values()))


def _snapshot(args):
    saved = []
    for a in args:
        if isinstance(a, TrainState):      # params and moments are f32
            saved.append((a, (a.step, a.adam_count,
                              _flat(_state_tensors(a)))))
        elif isinstance(a, torch.Generator):
            saved.append((a, a.get_state()))
    return saved


@torch.no_grad()
def _restore(saved) -> None:
    for obj, snap in saved:
        if isinstance(obj, TrainState):
            obj.step, obj.adam_count, flat = snap
            at = 0
            for t in _state_tensors(obj):
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()
        else:
            obj.set_state(snap)


def nan_checked(fn: Callable, mesh=None,
                replay: Optional[Callable] = None) -> Callable:
    """`fn` (a dispatch taking a TrainState or a torch.Generator among its
    positional arguments, or neither) that raises FloatingPointError where
    ``jax_debug_nans`` would; on a ``parallel.mesh.Mesh``, on every rank
    together. `replay` is the dispatch the op-by-op check runs in `fn`'s
    place: the eager form of a captured step, since a graph's replay
    dispatches no op. See the module docstring."""
    replay = fn if replay is None else replay

    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = _snapshot(args)
        out = fn(*args, **kwargs)
        checked = _floats(out) + [t for a in args if isinstance(a, TrainState)
                                  for t in _state_tensors(a)]
        found = bool(checked) and _flat(checked).isnan().any()
        if mesh is not None:
            found = mesh.all_reduce_(torch.as_tensor(
                found, dtype=torch.float32, device=mesh.device).reshape(1),
                'max')[0]
        if not bool(found):
            return out
        _restore(saved)
        first = _FirstNaN(record=mesh is not None)
        with torch.autograd.set_detect_anomaly(True, check_nan=mesh is None), \
                first:
            replay(*args, **kwargs)
        if first.first is not None:
            raise FloatingPointError(first.first)
        name = getattr(fn, '__name__', type(fn).__name__)
        raise FloatingPointError(
            f'invalid value (nan) in the output of {name}; the op by '
            f'op replay made none' + (' on this rank' if mesh is not None
                                      else ''))
    return run
