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
wait for the device.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from gltvae_torch.train.state import TrainState


#: Ops whose output is uninitialized memory (a kernel fills it later, as
#: the dequant wrapper's output), which may hold any bit pattern.
_UNINITIALIZED = frozenset({'empty', 'empty_like', 'empty_strided',
                            'new_empty', 'new_empty_strided'})


class _FirstNaN(TorchDispatchMode):
    """Raises FloatingPointError after the first op with a NaN output."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED and any(
                bool(t.isnan().any()) for t in _floats(out)):
            raise FloatingPointError(
                f'invalid value (nan) encountered in {func}')
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


def nan_checked(fn: Callable) -> Callable:
    """`fn` (a dispatch taking a TrainState or a torch.Generator among its
    positional arguments, or neither) that raises FloatingPointError where
    ``jax_debug_nans`` would; see the module docstring."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = _snapshot(args)
        out = fn(*args, **kwargs)
        checked = _floats(out) + [t for a in args if isinstance(a, TrainState)
                                  for t in _state_tensors(a)]
        if not checked or not bool(_flat(checked).isnan().any()):
            return out
        _restore(saved)
        with torch.autograd.set_detect_anomaly(True), _FirstNaN():
            fn(*args, **kwargs)
        raise FloatingPointError(
            f'invalid value (nan) in the output of {fn.__name__}; the op by '
            f'op replay made none')
    return run
