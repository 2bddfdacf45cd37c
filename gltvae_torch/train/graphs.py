"""Captured programs: the counterpart of gltvae's jitted dispatches
(``jax.jit`` of the train steps, the eval and ELBO passes and the
``lax.scan`` chunks of gltvae/train/steps.py).

In gltvae every dispatch of the Trainer is one compiled XLA program, and
the train state is donated, so it is updated in place. Here a dispatch is
split in two:

- the host part (train/steps.py): the draws, made eagerly from their
  generators straight into the program's static buffers (a train step's
  raw noise from its per-step generator, its augment offsets from
  ``step_seed(seed + 2, step)``, an eval pass's raw noise from the one
  eval generator, batch by batch; raw: the gates' uniforms, not their
  Gumbels); the Adam count and its ``alpha``; ``state.step``;
- the device part: the gate Gumbels from their uniforms
  (``steps.gate_gumbels``), the input stage (the row gather of a resident
  split, the augment or the dequant kernel), the forward pass, and for
  training ``torch.autograd.grad``, Keras Adam in place and the metrics.
  It reads nothing back to the host, so on a CUDA device it is captured
  once as a CUDA graph and replayed at every dispatch.

``Captured`` is what every such program shares: static inputs, which the
host part fills before each run, so every value that changes from run to
run reaches the graph through memory and none is baked into it; a warm-up
on a side stream before the capture (the lazy set-up of cuBLAS, cuDNN,
the autograd engine and the kernels' builds happens there, not under
capture); one graph memory pool per maker; outputs cloned after each
replay (the next replay overwrites the graph's own); the check that a
graph runs only the state or the model it was captured on; and the
kernels' launch counts. Three kinds build on it:

- ``CapturedStep``: one train step kind at one input shape and dtype;
- ``CapturedChunk``: n train steps in order, one graph per sup/unsup
  mask pattern (gltvae's ``lax.cond`` picks the step kind at run time,
  which a CUDA graph cannot), over a shipped stacked batch or rows of
  resident splits;
- ``CapturedPass``: an eval or ELBO pass over n batches (per batch,
  stacked, or gathered from a resident split: a resident eval epoch is
  one replay). It reads the model's parameters in place and writes
  nothing back.

Each kind keys its programs by the form of the noise too ('uniform', the
raw draws; 'gumbel', Gumbels given or injected), so injected Gumbels run a
program of their own. eval/traversal.py's ``CapturedTraversal`` (the grid
and decode of a latent traversal) builds on ``Captured`` as well.

A train graph updates the state's params and Adam moments in place, so
whatever replaces them must write into them (``TrainState.
load_state_dict`` and ``Trainer.load_params`` do); an eval graph reads the
parameters at their addresses, and a resident graph the split's tensors,
which it keeps alive. The warm-up of a train graph puts the params,
moments, step and count back, so the first real run starts where the
eager one would. A capture or replay error raises: nothing falls back to
the eager path. On the CPU there is nothing to capture, and the same
static-buffer path runs eagerly.

The launch counts of the dequant and augment kernels
(``ops.preprocess.launches``, ``augment_launches``) follow the replays: a
replay launches the kernels without calling their wrappers, so each
replay adds the launches the capture recorded. The warm-up's launches are
left out, as a launch made to compare a kernel with its plain version is:
what they produced is put back or dropped.

**On a mesh** (gltvae's jitted data-parallel makers, parallel/dp.py) the
device part holds the step's collectives: the gradient all-reduce, the
eval's all_gather, a resident chunk's row exchange. Over NCCL they are
captured into the graph with the rest (``parallel.mesh.Mesh.
capturable``); the warm-up's collectives, eager on the side stream, make
the communicator first. Every rank captures the same programs in the same
order, since every rank runs the same schedule (the same mask patterns,
the same short last chunk), and so replays them in the same order. The
host part draws the global batch's raw noise into a global-size static
slot, and the device part makes the gate Gumbels in full (every rank reads
all of them) and reads this rank's rows of the rest as views; a padded
batch's crops are this rank's rows of the global batch's draws
(``Crop``). Every program takes the mesh as its ``dp`` (a
``parallel.dp.DataParallel``, None on one device), from which it derives
the row exchange, the world size and the capture mode. A program of a
mesh with a process group is captured in the ``'thread_local'`` error
mode: NCCL's watchdog thread queries the events of earlier collectives
on its own schedule, and in the default ``'global'`` mode such a query
from another thread during a capture is an error whenever the two meet
(a race no run can rule out by passing); the capturing thread's own
calls are checked in either mode. ``Captured.collectives`` counts the
collectives a capture issued (for the graph audit). Such a program is
registered with the mesh at its capture (``parallel.mesh.register``), and
``parallel.mesh.shutdown`` releases it (``Captured.release``) before the
process leaves the group: a run after that raises.

The host part is traced (``gltvae_torch.trace``): its draws as a
``host.draw`` span, its fills as ``host.fill``, the replay and the
outputs' clone as ``graph.replay`` and ``graph.outputs``, and a capture,
warm-up runs included, as the set-up span ``graph.capture``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gltvae_torch import trace
from gltvae_torch.ops import preprocess
from gltvae_torch.parallel import mesh as _mesh
from gltvae_torch.train.state import TrainState, next_alpha, step_seed

#: Device-part runs before a capture.
WARMUP_STEPS = 2


def _cuda_capture(fn: Callable[[], Dict[str, torch.Tensor]], pool,
                  error_mode: str = 'global'):
    """(graph, outputs): `fn` captured on the current CUDA device into a
    memory pool shared with the other programs of its maker, in
    `error_mode` (``torch.cuda.graph``'s ``capture_error_mode``)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode=error_mode):
        out = fn()
    return graph, out


def graph_capture(device: torch.device) -> Optional[Callable]:
    """How programs on `device` are captured: CUDA graphs on a CUDA
    device, nothing (the static-buffer path run eagerly) on the CPU."""
    return _cuda_capture if device.type == 'cuda' else None


def graph_pool(device: torch.device):
    """A graph memory pool for the programs of one maker (None on the
    CPU)."""
    return torch.cuda.graph_pool_handle() if device.type == 'cuda' else None


def _state_tensors(state: TrainState):
    return (list(state.model.parameters()) + list(state.adam_m.values())
            + list(state.adam_v.values()))


@dataclasses.dataclass(frozen=True)
class Crop:
    """A train step's augment stage (``TrainConfig.augment_pad`` > 0): a
    uint8 batch padded to size + 2·pad is cropped back to size x size at a
    drawn offset, flipped by a drawn coin and scaled by 1/255 (the augment
    kernel). The draws of global step s come from a generator seeded
    ``step_seed(seed + 2, s)``, so they depend neither on the dispatch nor
    on ``steps_per_dispatch``. On a mesh (rank `rank` of `world`) they are
    the global batch's draws, of which the rank keeps its rows, so the
    crops depend on the world size neither."""
    size: int
    pad: int
    seed: int
    rank: int = 0
    world: int = 1

    def takes(self, shape: Sequence[int], dtype: torch.dtype) -> bool:
        """Whether a batch of (shape, dtype) is a padded train batch."""
        edge = self.size + 2 * self.pad
        return dtype == torch.uint8 and tuple(shape[-3:-1]) == (edge, edge)

    def draw(self, step: int, b: int, device: torch.device,
             out: Optional[Tuple[torch.Tensor, ...]] = None):
        """(dy, dx, fl), int32 [b] each, for global step `step`: this
        rank's b rows of the global batch's (written into `out` when
        given)."""
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(self.seed + 2, step))
        edge = self.size + 2 * self.pad
        if self.world == 1:
            return preprocess.draw_crop_flip(g, b, edge, edge, self.size,
                                             out=out)
        rows = slice(self.rank * b, (self.rank + 1) * b)
        draws = preprocess.draw_crop_flip(g, b * self.world, edge, edge,
                                          self.size)
        if out is None:
            return tuple(d[rows].contiguous() for d in draws)
        for o, d in zip(out, draws):
            o.copy_(d[rows])
        return out


def index_rows(sources, idxs) -> List[tuple]:
    """(x, y) of step or batch j: rows idxs[j] of sources[j] = (images,
    labels or None), gathered on the device (the one-device row gather of
    a resident program; a mesh's exchanges rows, ``steps.py``)."""
    return [(images.index_select(0, i),
             None if labels is None else labels.index_select(0, i))
            for (images, labels), i in zip(sources, idxs)]


def _clone(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in out.items()}


class Captured:
    """One device part at one key, with its static inputs (see the module
    docstring). A subclass defines ``_run(owner)`` -> a dict of device
    tensors, made from its static inputs, and ``writes`` (whether the run
    updates the owner, a TrainState, in place).

    `owner` is what the device part reads beside its static inputs: the
    TrainState of a train program, the model of an eval pass. A graph
    reads the tensors it was captured with, so a captured program runs
    only its own owner, and another raises (``check``). Where nothing is
    captured (the CPU) any owner runs."""

    writes = False
    #: what the owner is called in ``check``'s message
    owner_kind = 'state'
    #: the key its maker files it under (the capture span's attribute)
    key = None

    def __init__(self, device: torch.device, pool=None, dp=None):
        self.device = torch.device(device)
        self.pool = pool
        #: the mesh (``parallel.dp.DataParallel``; None on one device)
        self.dp = dp
        self.world = 1 if dp is None else dp.mesh.world
        #: the resident row gather: one device's, or the mesh's exchange
        self.row_gather = index_rows if dp is None else dp.step_batches
        capture = graph_capture(self.device)
        if capture is not None and dp is not None \
                and dp.mesh.group is not None:  # see the module docstring
            capture = functools.partial(capture, error_mode='thread_local')
        self.capture = capture
        self.graph = None
        #: the owner the graph was captured on
        self.owner = None
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        #: kernel launches one replay makes (counted at the capture)
        self.dequant_launches = 0
        self.augment_launches = 0
        #: collectives one replay makes (counted at the capture)
        self.collectives = 0
        #: set by ``release``: the graph is gone and a run raises
        self.released = False

    def buffer(self, shape, dtype) -> torch.Tensor:
        """A static input of `shape` and `dtype` on the program's
        device."""
        return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def _run(self, owner) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def batches(self) -> List[torch.Tensor]:
        """The uint8 batches the next run reads, as its static inputs hold
        them (a resident program's rows gathered from its split by its
        static indices, as its graph gathers them)."""
        raise NotImplementedError

    def check(self, owner) -> None:
        """Raise unless `owner` is the one this program was captured on
        (or nothing is captured yet), and if the program was released."""
        if self.released:
            raise RuntimeError(
                f'a captured program was run after this process left its '
                f'process group: leaving it released the program\'s graph, '
                f'which held the group\'s collectives; make the steps anew '
                f'in a new group')
        if self.graph is not None and owner is not self.owner:
            raise ValueError(
                f'a captured program was called with another '
                f'{self.owner_kind} than the one it was captured on: its '
                f'graph reads that {self.owner_kind}\'s tensors; make the '
                f'steps anew for each {self.owner_kind}')

    @torch.no_grad()
    def warm_up(self, owner) -> None:
        """Run the device part WARMUP_STEPS times on the static inputs;
        a train program then puts back the params, moments, step and count
        it found."""
        if not self.writes:
            for _ in range(WARMUP_STEPS):
                self._run(owner)
            return
        state = owner
        step, count = state.step, state.adam_count
        tensors = _state_tensors(state)
        saved = [t.detach().clone() for t in tensors]
        try:
            with torch.enable_grad():
                for _ in range(WARMUP_STEPS):
                    self._run(state)
        finally:
            for t, s in zip(tensors, saved):
                t.copy_(s)
            state.step, state.adam_count = step, count

    def _capture(self, owner) -> None:
        with trace.setup_span('graph.capture', kind=type(self).__name__,
                              key=str(self.key)):
            self._warm_up_and_capture(owner)

    def _warm_up_and_capture(self, owner) -> None:
        counts = preprocess.launches, preprocess.augment_launches
        if self.device.type == 'cuda':
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.warm_up(owner)
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self.warm_up(owner)
        warm = (preprocess.launches, preprocess.augment_launches,
                _mesh.collectives)
        grad = torch.enable_grad() if self.writes else torch.no_grad()

        def run():
            with grad:
                return self._run(owner)
        self.graph, self.outputs = self.capture(run, self.pool)
        self.owner = owner
        self.dequant_launches = preprocess.launches - warm[0]
        self.augment_launches = preprocess.augment_launches - warm[1]
        self.collectives = _mesh.collectives - warm[2]
        preprocess.launches, preprocess.augment_launches = counts
        if self.dp is not None and self.dp.mesh.group is not None:
            _mesh.register(self)

    def release(self) -> None:
        """Reset and drop the graph, its outputs and its pool, and mark the
        program released, so that a later run raises (``check``):
        ``parallel.mesh.shutdown`` does this to every program captured
        with the group's collectives before it leaves the group."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.outputs = self.pool = None
        self.released = True

    def __call__(self, owner) -> Dict[str, torch.Tensor]:
        """One run on the static inputs: replayed where captured (captured
        at the first call), else run eagerly. Returns the outputs as new
        tensors. A captured program raises for another owner than its
        own, and a released one always."""
        self.check(owner)
        if self.capture is None:
            grad = torch.enable_grad() if self.writes else torch.no_grad()
            with grad:
                return _clone(self._run(owner))
        if self.graph is None:
            self._capture(owner)
        with trace.span('graph.replay'):
            self.graph.replay()
        preprocess.launches += self.dequant_launches
        preprocess.augment_launches += self.augment_launches
        with trace.span('graph.outputs'):
            return _clone(self.outputs)


def noise_form(noise: dict) -> str:
    """The form of a dispatch's noise, which picks its captured program:
    'uniform' (the gate uniforms u1, u2) or 'gumbel' (the Gumbels g1, g2)."""
    return 'uniform' if 'u1' in noise else 'gumbel'


class _Noise:
    """Static noise buffers: a dict of tensors per slot (a step or a
    batch), made at the first fill from the first draws."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * slots

    def out(self, j: int) -> Optional[Dict[str, torch.Tensor]]:
        """Slot j's buffers to draw into (None before its first fill)."""
        return self.slots[j]

    def fill(self, j: int, noise: Dict[str, torch.Tensor]) -> None:
        """Copy draws into slot j (made at its first fill); draws made
        into the slot's own buffers are left as they are."""
        buf = self.slots[j]
        if buf is None:
            buf = self.slots[j] = {k: torch.empty(v.shape, dtype=v.dtype,
                                                  device=self.device)
                                   for k, v in noise.items()}
        if noise.keys() != buf.keys():
            raise ValueError(f'noise {sorted(noise)} for a step captured '
                             f'with {sorted(buf)}')
        for k, v in noise.items():
            if v.shape != buf[k].shape:
                raise ValueError(f'noise {k} of shape {tuple(v.shape)} for '
                                 f'a step captured at '
                                 f'{tuple(buf[k].shape)}')
            if v is not buf[k]:
                buf[k].copy_(v)


class CapturedStep(Captured):
    """One train step kind at one input shape and dtype.

    `device_part` is ``(state, x, y, gating_temp, alpha, noise) ->
    metrics`` (train/steps.py): it updates the state's params and moments
    in place and returns 0-d device tensors. `x` and `y` are the static
    inputs' (shape, dtype); with `crop` (a padded uint8 batch) the device
    part first crops x through the augment kernel from the static offsets
    ``crop_draws``. `pool` is the CUDA graph memory pool the captures of
    one maker share; `dp` the mesh whose collectives the device part
    holds."""

    writes = True

    def __init__(self, device_part: Callable, x: tuple, y: tuple,
                 device: torch.device, pool=None,
                 crop: Optional[Crop] = None, dp=None):
        super().__init__(device, pool, dp)
        self.device_part = device_part
        self.x = self.buffer(*x)
        self.y = self.buffer(*y)
        self.temp = self.buffer((), torch.float32).zero_()
        self.alpha = self.buffer((), torch.float32).zero_()
        self._noise = _Noise(self.device, 1)
        self.crop = crop
        b = x[0][0]
        self.crop_draws = (tuple(self.buffer((b,), torch.int32)
                                 for _ in range(3)) if crop else None)

    @property
    def noise(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._noise.out(0)

    @property
    def metrics(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.outputs

    # ----------------------------- inputs -----------------------------
    def load(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """Copy a batch into the static inputs."""
        self.x.copy_(x)
        self.y.copy_(y)

    def gather(self, images: torch.Tensor, labels: torch.Tensor,
               idx: torch.Tensor) -> None:
        """Gather rows `idx` of a device-resident split into the static
        inputs (one launch each)."""
        torch.index_select(images, 0, idx, out=self.x)
        torch.index_select(labels, 0, idx, out=self.y)

    def set_noise(self, noise: Dict[str, torch.Tensor]) -> None:
        """Copy the step's draws into the static noise buffers (made at the
        first call, from the first draws)."""
        self._noise.fill(0, noise)

    def batches(self) -> List[torch.Tensor]:
        return [self.x] if self.x.dtype == torch.uint8 else []

    # ------------------------------ runs ------------------------------
    def _run(self, state: TrainState) -> Dict[str, torch.Tensor]:
        x = self.x
        if self.crop is not None:
            x = preprocess.fused_augment_given(x, *self.crop_draws,
                                               self.crop.size)
        return self.device_part(state, x, self.y, self.temp, self.alpha,
                                self.noise)


class JitStep:
    """A step kind of ``make_train_steps(jit=True)``: ``(state, x, y,
    gating_temp, noise=None) -> (state, metrics)`` as the plain step, run
    by a ``CapturedStep`` for each (x, y) shape and dtype. ``gathered``
    takes the batch as rows of a device-resident split instead.

    `host` is the host part, ``(state, b, noise, out=None) -> noise``:
    the step's draws at ``state.step`` (`noise` when given), drawn into
    `out` (a slot of static buffers) when given; ``host.form`` is the form
    of its draws, 'uniform' (the gate uniforms, which the device part
    turns into Gumbels) or 'gumbel' (an injected draw's), and given noise
    has its own (``noise_form``). Each form has its own
    CapturedStep.
    `lr` is the Adam learning rate, `device` the model's, where the static
    inputs live; `crop` the augment stage of padded batches (None without
    augmentation). On a mesh, `dp` (``parallel.dp.DataParallel``), x and
    y are this rank's rows; ``gathered`` is one device's.

    Unlike gltvae's jitted step, which is pure, a captured step is bound
    to the state it was captured on, and another state raises
    (``Captured.check``) before anything of it is touched."""

    def __init__(self, device_part: Callable, host: Callable, lr: float,
                 device: torch.device, pool=None,
                 crop: Optional[Crop] = None, dp=None):
        self.device_part = device_part
        self.host = host
        self.lr = lr
        self.device = device
        self.pool = pool
        self.crop = crop
        self.dp = dp
        self.steps: Dict[tuple, CapturedStep] = {}

    def captured(self, x: tuple, y: tuple,
                 form: Optional[str] = None) -> CapturedStep:
        """The CapturedStep of one input (shape, dtype) pair and noise
        form (by default the host's own; made on first use)."""
        form = form or self.host.form
        step = self.steps.get((x, y, form))
        if step is None:
            crop = (self.crop if self.crop is not None
                    and self.crop.takes(*x) else None)
            step = self.steps[(x, y, form)] = CapturedStep(
                self.device_part, x, y, self.device, self.pool, crop,
                self.dp)
            step.key = (x, y, form)
        return step

    def _run(self, step: CapturedStep, state: TrainState, gating_temp,
             noise):
        step.check(state)       # before the host part touches the state
        b = step.x.shape[0]
        with trace.span('host.draw'):
            step.set_noise(self.host(state, b, noise, out=step.noise))
        with trace.span('host.fill'):
            if step.crop is not None:
                step.crop.draw(state.step, b, self.device,
                               out=step.crop_draws)
            step.temp.fill_(gating_temp)
            next_alpha(state, self.lr, out=step.alpha)
        metrics = step(state)
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, x, y, gating_temp,
                 noise: Optional[dict] = None):
        step = self.captured((tuple(x.shape), x.dtype),
                             (tuple(y.shape), y.dtype),
                             None if noise is None else noise_form(noise))
        step.load(x, y)
        return self._run(step, state, gating_temp, noise)

    def gathered(self, state: TrainState, images, labels, idx, gating_temp):
        """The step on rows `idx` of a resident split, gathered into the
        static inputs."""
        n = len(idx)
        step = self.captured(((n,) + tuple(images.shape[1:]), images.dtype),
                             ((n,) + tuple(labels.shape[1:]), labels.dtype))
        step.gather(images, labels, idx)
        return self._run(step, state, gating_temp, None)


class CapturedChunk(Captured):
    """n train steps in one program: step j runs the sup device part where
    ``mask[j]``, else the unsup one, in order, each with its own static
    noise and ``alpha[j]`` and the one static temperature. Its batches are
    a shipped stacked batch (static ``xs`` [n, B, ...], ``ys``; a padded
    one cropped by one augment launch over n·B images) or rows of
    resident splits, ``sources[j]`` = (images, labels) of step j,
    gathered inside the graph from the static ``idxs`` [n, B] (on a mesh,
    `dp`, by the row exchange: B is the global batch and each step this
    rank's B/world rows).

    The metrics come out stacked [n]. Autograd frees step j's activations
    before step j + 1 runs, so the graph's pool reuses them."""

    writes = True

    def __init__(self, parts: Dict[bool, Callable], mask: Tuple[bool, ...],
                 x: tuple, y: tuple, device: torch.device, pool=None,
                 crop: Optional[Crop] = None, sources=None, dp=None):
        super().__init__(device, pool, dp)
        self.parts = parts
        self.mask = mask
        n = len(mask)
        self.sources = sources
        if sources is None:
            self.xs, self.ys = self.buffer(*x), self.buffer(*y)
            self.idxs = None
            self.batch = b = x[0][1]
        else:
            self.xs = self.ys = None
            self.idxs = self.buffer(*x)
            self.batch = b = x[0][1] // self.world  # this rank's rows
        self.temp = self.buffer((), torch.float32).zero_()
        self.alpha = self.buffer((n,), torch.float32).zero_()
        self.noise = _Noise(self.device, n)
        self.crop = crop
        self.crop_draws = (tuple(self.buffer((n, b), torch.int32)
                                 for _ in range(3)) if crop else None)

    def load(self, xs: torch.Tensor, ys: torch.Tensor) -> None:
        """Copy a stacked batch into the static inputs."""
        self.xs.copy_(xs)
        self.ys.copy_(ys)

    def set_rows(self, idxs: torch.Tensor) -> None:
        """Copy the chunk's [n, B] row indices into the static input."""
        self.idxs.copy_(idxs)

    def batches(self) -> List[torch.Tensor]:
        if self.sources is not None:
            return [x for x, _ in self.row_gather(self.sources, self.idxs)]
        return list(self.xs) if self.xs.dtype == torch.uint8 else []

    def _run(self, state: TrainState) -> Dict[str, torch.Tensor]:
        if self.sources is not None:
            batches = self.row_gather(self.sources, self.idxs)
        else:
            xs = self.xs
            if self.crop is not None:
                xs = preprocess.fused_augment_stacked_given(
                    xs, *self.crop_draws, self.crop.size)
            batches = list(zip(xs, self.ys))
        mets = []
        for j, (m, (x, y)) in enumerate(zip(self.mask, batches)):
            mets.append(self.parts[m](state, x, y, self.temp, self.alpha[j],
                                      self.noise.out(j)))
        return {k: torch.stack([m[k] for m in mets]) for k in mets[0]}


class JitChunk:
    """The chunk of ``make_mixed_scan_train_step(jit=True)`` and the
    resident chunk makers: n steps of the JitSteps `sup` and `unsup` as
    one ``CapturedChunk`` replay, one graph per mask pattern, input shapes
    and dtypes, source (shipped, or the resident splits by identity) and
    noise form (the steps' ``host.form``), sharing the steps' graph
    pool.

    Its host part makes what n single steps would: step j's noise from
    ``state.next_generator()`` at ``state.step`` = step0 + j, then each
    step's augment offsets and its ``alpha[j]`` (the Adam count advanced a
    step at a time); then it replays once. The result equals n single
    steps bit for bit."""

    def __init__(self, sup: JitStep, unsup: JitStep):
        self.kinds = {True: sup, False: unsup}
        self.lr, self.device, self.pool = sup.lr, sup.device, sup.pool
        self.crop, self.dp = sup.crop, sup.dp
        self.chunks: Dict[tuple, CapturedChunk] = {}

    def captured(self, mask: Tuple[bool, ...], x: tuple, y: tuple,
                 sources=None) -> CapturedChunk:
        """The CapturedChunk of one mask pattern, input (shape, dtype)
        pair, source and the steps' noise form (made on first use)."""
        src = (None if sources is None else
               tuple((id(a), id(b)) for a, b in sources))
        key = (mask, x, y, src, self.kinds[True].host.form)
        chunk = self.chunks.get(key)
        if chunk is None:
            crop = (self.crop if self.crop is not None and sources is None
                    and self.crop.takes(*x) else None)
            chunk = self.chunks[key] = CapturedChunk(
                {k: s.device_part for k, s in self.kinds.items()}, mask, x,
                y, self.device, self.pool, crop, sources, self.dp)
            chunk.key = key
        return chunk

    def _run(self, chunk: CapturedChunk, state: TrainState, gating_temp):
        chunk.check(state)      # before the host part touches the state
        b, step0 = chunk.batch, state.step
        # each step's noise, crops and alpha come from streams of their own
        # (its generator, its crop generator, the Adam count), so drawing
        # every noise first leaves each value as the steps in turn make it
        try:
            with trace.span('host.draw'):
                for j, m in enumerate(chunk.mask):
                    state.step = step0 + j      # the step's own draws
                    chunk.noise.fill(j, self.kinds[m].host(
                        state, b, None, out=chunk.noise.out(j)))
        finally:
            state.step = step0
        with trace.span('host.fill'):
            for j in range(len(chunk.mask)):
                if chunk.crop is not None:
                    chunk.crop.draw(step0 + j, b, self.device, out=tuple(
                        d[j] for d in chunk.crop_draws))
                next_alpha(state, self.lr, out=chunk.alpha[j])
            chunk.temp.fill_(gating_temp)
        metrics = chunk(state)
        state.step = step0 + len(chunk.mask)
        return state, metrics

    def __call__(self, state: TrainState, xs, ys, sup_mask, gating_temp):
        """(state, xs [n, B, ...], ys [n, B, y], sup_mask [n],
        gating_temp) -> (state, metrics [n])."""
        mask = tuple(bool(m) for m in sup_mask)
        if not len(xs) == len(ys) == len(mask):
            raise ValueError(f'chunk of {len(xs)} batches, {len(ys)} label '
                             f'batches and {len(mask)} flags')
        chunk = self.captured(mask, (tuple(xs.shape), xs.dtype),
                              (tuple(ys.shape), ys.dtype))
        chunk.load(xs, ys)
        return self._run(chunk, state, gating_temp)

    def gathered(self, state: TrainState, sources, idxs, sup_mask,
                 gating_temp):
        """The chunk on rows idxs[j] of sources[j] (images, labels), the
        resident split(s) of each step, gathered inside the graph."""
        mask = tuple(bool(m) for m in sup_mask)
        if len(idxs) != len(mask):
            raise ValueError(f'{len(idxs)} index rows and {len(mask)} '
                             'flags')
        chunk = self.captured(mask, (tuple(idxs.shape), idxs.dtype),
                              None, tuple(sources))
        chunk.set_rows(idxs)
        return self._run(chunk, state, gating_temp)


class CapturedPass(Captured):
    """An eval or ELBO pass of n batches in one program: ``fn(model, x, y,
    noise_j)`` -> a value for batch j (0-d, or inference's [B, y]),
    stacked to [n, ...] (``value``). Batch j is ``xs[j]`` (with
    ``ys[j]``) of a static stacked batch, or rows ``idxs[j]`` of a
    resident split ``source`` = (images, labels or None), gathered inside
    the graph (on a mesh, `dp`, by the row exchange). The noise of batch
    j is slot j of ``noise`` (None for a deterministic pass), drawn for
    ``batch`` rows: the global batch's on a mesh, where `fn` reads this
    rank's; the temperature is static. The model's
    parameters are read in place; nothing is written back."""

    owner_kind = 'model'

    def __init__(self, fn: Callable, n: int, x: tuple, y: Optional[tuple],
                 device: torch.device, pool=None, source=None,
                 stochastic: bool = True, dp=None):
        super().__init__(device, pool, dp)
        self.fn = fn
        self.n = n
        self.source = source
        if source is None:
            self.xs = self.buffer(*x)
            self.ys = None if y is None else self.buffer(*y)
            self.idxs = None
        else:
            self.xs = self.ys = None
            self.idxs = self.buffer(*x)
        #: the rows a batch's draws cover: a shipped batch is this
        #: rank's rows, a resident one's indices the global batch's
        self.batch = x[0][1] * (self.world if source is None else 1)
        self.temp = self.buffer((), torch.float32).zero_()
        self.noise = _Noise(self.device, n) if stochastic else None

    def load(self, xs: torch.Tensor, ys: Optional[torch.Tensor]) -> None:
        """Copy stacked batches into the static inputs."""
        self.xs.copy_(xs)
        if self.ys is not None:
            self.ys.copy_(ys)

    def set_rows(self, idxs: torch.Tensor) -> None:
        """Copy the pass's [n, B] row indices into the static input."""
        self.idxs.copy_(idxs)

    def batches(self) -> List[torch.Tensor]:
        if self.source is not None:
            return [x for x, _ in self.row_gather([self.source] * self.n,
                                                  self.idxs)]
        return list(self.xs) if self.xs.dtype == torch.uint8 else []

    def _run(self, model) -> Dict[str, torch.Tensor]:
        if self.source is not None:
            batches = self.row_gather([self.source] * self.n, self.idxs)
        else:
            batches = [(self.xs[j], None if self.ys is None else self.ys[j])
                       for j in range(self.n)]
        vals = []
        for j, (x, y) in enumerate(batches):
            noise = None if self.noise is None else self.noise.out(j)
            vals.append(self.fn(model, x, y, self.temp, noise))
        return {'value': torch.stack(vals)}


class JitPass:
    """An eval or ELBO maker with ``jit``: its passes run as
    ``CapturedPass`` replays, one graph per form ('batch', 'stacked',
    'resident'), n, batch shape and dtype, and resident split (by
    identity), sharing one graph pool.

    `fn` is the device part of one batch, ``(model, x, y, temp, noise) ->
    0-d``; `draw` the host part of one batch, ``(model, b, generator,
    out=None) -> noise`` (None for a deterministic pass, which draws
    nothing), whose ``form`` picks the pass's graph as ``JitStep``'s host
    does.
    The host part draws the n batches' noise from the one eval generator,
    batch by batch, straight into the static buffers: the generator ends
    where the eager pass leaves it, and the draws equal its draws. On a
    mesh, `dp`, a shipped batch is this rank's rows and b the global
    batch's."""

    def __init__(self, model, fn: Callable, draw: Optional[Callable],
                 dp=None):
        self.model = model
        self.fn = fn
        self.draw = draw
        self.dp = dp
        self.device = model.mu.device
        self.pool = graph_pool(self.device)
        self.passes: Dict[tuple, CapturedPass] = {}

    def captured(self, form: str, n: int, x: tuple, y: Optional[tuple],
                 source=None) -> CapturedPass:
        src = None if source is None else tuple(
            None if t is None else id(t) for t in source)
        key = (form, n, x, y, src, self.draw and self.draw.form)
        p = self.passes.get(key)
        if p is None:
            p = self.passes[key] = CapturedPass(
                self.fn, n, x, y, self.device, self.pool, source,
                stochastic=self.draw is not None, dp=self.dp)
            p.key = key
        return p

    def run(self, p: CapturedPass, model, generator, gating_temp):
        """The host part and one run of `p`: values [n] as new tensors."""
        p.check(model)          # before the generator is touched
        if self.draw is not None:
            with trace.span('host.draw'):
                for j in range(p.n):
                    p.noise.fill(j, self.draw(model, p.batch, generator,
                                              p.noise.out(j)))
        with trace.span('host.fill'):
            p.temp.fill_(gating_temp)
        return p(model)['value']

    def stacked(self, model, xs, ys, generator, gating_temp,
                form: str = 'stacked'):
        """Values [n] over stacked batches xs [n, B, ...] (ys [n, B, y]
        or None)."""
        p = self.captured(form, len(xs), (tuple(xs.shape), xs.dtype),
                          None if ys is None else (tuple(ys.shape),
                                                   ys.dtype))
        p.load(xs, ys)
        return self.run(p, model, generator, gating_temp)

    def resident(self, model, images, labels, idxs, generator, gating_temp):
        """Values [n] over rows idxs [n, B] of a resident split (labels
        None for an ELBO pass), gathered inside the graph."""
        p = self.captured('resident', len(idxs),
                          (tuple(idxs.shape), idxs.dtype), None,
                          (images, labels))
        p.set_rows(idxs)
        return self.run(p, model, generator, gating_temp)
