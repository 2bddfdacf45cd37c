"""Captured train steps: the counterpart of gltvae's
``jax.jit(step, donate_argnums=(0,))`` (gltvae/train/steps.py).

In gltvae a train step is one compiled XLA program and the train state is
donated, so it is updated in place. Here a step is split in two:

- the host part (train/steps.py): the step's noise, drawn eagerly from its
  per-step generator; the Adam count and its ``alpha``; ``state.step``;
- the device part: the input stage (the dequant kernel), the loss,
  ``torch.autograd.grad``, Keras Adam in place and the metrics. It reads
  nothing back to the host, so on a CUDA device it is captured once as a
  CUDA graph and replayed every step.

``CapturedStep`` holds one step kind at one input shape and dtype. It owns
static inputs (x, y, the gating temperature, alpha and the noise), which
each call fills before the replay, so every value that changes from step
to step reaches the graph through memory and none is baked into it. The
params and the Adam moments are the state's own tensors, updated in place
by the graph, so whatever replaces them must write into them
(``TrainState.load_state_dict`` and ``Trainer.load_params`` do). The
metrics are cloned out after each replay: the next replay overwrites the
graph's own outputs.

Before its capture a step warms up on a side stream (the lazy set-up of
cuBLAS, cuDNN, the autograd engine and the kernels' builds happens there,
not under capture) with the params, moments, step and count saved before
and put back after, so the first real step starts where the eager step
would. A capture or replay error raises: nothing falls back to the eager
step. On the CPU there is nothing to capture, and the same static-buffer
path runs eagerly.

The dequant kernel's launch count (``ops.preprocess.launches``) follows
the replays: a replay launches the kernel without calling its wrapper, so
each replay adds the launches the capture recorded. The warm-up's
launches are left out, as a launch made to compare a kernel with its
plain version is: the state they produced is put back.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from gltvae_torch.ops import preprocess
from gltvae_torch.train.state import TrainState, next_alpha

#: Device-part runs before a capture.
WARMUP_STEPS = 2


def _cuda_capture(fn: Callable[[], Dict[str, torch.Tensor]], pool):
    """(graph, outputs): `fn` captured on the current CUDA device into a
    memory pool shared with the other steps of its maker."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


def graph_capture(device: torch.device) -> Optional[Callable]:
    """How steps on `device` are captured: CUDA graphs on a CUDA device,
    nothing (the static-buffer path run eagerly) on the CPU."""
    return _cuda_capture if device.type == 'cuda' else None


def _state_tensors(state: TrainState):
    return (list(state.model.parameters()) + list(state.adam_m.values())
            + list(state.adam_v.values()))


class CapturedStep:
    """One train step kind at one input shape and dtype.

    `device_part` is ``(state, x, y, gating_temp, alpha, noise) -> metrics``
    (train/steps.py): it updates the state's params and moments in place
    and returns 0-d device tensors. `x` and `y` are the static inputs'
    (shape, dtype); `pool` is the CUDA graph memory pool the captures of
    one maker share.

    A graph reads and writes the tensors it was captured with, so a
    captured step runs only the state it was captured on: another state
    raises (``check``). Where nothing is captured (the CPU) any state
    runs."""

    def __init__(self, device_part: Callable, x: tuple, y: tuple,
                 device: torch.device, pool=None):
        dev = torch.device(device)
        self.device_part = device_part
        self.x = torch.empty(x[0], dtype=x[1], device=dev)
        self.y = torch.empty(y[0], dtype=y[1], device=dev)
        self.temp = torch.zeros((), dtype=torch.float32, device=dev)
        self.alpha = torch.zeros((), dtype=torch.float32, device=dev)
        self.noise: Optional[Dict[str, torch.Tensor]] = None
        self.pool = pool
        self.capture = graph_capture(dev)
        self.graph = None
        #: the state the graph was captured on
        self.state: Optional[TrainState] = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        #: dequant launches one replay makes (counted at the capture)
        self.dequant_launches = 0

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
        if self.noise is None:
            self.noise = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.x.device)
                          for k, v in noise.items()}
        if noise.keys() != self.noise.keys():
            raise ValueError(f'noise {sorted(noise)} for a step captured '
                             f'with {sorted(self.noise)}')
        for k, v in noise.items():
            if v.shape != self.noise[k].shape:
                raise ValueError(f'noise {k} of shape {tuple(v.shape)} for a '
                                 f'step captured at '
                                 f'{tuple(self.noise[k].shape)}')
            self.noise[k].copy_(v)

    # ------------------------------ runs ------------------------------
    def _run(self, state: TrainState) -> Dict[str, torch.Tensor]:
        return self.device_part(state, self.x, self.y, self.temp, self.alpha,
                                self.noise)

    def check(self, state: TrainState) -> None:
        """Raise unless `state` is the state this step was captured on
        (or nothing is captured yet)."""
        if self.graph is not None and state is not self.state:
            raise ValueError(
                'a captured step was called with another state than the '
                'one it was captured on: its graph updates that state\'s '
                'tensors; make the steps anew for each state')

    @torch.no_grad()
    def warm_up(self, state: TrainState) -> None:
        """Run the device part WARMUP_STEPS times on the static inputs,
        then put back the params, moments, step and count it found."""
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

    def _capture(self, state: TrainState) -> None:
        launches = preprocess.launches
        if self.x.device.type == 'cuda':
            side = torch.cuda.Stream(self.x.device)
            side.wait_stream(torch.cuda.current_stream(self.x.device))
            with torch.cuda.stream(side):
                self.warm_up(state)
            torch.cuda.current_stream(self.x.device).wait_stream(side)
        else:
            self.warm_up(state)
        warm = preprocess.launches
        self.graph, self.metrics = self.capture(lambda: self._run(state),
                                                self.pool)
        self.state = state
        self.dequant_launches = preprocess.launches - warm
        preprocess.launches = launches

    def __call__(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """One step on the static inputs: replayed where captured (captured
        at the first call), else run eagerly. Returns the metrics as new
        tensors. A captured step raises for another state than its own."""
        self.check(state)
        if self.capture is None:
            metrics = self._run(state)
        else:
            if self.graph is None:
                self._capture(state)
            self.graph.replay()
            preprocess.launches += self.dequant_launches
            metrics = self.metrics
        return {k: v.clone() for k, v in metrics.items()}


class JitStep:
    """A step kind of ``make_train_steps(jit=True)``: ``(state, x, y,
    gating_temp, noise=None) -> (state, metrics)`` as the plain step, run
    by a ``CapturedStep`` for each (x, y) shape and dtype. ``gathered``
    takes the batch as rows of a device-resident split instead.

    `host` is the host part, ``(state, batch, noise) -> noise``: the step's
    draws (`noise` when given). `lr` is the Adam learning rate, `device`
    the model's, where the static inputs live.

    Unlike gltvae's jitted step, which is pure, a captured step is bound
    to the state it was captured on, and another state raises
    (``CapturedStep.check``) before anything of it is touched."""

    def __init__(self, device_part: Callable, host: Callable, lr: float,
                 device: torch.device, pool=None):
        self.device_part = device_part
        self.host = host
        self.lr = lr
        self.device = device
        self.pool = pool
        self.steps: Dict[tuple, CapturedStep] = {}

    def captured(self, x: tuple, y: tuple) -> CapturedStep:
        """The CapturedStep of one input (shape, dtype) pair (made on
        first use)."""
        step = self.steps.get((x, y))
        if step is None:
            step = self.steps[(x, y)] = CapturedStep(
                self.device_part, x, y, self.device, self.pool)
        return step

    def _run(self, step: CapturedStep, state: TrainState, gating_temp,
             noise):
        step.check(state)       # before the host part touches the state
        step.set_noise(self.host(state, step.x.shape[0], noise))
        step.temp.fill_(gating_temp)
        next_alpha(state, self.lr, out=step.alpha)
        metrics = step(state)
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, x, y, gating_temp,
                 noise: Optional[dict] = None):
        step = self.captured((tuple(x.shape), x.dtype),
                             (tuple(y.shape), y.dtype))
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
