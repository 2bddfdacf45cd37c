"""One process's training run of a cell: the program built, driven from
the seed through its warm-up epoch (whose first steps the reference
follows), whole epochs timed, a traced segment, then its readout.

A mesh rank runs the same with ``mesh`` given; rank 0 decides when the
window closes and broadcasts it, so every rank runs the same epochs.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

import harness as H
from reference import streams as S

#: train steps the reference follows (whole dispatches, at least this)
CHECK_STEPS = 3


class TrainSession:
    def __init__(self, cell: H.Cell, seed: int, device, tmp: str,
                 mesh=None):
        self.cell, self.seed, self.mesh = cell, seed, mesh
        self.cuda = torch.device(device).type == 'cuda'
        self.splits = H.make_splits(cell, seed, device)
        H.reset_peak(device)
        self.trainer, self.loaders = H.build_program(
            cell, self.splits, seed, device, tmp, mesh)
        self.meter = H.meter_class()(self.cuda)
        self.trainer.throughput = self.meter
        self.batch = cell.train['batch_size']
        t = self.cell.train
        flags = S.schedule(len(self.splits['sup'][0]),
                           len(self.splits['unsup'][0]), self.batch,
                           t['perc_supervision'])
        self.epoch_steps = (sum(flags), len(flags) - sum(flags))
        self.readout = None

    # ------------------------------ warm-up ------------------------------
    def warm_up(self) -> None:
        """One epoch through the window's own call, which captures every
        graph the window replays; Adam's moments are kept after the first
        dispatch and the parameters once CHECK_STEPS steps are done."""
        st = self.trainer.state
        p0 = {n: p.detach().clone() for n, p in st.trainable().items()}
        snap = {}

        def hook(meter):
            steps = meter.images // self.batch
            if 'm' not in snap:
                snap['m'] = {n: v.detach().clone()
                             for n, v in st.adam_m.items()}
                snap['first'] = steps
            if steps >= CHECK_STEPS and 'p' not in snap:
                snap['p'] = {n: p.detach().clone()
                             for n, p in st.trainable().items()}
                snap['steps'] = steps
                self.meter.hooks.remove(hook)
        self.meter.hooks.append(hook)
        self.trainer.train(self.loaders, epochs=1, log_every=1)
        rows = self.trainer.metrics.rows
        H.sync(self.cuda)
        losses = {int(r['step']): r['loss'] for r in rows
                  if int(r['step']) < snap['steps']}
        self.readout = {
            'first': snap['first'], 'steps': snap['steps'],
            'losses': [losses[i] for i in range(snap['steps'])],
            'm': snap['m'], 'delta': {n: snap['p'][n] - p0[n] for n in p0}}

    # ------------------------------ window ------------------------------
    def _go_on(self, t0: float, seconds: float) -> bool:
        more = time.perf_counter() - t0 < seconds
        if self.mesh is None or self.mesh.group is None:
            return more
        flag = torch.tensor([1.0 if more else 0.0], device=self.mesh.device)
        self.mesh.broadcast_(flag, 0)
        return bool(flag.item() > 0)

    def window(self, seconds: float) -> dict:
        """Whole ``Trainer.train(loaders, epochs=1)`` calls until
        `seconds` have passed: its images, steps, seconds and the
        intervals between consecutive dispatches' completions."""
        if self.mesh is not None:
            self.mesh.barrier()
        H.sync(self.cuda)
        m = self.meter
        m.events = [H.stamp(self.cuda)]
        img0, d0 = m.images, m.dispatches
        t0 = time.perf_counter()
        epochs = 0
        while True:
            self.trainer.train(self.loaders, epochs=1)
            epochs += 1
            if not self._go_on(t0, seconds):
                break
        H.sync(self.cuda)
        window_s = time.perf_counter() - t0
        events, m.events = m.events, None
        return {'window_s': window_s, 'epochs': epochs,
                'images': m.images - img0, 'dispatches': m.dispatches - d0,
                'steps': {'sup': epochs * self.epoch_steps[0],
                          'unsup': epochs * self.epoch_steps[1]},
                'intervals_ms': H.intervals_ms(events, self.cuda)}

    # ------------------------------- trace -------------------------------
    def trace(self, skip: int, count: Optional[int]) -> dict:
        """One more epoch with dispatches skip+1 .. skip+count of it traced
        (with no count, from dispatch skip+1 to the end of the call, its
        validation included)."""
        m, base, seg = self.meter, self.meter.dispatches, {}

        def start():
            H.sync(self.cuda)
            seg['prof'] = H.profiler(self.cuda)
            seg['prof'].start()
            H.sync(self.cuda)
            seg['t0'], seg['d0'], seg['i0'] = (time.time_ns(), m.dispatches,
                                               m.images)

        def stop():
            H.sync(self.cuda)
            seg['t1'], seg['d1'], seg['i1'] = (time.time_ns(), m.dispatches,
                                               m.images)
            seg['prof'].stop()

        def hook(meter):
            k = meter.dispatches - base
            if k == skip and 'prof' not in seg:
                start()
            if count is not None and k == skip + count and 't1' not in seg:
                stop()
        if skip == 0:
            start()
        m.hooks.append(hook)
        self.trainer.train(self.loaders, epochs=1)
        m.hooks.remove(hook)
        if 't1' not in seg:
            stop()
        rec = H.reduce_trace(seg['prof'], seg['t0'], seg['t1'])
        rec['steps'] = seg['d1'] - seg['d0']
        rec['validation'] = count is None
        rec['dequant_elements'] = self.dequant_elements(
            seg['i1'] - seg['i0'], rec['validation'])
        return rec

    def dequant_elements(self, images: int, validation: bool) -> int:
        """Elements this process's dequant launches took in a segment of
        `images` global train images, with or without a validation pass.
        No batch is partial: the loader completes one that runs past the
        end of its split from the front."""
        world = self.mesh.world if self.mesh is not None else 1
        rows = images + (self.eval_batches() * self.batch if validation
                         else 0)
        m = self.cell.model
        return rows // world * m['image_size'] ** 2 * m['channels']

    # ------------------------------ readout ------------------------------
    def program_readout(self) -> dict:
        """The warm-up's first steps as the comparison reads them: losses,
        first-gradient and change norms by leaf, and Adam's first moments
        after the first dispatch (``m``, tensors on the device)."""
        r = self.readout
        return {'first': r['first'], 'steps': r['steps'],
                'losses': r['losses'],
                'grad': H.leaf_norms(r['m'], 1.0 / (1.0 - 0.9)),
                'update': H.leaf_norms(r['delta']), 'm': r['m']}

    def eval_batches(self) -> int:
        """Batches of one validation pass."""
        return -(-len(self.splits['valid'][0]) // self.batch)

    def close(self) -> None:
        self.trainer = self.loaders = None
        H.free_program()
