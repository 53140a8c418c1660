"""The harness's hooks into the program: a wrapper around the detector
object and an embedder bank that it hands to ``run_extract``.

The detector wrapper stamps the host's clock at each call (a block's
step, after its upload), keeps the detections of the film's first pass
over the pool (for the check) and, in a profiled extract, opens and
closes the profiler at block boundaries: it starts at the block
``start`` and stops ``blocks`` blocks later, each time after
synchronising, so the traced window holds whole fetch groups of the
steady loop.  Both wrappers put a ``record_function`` range around their
calls while the profiler runs, and the bank counts the real crops there
(its batch is padded by repeating the last).  The bank's dispatch passes
whatever follows the crop boxes (a family's landmarks) on unchanged.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch

DETECTOR_RANGE = "portbench.detector"
EMBED_RANGE = "portbench.embed"
RANGES = (DETECTOR_RANGE, EMBED_RANGE)


class Probe:
    def __init__(self, sync):
        self.sync = sync
        self.prof = None
        self.window_s = None
        self.reset()

    def reset(self, keep: int = 0, start: Optional[int] = None,
              blocks: int = 0) -> None:
        """Before an extract: keep the detections of its first ``keep``
        blocks; profile ``blocks`` blocks from the block ``start``."""
        self.keep, self.kept, self.calls, self.stamps = keep, [], 0, []
        self.start, self.blocks = start, blocks
        self.in_window = {"blocks": 0, "crops": 0, "crop_slots": 0,
                          "dispatches": 0}

    def profiling(self) -> bool:
        return self.prof is not None and self.start is not None

    def range(self, name: str):
        if self.profiling():
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def on_block(self) -> None:
        self.stamps.append(time.perf_counter())
        if self.start is None:
            return
        if self.calls == self.start:
            from torch.profiler import ProfilerActivity, profile

            self.sync()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._t0 = time.perf_counter()
        elif self.calls == self.start + self.blocks and self.prof is not None:
            self.sync()
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()
            self.start = None
        if self.profiling():
            self.in_window["blocks"] += 1


class Detector:
    """Calls the program's detector; what it returns goes on unchanged."""

    def __init__(self, inner, probe: Probe):
        self.inner = inner
        self.probe = probe

    def __call__(self, frames):
        p = self.probe
        p.on_block()
        with p.range(DETECTOR_RANGE):
            det = self.inner(frames)
        if p.keep > 0:
            p.kept.append(det)
            p.keep -= 1
        p.calls += 1
        return det


def real_crops(frame_idx: np.ndarray, crop_boxes: np.ndarray) -> int:
    """Crops in a batch padded by repeating its last crop."""
    rows = np.concatenate([np.asarray(frame_idx, np.float64)[:, None],
                           np.asarray(crop_boxes, np.float64)], 1)
    n = len(rows)
    while n > 1 and np.array_equal(rows[n - 2], rows[-1]):
        n -= 1
    return n


def make_bank(base_cls, embedders, probe: Probe):
    """An instance of a subclass of the program's ``EmbedderBank``
    whose crop+embed dispatch is ranged and counted."""

    class Bank(base_cls):
        def dispatch_crop_embed(self, stack, frame_idx, crop_boxes, *args,
                                **kwargs):
            with probe.range(EMBED_RANGE):
                out = super().dispatch_crop_embed(stack, frame_idx,
                                                  crop_boxes, *args,
                                                  **kwargs)
            if probe.profiling():
                w = probe.in_window
                w["dispatches"] += 1
                w["crops"] += real_crops(frame_idx, crop_boxes)
                w["crop_slots"] += len(frame_idx)
            return out

    return Bank(embedders)
