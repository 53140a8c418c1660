"""Detection streams that exercise the tracker: random drift with cuts,
and crossing tracks with duplicated detections that send the
association to the exact solver.

:func:`simulate_stream` is the JAX package's test stream
(``tests/test_tracker.py:simulate_stream``), copied so that the card's
checks, which import nothing of the JAX package, replay the same
detections as the CPU tests.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def simulate_stream(rng: np.random.Generator, n_frames: int = 120,
                    width: int = 320, height: int = 240, max_det: int = 8,
                    p_cut: float = 0.02, p_miss: float = 0.15,
                    n_objects: int = 4
                    ) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """Objects drifting with noise; random appear/disappear; scene
    cuts.  Returns (per-frame lists of [x1, y1, x2, y2] boxes, (n,)
    bool scene flags)."""
    objs = []
    det_stream = []
    scene_flags = np.zeros(n_frames, bool)
    for f in range(n_frames):
        if f > 2 and rng.uniform() < p_cut:
            scene_flags[f] = True
            objs = []
        while len(objs) < n_objects and rng.uniform() < 0.3:
            w = rng.uniform(20, 60)
            h = rng.uniform(20, 60)
            x = rng.uniform(0, width - w)
            y = rng.uniform(0, height - h)
            objs.append(np.array([x, y, x + w, y + h,
                                  rng.uniform(-3, 3), rng.uniform(-3, 3)]))
        objs = [o for o in objs if rng.uniform() > 0.02]
        dets = []
        for o in objs:
            o[:4] += np.array([o[4], o[5], o[4], o[5]])
            if rng.uniform() > p_miss:
                jitter = rng.normal(0, 1.0, 4)
                dets.append(np.clip(o[:4] + jitter, 0,
                                    [width, height, width, height]))
        rng.shuffle(dets)
        det_stream.append([d for d in dets[:max_det]])
    return det_stream, scene_flags


def crossing_stream(rng: np.random.Generator, n_frames: int = 256,
                    width: int = 768, height: int = 576, n_pairs: int = 4,
                    dup_every: int = 5, cuts: Sequence[int] = (128,)
                    ) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """Pairs of equal boxes swinging through each other on one row, so
    that both detections of a pair overlap both tracks (argmax column
    collisions), and every ``dup_every``-th frame one detection twice
    (two tracks spawned from one box, then equal IoUs: argmax ties).
    Each frame's detections come in a random order."""
    pairs = []
    for _ in range(n_pairs):
        s = rng.uniform(40, 90)
        pairs.append((rng.uniform(s, width - 2 * s),     # center x
                      rng.uniform(0, height - s), s,      # top, size
                      rng.uniform(0.6, 1.2) * s,          # swing
                      rng.uniform(0.05, 0.12),            # rad per frame
                      rng.uniform(0, np.pi)))             # phase
    flags = np.zeros(n_frames, bool)
    flags[list(cuts)] = True
    det_stream = []
    for f in range(n_frames):
        dets = []
        for cx, top, s, amp, w, ph in pairs:
            off = amp * np.cos(w * f + ph)
            for x in (cx - off, cx + off):
                box = np.array([x - s / 2, top, x + s / 2, top + s])
                dets.append(box + rng.normal(0, 0.5, 4))
        if dup_every and f % dup_every == 0:
            dets.append(dets[int(rng.integers(len(dets)))].copy())
        rng.shuffle(dets)
        det_stream.append([np.clip(d, 0, [width, height, width, height])
                           for d in dets])
    return det_stream, flags


def stream_arrays(det_stream: Sequence[Sequence[np.ndarray]], d: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame box lists → ((n, d, 4) float32 boxes, zero-padded;
    (n, d) bool validity); a frame keeps its first ``d`` boxes."""
    n = len(det_stream)
    boxes = np.zeros((n, d, 4), np.float32)
    valid = np.zeros((n, d), bool)
    for f, dets in enumerate(det_stream):
        for i, b in enumerate(dets[:d]):
            boxes[f, i] = b
            valid[f, i] = True
    return boxes, valid
