"""Detection streams that exercise the tracker: random drift with cuts,
crossing tracks with duplicated detections that send the association to
the exact solver, and crowds that fill more than 32 track slots.

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


def crowd_stream(rng: np.random.Generator, n_frames: int = 96,
                 width: int = 768, height: int = 576, n_objects: int = 48,
                 p_miss: float = 0.1, cuts: Sequence[int] = (48,)
                 ) -> Tuple[List[List[np.ndarray]], np.ndarray]:
    """A crowd: ``n_objects`` boxes from the first frame on, and a new
    crowd after each cut, drifting with jitter and bouncing off the
    frame's edges.  Each frame an object is missed with ``p_miss``, and
    leaves with probability 0.01 while a new one enters in its place;
    each frame's detections come in a random order."""
    def enter():
        s = rng.uniform(24, 64)
        x, y = rng.uniform(0, width - s), rng.uniform(0, height - 1.3 * s)
        return np.array([x, y, x + s, y + s * rng.uniform(1.0, 1.3),
                         rng.uniform(-2, 2), rng.uniform(-2, 2)])

    flags = np.zeros(n_frames, bool)
    flags[list(cuts)] = True
    objs, det_stream = [], []
    for f in range(n_frames):
        if f == 0 or flags[f]:
            objs = [enter() for _ in range(n_objects)]
        else:
            objs = [enter() if rng.uniform() < 0.01 else o for o in objs]
        dets = []
        for o in objs:
            o[:4] += np.array([o[4], o[5], o[4], o[5]])
            if o[0] < 0 or o[2] > width:
                o[4] = -o[4]
            if o[1] < 0 or o[3] > height:
                o[5] = -o[5]
            if rng.uniform() >= p_miss:
                dets.append(np.clip(o[:4] + rng.normal(0, 1.0, 4), 0,
                                    [width, height, width, height]))
        rng.shuffle(dets)
        det_stream.append(dets)
    return det_stream, flags


# the crowd streams of the tracker's tests and chip_smoke.py, by name:
# crowd_stream's keyword arguments
CROWDS = {
    "crowd48": dict(n_frames=96, width=768, height=576, n_objects=48,
                    cuts=(48,)),
    "crowd120": dict(n_frames=64, width=1920, height=1080, n_objects=120,
                     cuts=()),
}


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
