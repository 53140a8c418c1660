"""The traffic's painter: a frozen copy of the port's synthetic clip
painter (``facerec_torch/video/synth.py``, ``make_frames`` and
``paint_frames``; the same bytes for the same arguments).

Bright "face" rectangles, each with an identity's colour and two eye
markers, drift linearly over a static noisy background; each cut draws a
new background and new faces.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _eyes(box: np.ndarray) -> np.ndarray:
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    return np.array([[x1 + 0.3 * w, y1 + 0.35 * h],
                     [x1 + 0.7 * w, y1 + 0.35 * h]], np.float32)


def identity_style(identity: int):
    r = np.random.default_rng(10_000 + identity)
    color = r.integers(150, 250, 3).astype(np.uint8)
    return color, int(r.integers(0, 90))


def paint_face(frame: np.ndarray, box: np.ndarray, identity: Optional[int],
               shade: int) -> None:
    x1, y1, x2, y2 = [int(round(c)) for c in box]
    if identity is None:
        frame[y1:y2, x1:x2] = shade
        return
    color, eye = identity_style(identity)
    frame[y1:y2, x1:x2] = color
    r = max(1, min(x2 - x1, y2 - y1) // 8)
    for lx, ly in _eyes(box):
        cx, cy = int(round(lx)), int(round(ly))
        frame[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = eye


def _new_scene(rng, width: int, height: int, n_faces: int, identities: int,
               sizes=None):
    bg = rng.integers(20, 90, (height, width, 3)).astype(np.uint8)
    cast = (rng.choice(identities, size=n_faces, replace=False)
            if identities >= n_faces else None)
    faces = []
    for k in range(n_faces):
        w = rng.uniform(28, 44)
        h = w * rng.uniform(1.1, 1.3)
        if sizes is not None:            # the traffic's (width, aspect)
            w, h = sizes[k][0], sizes[k][0] * sizes[k][1]
        x = rng.uniform(2, width - w - 2)
        y = rng.uniform(2, height - h - 2)
        vx, vy = rng.uniform(-1.5, 1.5, 2)
        shade = int(rng.integers(170, 240))
        faces.append([x, y, w, h, vx, vy, shade,
                      int(cast[k]) if cast is not None else None])
    return bg, faces


def paint(n_frames: int, width: int, height: int, seed: int,
          cuts: Sequence[int] = (), n_faces: int = 2,
          identities: int = 0, sizes=None) -> np.ndarray:
    """(n_frames, height, width, 3) uint8 RGB frames.  ``sizes``, when
    given, holds each scene's faces' (width, height / width) in place of
    the drawn ones (the draws are still made)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_frames, height, width, 3), np.uint8)
    cut_set = set(cuts)
    scene = iter(sizes) if sizes is not None else None
    new = lambda: _new_scene(rng, width, height, n_faces, identities,
                             None if scene is None else next(scene))
    bg, faces = new()
    for f in range(n_frames):
        if f in cut_set:
            bg, faces = new()
        frame = out[f]
        frame[:] = bg
        for face in faces:
            x, y, w, h, vx, vy = face[:6]
            x = float(np.clip(x + vx, 0, width - w))
            y = float(np.clip(y + vy, 0, height - h))
            face[0], face[1] = x, y
            paint_face(frame, np.array([x, y, x + w, y + h], np.float32),
                       face[7], face[6])
    return out
