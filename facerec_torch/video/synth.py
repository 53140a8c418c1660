"""Synthetic test clips with ground-truth face boxes.

Port of ``facerec_tpu/video/synth.py``: bright "face" rectangles moving
over static noisy backgrounds with hard cuts, plus the ground-truth
detection stream.  The scene painter is split from the mp4 writer:
:func:`make_frames` paints the frames in memory with numpy alone (a
host without OpenCV can run the pipeline on them), and
:func:`make_clip` writes them to an mp4 with OpenCV, frame for frame
the clip ``facerec_tpu.video.synth.make_clip`` writes for the same
arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from facerec_torch.models.detector import Detections


@dataclasses.dataclass
class SynthClip:
    path: str
    width: int
    height: int
    n_frames: int
    fps: float
    # frame → list of (box, landmarks) ground truths
    truth: Dict[int, List[Tuple[np.ndarray, np.ndarray]]]
    scene_cuts: List[int]
    # frame → identity id per truth entry (empty when identities=0)
    truth_ids: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)
    # (n_frames, height, width, 3) uint8 RGB, when made in memory
    frames: Optional[np.ndarray] = None


def _landmarks_for(box: np.ndarray) -> np.ndarray:
    """Plausible 5-point layout inside a box (eyes, nose, mouth)."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    return np.array([
        [x1 + 0.3 * w, y1 + 0.35 * h],
        [x1 + 0.7 * w, y1 + 0.35 * h],
        [x1 + 0.5 * w, y1 + 0.55 * h],
        [x1 + 0.35 * w, y1 + 0.75 * h],
        [x1 + 0.65 * w, y1 + 0.75 * h],
    ], np.float32)


def identity_style(identity: int) -> Tuple[np.ndarray, int]:
    """Deterministic appearance of a synthetic identity: a face RGB
    color plus an eye-marker shade (drawn at the eye landmarks)."""
    r = np.random.default_rng(10_000 + identity)
    color = r.integers(150, 250, 3).astype(np.uint8)
    eye = int(r.integers(0, 90))
    return color, eye


def paint_face(frame: np.ndarray, box: np.ndarray,
               identity: Optional[int], shade: int) -> None:
    """Draw one face rectangle; with an identity, use its color and eye
    markers so an embedder can tell identities apart."""
    x1, y1, x2, y2 = [int(round(c)) for c in box]
    if identity is None:
        frame[y1:y2, x1:x2] = shade
        return
    color, eye = identity_style(identity)
    frame[y1:y2, x1:x2] = color
    w, h = x2 - x1, y2 - y1
    r = max(1, min(w, h) // 8)
    for lx, ly in _landmarks_for(box)[:2]:       # the two eyes
        cx, cy = int(round(lx)), int(round(ly))
        frame[max(cy - r, 0):cy + r, max(cx - r, 0):cx + r] = eye


def make_frames(n_frames: int = 60, width: int = 192, height: int = 144,
                fps: float = 25.0, seed: int = 0, cuts: Tuple[int, ...] = (),
                n_faces: int = 2, identities: int = 0,
                path: str = "synthetic.mp4") -> SynthClip:
    """Paint a clip in memory and return it with its ground truth.

    Faces are bright rectangles drifting linearly; scenes are static
    noisy backgrounds replaced at each cut (a cut also respawns faces).
    With ``identities=K`` each face carries a persistent identity
    sampled from K actors, recorded per frame in ``truth_ids``.
    ``path`` only names the clip (its movie id).
    """
    rng = np.random.default_rng(seed)
    truth: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    truth_ids: Dict[int, List[int]] = {}
    frames = np.empty((n_frames, height, width, 3), np.uint8)

    def new_scene():
        bg = rng.integers(20, 90, (height, width, 3)).astype(np.uint8)
        faces = []
        cast = (rng.choice(identities, size=n_faces, replace=False)
                if identities >= n_faces else None)
        for k in range(n_faces):
            w = rng.uniform(28, 44)
            h = w * rng.uniform(1.1, 1.3)
            x = rng.uniform(2, width - w - 2)
            y = rng.uniform(2, height - h - 2)
            vx, vy = rng.uniform(-1.5, 1.5, 2)
            shade = int(rng.integers(170, 240))
            ident = int(cast[k]) if cast is not None else None
            faces.append([x, y, w, h, vx, vy, shade, ident])
        return bg, faces

    bg, faces = new_scene()
    for f in range(n_frames):
        if f in cuts:
            bg, faces = new_scene()
        frame = bg.copy()
        truth[f] = []
        truth_ids[f] = []
        for face in faces:
            x, y, w, h, vx, vy, shade, ident = face
            x = float(np.clip(x + vx, 0, width - w))
            y = float(np.clip(y + vy, 0, height - h))
            face[0], face[1] = x, y
            box = np.array([x, y, x + w, y + h], np.float32)
            paint_face(frame, box, ident, shade)
            truth[f].append((box, _landmarks_for(box)))
            truth_ids[f].append(-1 if ident is None else ident)
        frames[f] = frame

    return SynthClip(path=path, width=width, height=height,
                     n_frames=n_frames, fps=fps, truth=truth,
                     scene_cuts=list(cuts), truth_ids=truth_ids,
                     frames=frames)


def write_mp4(clip: SynthClip, path: str) -> None:
    """Write a clip's frames to an mp4 (OpenCV, mp4v)."""
    import cv2

    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), clip.fps,
        (clip.width, clip.height))
    if not writer.isOpened():
        raise RuntimeError("cv2.VideoWriter failed to open")
    for frame in clip.frames:
        writer.write(frame[..., ::-1])  # RGB → BGR
    writer.release()


def make_clip(path: str, n_frames: int = 60, width: int = 192,
              height: int = 144, fps: float = 25.0, seed: int = 0,
              cuts: Tuple[int, ...] = (), n_faces: int = 2,
              identities: int = 0) -> SynthClip:
    """:func:`make_frames` + :func:`write_mp4` at ``path``; the returned
    clip keeps its frames."""
    clip = make_frames(n_frames, width, height, fps, seed, cuts, n_faces,
                       identities, path=path)
    write_mp4(clip, path)
    return clip


class ScriptedDetector:
    """Detector stand-in that replays ground-truth boxes, with the
    :class:`~facerec_torch.models.detector.DetectorHarness` call
    contract; detections land on the frames' device."""

    def __init__(self, clip: SynthClip, max_detections: int = 8,
                 score: float = 0.99):
        self.clip = clip
        self.max_detections = max_detections
        self.score = score
        self._frame0 = 0

    def set_block_start(self, frame0: int) -> None:
        self._frame0 = frame0

    def __call__(self, frames: torch.Tensor) -> Detections:
        b = frames.shape[0]
        d = self.max_detections
        boxes = np.zeros((b, d, 4), np.float32)
        ldm = np.zeros((b, d, 5, 2), np.float32)
        valid = np.zeros((b, d), bool)
        scores = np.zeros((b, d), np.float32)
        for i in range(b):
            for j, (box, marks) in enumerate(
                    self.clip.truth.get(self._frame0 + i, [])[:d]):
                boxes[i, j] = box
                ldm[i, j] = marks
                valid[i, j] = True
                scores[i, j] = self.score
        dev = frames.device
        return Detections(*(torch.from_numpy(a).to(dev)
                            for a in (boxes, scores, ldm, valid)))
