"""Synthetic test clips with ground-truth face boxes.

Port of ``facerec_tpu/video/synth.py``: bright "face" rectangles moving
over static noisy backgrounds with hard cuts, plus the ground-truth
detection stream.  The scene painter is split from the mp4 writer:
:func:`make_frames` paints the frames in memory with numpy alone (a
host without OpenCV can run the pipeline on them), and
:func:`make_clip` writes them to an mp4 with OpenCV, frame for frame
the clip ``facerec_tpu.video.synth.make_clip`` writes for the same
arguments.  :func:`paint_frames` gives the same clip painted block by
block as a reader reads it, for film-length clips and for worker
processes (it pickles as its arguments).  :func:`synth_batch` and
:func:`identity_crops` make the trainers' data, the same bytes as the
JAX package's for one generator state, with numpy alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

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
    # (n_frames, height, width, 3) uint8 RGB when made in memory: an
    # array (make_frames) or PaintedFrames (paint_frames)
    frames: Optional[Union[np.ndarray, "PaintedFrames"]] = None


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


def _new_scene(rng: np.random.Generator, width: int, height: int,
               n_faces: int, identities: int):
    """One scene's draws, in order: the static noisy background, then
    per face its size, position, velocity, shade and identity."""
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


def _advance(face: list, width: int, height: int) -> np.ndarray:
    """Move a face by its velocity, clipped to the frame, in place;
    returns its box [x1, y1, x2, y2]."""
    x, y, w, h, vx, vy = face[:6]
    x = float(np.clip(x + vx, 0, width - w))
    y = float(np.clip(y + vy, 0, height - h))
    face[0], face[1] = x, y
    return np.array([x, y, x + w, y + h], np.float32)


def make_frames(n_frames: int = 60, width: int = 192, height: int = 144,
                fps: float = 25.0, seed: int = 0, cuts: Tuple[int, ...] = (),
                n_faces: int = 2, identities: int = 0,
                path: str = "synthetic.mp4") -> SynthClip:
    """Paint a clip in memory and return it with its ground truth.

    Faces are bright rectangles drifting linearly; scenes are static
    noisy backgrounds replaced at each cut (a cut also respawns faces).
    With ``identities=K`` each face carries a persistent identity
    sampled from K actors, recorded per frame in ``truth_ids``.
    ``path`` only names the clip (its movie id).  :func:`paint_frames`
    gives the same clip without holding its frames.
    """
    rng = np.random.default_rng(seed)
    truth: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    truth_ids: Dict[int, List[int]] = {}
    frames = np.empty((n_frames, height, width, 3), np.uint8)

    bg, faces = _new_scene(rng, width, height, n_faces, identities)
    for f in range(n_frames):
        if f in cuts:
            bg, faces = _new_scene(rng, width, height, n_faces, identities)
        frame = bg.copy()
        truth[f] = []
        truth_ids[f] = []
        for face in faces:
            box = _advance(face, width, height)
            shade, ident = face[6], face[7]
            paint_face(frame, box, ident, shade)
            truth[f].append((box, _landmarks_for(box)))
            truth_ids[f].append(-1 if ident is None else ident)
        frames[f] = frame

    return SynthClip(path=path, width=width, height=height,
                     n_frames=n_frames, fps=fps, truth=truth,
                     scene_cuts=list(cuts), truth_ids=truth_ids,
                     frames=frames)


class PaintedFrames:
    """The (n_frames, height, width, 3) uint8 frames of
    :func:`make_frames` for the same arguments, painted when a slice of
    them is read.

    The generator draws only at scene starts, so construction replays
    the draws once and keeps, per scene, the generator state that
    paints its background and, per frame, the face boxes; a block is
    then painted from those alone.  Memory holds one background, not
    the film.  Pickles as its arguments (a worker process repaints)."""

    def __init__(self, n_frames: int, width: int, height: int, seed: int,
                 cuts: Tuple[int, ...], n_faces: int, identities: int):
        self.args = (n_frames, width, height, seed, tuple(cuts), n_faces,
                     identities)
        self.shape = (n_frames, height, width, 3)
        self.dtype = np.dtype(np.uint8)
        rng = np.random.default_rng(seed)
        self._states, self._styles = [], []
        self.boxes = np.empty((n_frames, n_faces, 4), np.float32)
        self.scene_of = np.empty(n_frames, np.int64)

        def new_scene():
            self._states.append(rng.bit_generator.state)
            _, faces = _new_scene(rng, width, height, n_faces, identities)
            self._styles.append([(face[6], face[7]) for face in faces])
            return faces

        faces = new_scene()
        cut_set = set(cuts)
        for f in range(n_frames):
            if f in cut_set:
                faces = new_scene()
            for k, face in enumerate(faces):
                self.boxes[f, k] = _advance(face, width, height)
            self.scene_of[f] = len(self._states) - 1
        self._bg = (-1, None)

    def __reduce__(self):
        return PaintedFrames, self.args

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            f = range(len(self))[key]
            return self._paint(f, f + 1)[0]
        if not isinstance(key, slice):
            raise TypeError(f"PaintedFrames takes an int or a slice, got "
                            f"{type(key).__name__}")
        start, stop, step = key.indices(len(self))
        if step != 1:
            raise ValueError("PaintedFrames slices take no step")
        return self._paint(start, max(start, stop))

    def __iter__(self):
        for a in range(0, len(self), 64):
            yield from self._paint(a, min(a + 64, len(self)))

    def _background(self, scene: int) -> np.ndarray:
        if self._bg[0] != scene:
            rng = np.random.default_rng()
            rng.bit_generator.state = self._states[scene]
            _, width, height = self.args[:3]
            self._bg = (scene, rng.integers(
                20, 90, (height, width, 3)).astype(np.uint8))
        return self._bg[1]

    def _paint(self, a: int, b: int) -> np.ndarray:
        out = np.empty((b - a,) + self.shape[1:], np.uint8)
        for f in range(a, b):
            scene = int(self.scene_of[f])
            frame = out[f - a]
            frame[:] = self._background(scene)
            for box, (shade, ident) in zip(self.boxes[f],
                                           self._styles[scene]):
                paint_face(frame, box, ident, shade)
        return out

    def truth(self):
        """(truth, truth_ids) as :func:`make_frames` gives them."""
        truth, truth_ids = {}, {}
        for f in range(len(self)):
            styles = self._styles[int(self.scene_of[f])]
            truth[f] = [(box, _landmarks_for(box)) for box in self.boxes[f]]
            truth_ids[f] = [-1 if ident is None else ident
                            for _, ident in styles]
        return truth, truth_ids


def paint_frames(n_frames: int = 60, width: int = 192, height: int = 144,
                 fps: float = 25.0, seed: int = 0,
                 cuts: Tuple[int, ...] = (), n_faces: int = 2,
                 identities: int = 0,
                 path: str = "synthetic.mp4") -> SynthClip:
    """:func:`make_frames`'s clip with :class:`PaintedFrames` as its
    frames: each block is painted when the reader reads it, so a
    film-length clip fits in memory."""
    frames = PaintedFrames(n_frames, width, height, seed, cuts, n_faces,
                           identities)
    truth, truth_ids = frames.truth()
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


def _linear_taps(src: int, dst: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps of one axis: (index0, index1, coef0,
    coef1), coefficients in 11-bit fixed point.  The horizontal axis
    clamps the position at the borders; the vertical one clamps only
    the source rows, so a border row keeps two nonzero coefficients."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, src - 1)
    # saturate_cast<short> rounds half to even, as np.rint
    c0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64)
    c1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), c0, c1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)``
    of an (H, W, C) uint8 image, in numpy, byte for byte: OpenCV's fixed
    point (11-bit coefficients; a horizontal pass into 22-bit sums, then
    its SIMD vertical pass: each row's sum shifted right by 4, multiplied
    by its coefficient keeping the high 16 bits, the two added and
    rounded off by 2 bits).  The card's host has no OpenCV."""
    h, w, _ = img.shape
    x0, x1, a0, a1 = _linear_taps(w, width, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, height, clamp=False)
    px = img.astype(np.int64)
    rows = px[:, x0] * a0[None, :, None] + px[:, x1] * a1[None, :, None]
    v = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def identity_crops(rng: np.random.Generator, identity: int, n: int,
                   size: int = 160,
                   native_face: Tuple[float, float] = (19.0, 30.0)
                   ) -> np.ndarray:
    """(n, size, size, 3) uint8 crops of one identity's face —
    training/reference data for the embedder.

    Faces are painted at their native film scale (a couple dozen
    pixels) in a small crop window and bilinearly upscaled to the embed
    size, as the pipeline's ``crop_resize`` feeds the embedder.  The
    same bytes as ``facerec_tpu.video.synth.identity_crops`` for the same
    generator state (its upscale is ``cv2.resize``; here
    :func:`resize_linear_u8`)."""
    out = np.zeros((n, size, size, 3), np.uint8)
    for i in range(n):
        w = rng.uniform(*native_face)
        cs = int(round(w / rng.uniform(0.55, 0.9)))   # crop window side
        canvas = rng.integers(20, 90, (cs, cs, 3)).astype(np.uint8)
        h = min(w * rng.uniform(1.0, 1.25), cs - 2.0)
        x = rng.uniform(0, cs - w - 1)
        y = rng.uniform(0, cs - h - 1)
        paint_face(canvas, np.array([x, y, x + w, y + h], np.float32),
                   identity, shade=0)
        out[i] = resize_linear_u8(canvas, size, size)
    return out


def synth_batch(rng: np.random.Generator, batch: int, width: int,
                height: int, max_faces: int = 3,
                face_size: Tuple[float, float] = (24.0, 64.0),
                identities: int = 0, identity_base: int = 0):
    """Random training frames of "face" rectangles over noise
    backgrounds — the face model :func:`make_frames` paints, batched
    with padded ground truth for the detector trainer.  With
    ``identities=K`` faces are painted in random identity styles.  The
    same bytes as ``facerec_tpu.video.synth.synth_batch`` for the same
    generator state.

    Returns (frames (B,H,W,3) uint8, boxes (B,F,4) f32, valid (B,F)
    bool, landmarks (B,F,5,2) f32).
    """
    frames = rng.integers(20, 90, (batch, height, width, 3)).astype(np.uint8)
    boxes = np.zeros((batch, max_faces, 4), np.float32)
    valid = np.zeros((batch, max_faces), bool)
    ldm = np.zeros((batch, max_faces, 5, 2), np.float32)
    for i in range(batch):
        for j in range(int(rng.integers(1, max_faces + 1))):
            w = rng.uniform(*face_size)
            h = min(w * rng.uniform(1.1, 1.3), height - 5)
            x = rng.uniform(2, width - w - 2)
            y = rng.uniform(2, height - h - 2)
            box = np.array([x, y, x + w, y + h], np.float32)
            ident = (identity_base + int(rng.integers(0, identities))
                     if identities else None)
            paint_face(frames[i], box, ident,
                       shade=int(rng.integers(170, 240)))
            boxes[i, j] = box
            valid[i, j] = True
            ldm[i, j] = _landmarks_for(box)
    return frames, boxes, valid, ldm


class ScriptedDetector:
    """Detector stand-in that replays ground-truth boxes, with the
    :class:`~facerec_torch.models.detector.DetectorHarness` call
    contract; detections land on the frames' device."""

    def __init__(self, clip: SynthClip, max_detections: int = 8,
                 score: float = 0.99):
        # the truth only: the detector pickles to worker processes
        # without the clip's pixels
        self.truth = dict(clip.truth)
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
                    self.truth.get(self._frame0 + i, [])[:d]):
                boxes[i, j] = box
                ldm[i, j] = marks
                valid[i, j] = True
                scores[i, j] = self.score
        dev = frames.device
        return Detections(*(torch.from_numpy(a).to(dev)
                            for a in (boxes, scores, ldm, valid)))
