"""The extract stage's outputs for a film that loops over a pool of
frames, computed by the plain reference.

The detector sees each pool frame once (a frame's detections do not
depend on its neighbours), the scene statistics are taken over the
pool for the first pass and for the later ones (they differ in the
first two frames only), and SORT then runs over every frame of the
film.  Embeddings are computed on demand for the faces a check draws, by
the embedder family's reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import detect, scene, track


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products exactly (``tf32=False``), or on TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclasses.dataclass
class Outputs:
    """What a run of the extract stage leaves, in one form for the
    program's files and the reference alike."""

    cuts: List[int]
    pool_dets: List["detect.FrameDets"]   # the first pass, frame by frame
    trajectories: List[dict]
    faces: List[dict]                     # frame, box, keypoints(, landmarks)
    embed: object = None                  # faces index list → {name: (n, d)}


class Reference:
    def __init__(self, pool: np.ndarray, config: dict, detector_state,
                 embedder, device: torch.device, tf32: bool = False):
        """``embedder``: the embedder family's reference (frames, faces)
        → {name: (n, dim)}."""
        ext = config["extract"]
        self.pool, self.ext, self.device, self.tf32 = pool, ext, device, tf32
        self.h, self.w = pool.shape[1:3]
        self.detector = detect.Detector(
            detector_state, (self.h, self.w), device,
            max_detections=ext["max_detections"],
            score_threshold=ext["face_threshold"],
            min_face_size=ext["min_face_size"])
        self.embedder = embedder

    def run(self, n_frames: int, chunk: int = 32) -> Outputs:
        pool, ext, n = self.pool, self.ext, len(self.pool)
        with precision(self.tf32):
            dets: List[detect.FrameDets] = []
            for a in range(0, n, chunk):
                dets.extend(self.detector(pool[a:a + chunk]))
            first, later = scene.pool_flags(
                lambda a, b: pool[a:b], n, self.device)
        flags = np.concatenate(
            [first, np.tile(later, -(-n_frames // n))])[:n_frames]
        result = track.run(
            [dets[i % n] for i in range(n_frames)], flags, self.w, self.h,
            max_tracks=ext["max_tracks"], max_age=ext["max_trajectory_age"],
            min_hits=ext["min_trajectory"],
            iou_threshold=ext["iou_threshold"], save_every=ext["save_every"])
        out = Outputs(np.flatnonzero(flags).tolist(), dets,
                      result.trajectories, result.faces)
        out.embed = lambda idx: self.embed([out.faces[i] for i in idx])
        return out

    def embed(self, faces: Sequence[dict]) -> Dict[str, np.ndarray]:
        """The embeddings of saved faces: their pool frames go to the
        device once each, and each face's ``frame`` becomes its frame's
        index there."""
        n = len(self.pool)
        keys = sorted({f["frame"] % n for f in faces})
        at = {k: i for i, k in enumerate(keys)}
        frames = torch.from_numpy(self.pool[keys]).to(self.device)
        with precision(self.tf32):
            return self.embedder(frames, [dict(f, frame=at[f["frame"] % n])
                                          for f in faces])
