"""Face feature/image emission helpers for the extract stage.

Covers the per-face work of reference facerec/extract.py:140-197:
tight/padded box computation, the saved-image pipeline (padded crop →
≤160 thumbnail → grayscale collapse → JPEG q65), and feature-record
assembly.  Embedding crops themselves are batched on device
(:mod:`facerec_torch.ops.crops`); only JPEG encode stays host-side.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from facerec_torch.config import CROP_MARGIN, FACE_IMAGE_SIZE, SAVE_FACE_PADDING
from facerec_torch.contract import records
from facerec_torch.contract.naming import box_tag
from facerec_torch.ops.boxes import round_clip_box

KEYPOINT_NAMES = ("left_eye", "right_eye", "nose", "mouth_left",
                  "mouth_right")


@dataclasses.dataclass
class PendingFace:
    """A detection awaiting its track's validity decision."""

    frame: int
    uid: int
    posterior_box: np.ndarray   # (4,) float
    landmarks: np.ndarray       # (5, 2) float


def embed_crop_box(tight_box, width: int, height: int,
                   margin: int = CROP_MARGIN) -> np.ndarray:
    """The embedding crop region: tight box expanded by margin/2 per
    side, clipped (cropBox-with-margin semantics, extract.py:160-164)."""
    x1, y1, x2, y2 = tight_box
    m = margin / 2.0
    return np.array([
        max(x1 - m, 0.0), max(y1 - m, 0.0),
        min(x2 + m, float(width)), min(y2 + m, float(height)),
    ], np.float32)


def keypoints_dict(landmarks: np.ndarray) -> Dict[str, tuple]:
    return {name: (int(round(float(landmarks[i, 0]))),
                   int(round(float(landmarks[i, 1]))))
            for i, name in enumerate(KEYPOINT_NAMES)}


def prepare_face_image(frame_pixels: np.ndarray, posterior_box,
                       width: int, height: int) -> np.ndarray:
    """Padded crop → thumbnail ≤160 → grayscale collapse
    (extract.py:169-178).  Returns (h, w, 3) RGB or (h, w) grayscale."""
    from PIL import Image, ImageOps

    padded = round_clip_box(posterior_box, width, height,
                            padding=SAVE_FACE_PADDING)
    img = Image.fromarray(frame_pixels).crop(tuple(padded))
    img.thumbnail((FACE_IMAGE_SIZE, FACE_IMAGE_SIZE),
                  resample=Image.BILINEAR)
    arr = np.asarray(img)
    flat = arr.reshape(-1, 3)
    if flat.size and (flat[:, 0] == flat[:, 1]).all():
        return np.asarray(ImageOps.grayscale(img))
    return arr


def save_face_image(frame_pixels: np.ndarray, posterior_box, width: int,
                    height: int, images_dir: str, tag: str,
                    jpeg_writer=None) -> None:
    """JPEG q65 write (extract.py:185), async via the native writer
    when available."""
    arr = prepare_face_image(frame_pixels, posterior_box, width, height)
    path = f"{images_dir}/{tag}.jpeg"
    if jpeg_writer is not None:
        jpeg_writer.submit(path, arr)
    else:
        from PIL import Image

        Image.fromarray(arr).save(path, quality=65)


def feature_record_for(movie_id: int, frame: int, tight_box,
                       embeddings: Dict[str, List[float]],
                       landmarks: np.ndarray, width: int,
                       height: int) -> dict:
    tag = box_tag(movie_id, frame, tight_box)
    return records.feature_record(
        frame=frame, tag=tag, embeddings=embeddings, box=tight_box,
        keypoints=keypoints_dict(landmarks), width=width, height=height)
