"""Bounding-box geometry: IoU matrices, coordinate conversions, rounding.

Port of ``facerec_tpu/ops/boxes.py``.  Box convention is
``[x1, y1, x2, y2]`` everywhere.  The tensor functions run on whatever
device their inputs live on; ``round_clip_box`` and ``iou_single`` are
host-side numpy helpers.
"""
from __future__ import annotations

import numpy as np
import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 4) × (M, 4) → (N, M) IoU; zero-area unions give 0, not NaN."""
    a = boxes_a[:, None, :]
    b = boxes_b[None, :, :]
    return iou_broadcast(a, b)


def iou_broadcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of broadcastable (..., 4) box tensors."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def box_to_z(box: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] → measurement [cx, cy, area, aspect] over any
    leading dims."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    cx = box[..., 0] + w / 2.0
    cy = box[..., 1] + h / 2.0
    return torch.stack([cx, cy, w * h, w / h], dim=-1)


def z_to_box(z: torch.Tensor) -> torch.Tensor:
    """[cx, cy, area, aspect] → [x1,y1,x2,y2]; negative area/aspect give
    0-size boxes, not NaN."""
    s = z[..., 2]
    r = z[..., 3]
    w = torch.sqrt((s * r).clamp_min(0.0))
    pos = w > 0
    h = torch.where(pos, s / torch.where(pos, w, 1.0), 0.0)
    return torch.stack(
        [z[..., 0] - w / 2.0, z[..., 1] - h / 2.0,
         z[..., 0] + w / 2.0, z[..., 1] + h / 2.0], dim=-1)


def round_clip_box(box, max_w: int, max_h: int, padding: float = 0.0):
    """Float box → int box with optional symmetric padding, border
    clamping and round-half-to-even (numpy round semantics)."""
    b = np.asarray(box, dtype=np.float32)
    dim = np.minimum(b[2] - b[0], b[3] - b[1])
    pad = padding * dim
    b = b + np.array([-pad, -pad, pad, pad], dtype=np.float32)
    b = np.maximum(b, [0, 0, 0, 0])
    b = np.minimum(b, [max_w, max_h, max_w, max_h])
    b = np.round(b)
    return [int(c) for c in b]


def iou_single(box_a, box_b) -> float:
    """Host-side scalar IoU (used by the merge stage)."""
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[2], box_b[2])
    yb = min(box_a[3], box_b[3])
    inter = max(xb - xa, 0) * max(yb - ya, 0)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    return inter / float(area_a + area_b - inter)
