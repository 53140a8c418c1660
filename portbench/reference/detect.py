"""Pixels to detections, plainly: letterbox, the network, anchor decode,
score and size filters, the top candidates and greedy NMS, one frame
at a time on the host after the network.

Semantics of the extract stage's detector: boxes and landmarks decoded
against level-major anchors (strides 8/16/32, sizes (16, 32), (64, 128),
(256, 512), variances 0.1/0.2), clamped to the frame; kept where score >
``score_threshold`` and the shorter side >= ``min_face_size``; the
``candidates`` best kept (ties to the lower anchor) enter greedy NMS at
IoU > ``nms_iou``, which picks at most ``max_detections`` in score
order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import FaceDetector

STRIDES = (8, 16, 32)
SIZES = ((16, 32), (64, 128), (256, 512))
V0, V1 = 0.1, 0.2


def fit_input(h: int, w: int, multiple: int = 32) -> Tuple[int, int]:
    """The detector input at the film's native size: each side rounded
    up to the stride multiple."""
    up = lambda v: max(multiple, -(-v // multiple) * multiple)
    return up(h), up(w)


def anchors(ih: int, iw: int) -> np.ndarray:
    """(A, 4) [cx, cy, w, h], level-major, row-major, anchor-minor."""
    out = []
    for stride, sizes in zip(STRIDES, SIZES):
        for y in range(ih // stride):
            for x in range(iw // stride):
                for s in sizes:
                    out.append(((x + 0.5) * stride, (y + 0.5) * stride, s, s))
    return np.asarray(out, np.float32)


@dataclasses.dataclass
class FrameDets:
    """One frame's detections in pick order."""

    boxes: np.ndarray       # (n, 4) float32
    scores: np.ndarray      # (n,)
    landmarks: np.ndarray   # (n, 5, 2)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[0], b[:, 0])
    y1 = np.maximum(a[1], b[:, 1])
    x2 = np.minimum(a[2], b[:, 2])
    y2 = np.minimum(a[3], b[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def greedy_nms(boxes, scores, iou: float, k: int) -> List[int]:
    order = list(range(len(scores)))        # already in score order
    picked: List[int] = []
    alive = np.ones(len(order), bool)
    while len(picked) < k and alive.any():
        i = int(np.flatnonzero(alive)[0])
        picked.append(i)
        alive[i] = False
        alive &= ~(_iou(boxes[i], boxes) > iou)
    return picked


class Detector:
    def __init__(self, state_dict, frame_hw: Tuple[int, int],
                 device: torch.device, max_detections: int = 16,
                 score_threshold: float = 0.95, min_face_size: float = 20.0,
                 nms_iou: float = 0.4, candidates: int = 128):
        width = int(state_dict["stem.conv.weight"].shape[0])
        self.net = FaceDetector(backbone_width=width)
        self.net.load_state_dict(state_dict)
        self.net = self.net.to(device).eval()
        self.h, self.w = frame_hw
        self.input_hw = fit_input(self.h, self.w)
        self.anchors = torch.from_numpy(anchors(*self.input_hw)).to(device)
        self.device = device
        self.k, self.thr = max_detections, score_threshold
        self.min_size, self.nms_iou = min_face_size, nms_iou
        self.candidates = candidates

    @torch.no_grad()
    def __call__(self, frames: np.ndarray) -> List[FrameDets]:
        """(B, H, W, 3) uint8 host frames → one FrameDets a frame."""
        ih, iw = self.input_hw
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        x = x.permute(0, 3, 1, 2).float()
        x = F.pad(x, (0, iw - self.w, 0, ih - self.h))   # pixel value 0
        raw = torch.cat(self.net((x - 127.5) / 128.0), dim=1)
        a = self.anchors
        cx = a[:, 0] + raw[..., 1] * V0 * a[:, 2]
        cy = a[:, 1] + raw[..., 2] * V0 * a[:, 3]
        bw = a[:, 2] * torch.exp((raw[..., 3] * V1).clamp(-10, 6))
        bh = a[:, 3] * torch.exp((raw[..., 4] * V1).clamp(-10, 6))
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1)
        lim = torch.tensor([self.w, self.h, self.w, self.h],
                           dtype=boxes.dtype, device=boxes.device)
        boxes = torch.minimum(boxes.clamp_min(0.0), lim)
        scores = torch.sigmoid(raw[..., 0])
        side = torch.minimum(boxes[..., 2] - boxes[..., 0],
                             boxes[..., 3] - boxes[..., 1])
        keep = (scores > self.thr) & (side >= self.min_size)
        ldm = raw[..., 5:15].reshape(*raw.shape[:2], 5, 2)
        lx = a[:, None, 0] + ldm[..., 0] * V0 * a[:, None, 2]
        ly = a[:, None, 1] + ldm[..., 1] * V0 * a[:, None, 3]
        ldm = torch.stack([lx, ly], -1)
        boxes, scores, keep, ldm = (t.cpu().numpy()
                                    for t in (boxes, scores, keep, ldm))
        out = []
        for b in range(len(frames)):
            idx = np.flatnonzero(keep[b])
            # best first; a stable sort leaves ties in anchor order
            idx = idx[np.argsort(-scores[b, idx], kind="stable")]
            idx = idx[:self.candidates]
            pick = idx[greedy_nms(boxes[b, idx], scores[b, idx],
                                  self.nms_iou, self.k)]
            out.append(FrameDets(boxes[b, pick], scores[b, pick],
                                 ldm[b, pick]))
        return out
