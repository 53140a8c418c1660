"""Single-stage face detector with landmarks.

Port of ``facerec_tpu/models/detector.py``: the same backbone (a 12×12
stride-4 stem, residual stages at strides 8/16/32), FPN, SSH context
modules and per-level anchor heads, then decode, score/size filter,
candidate pre-selection and greedy NMS.  Submodule names mirror the
Flax parameter tree (:mod:`facerec_torch.models.convert`).

Public functions keep the JAX layout: NHWC uint8 frames in, ``(B, D,
4)`` boxes out.  Inside the network tensors are NCHW.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from facerec_torch.models.layers import (Conv, ConvBN, cast_float_tree,
                                         init_weights)
from facerec_torch.ops.nms import nms
from facerec_torch.runtime.device import resolve_device

STRIDES = (8, 16, 32)
ANCHOR_SIZES = ((16, 32), (64, 128), (256, 512))
VARIANCES = (0.1, 0.2)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_ch, features, 3, stride)
        self.conv2 = ConvBN(features, features, 3, 1, act=False)
        self.proj = (ConvBN(in_ch, features, 1, stride, act=False)
                     if stride != 1 or in_ch != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class SSH(nn.Module):
    """SSH context module: 3x3 ∥ 5x5 ∥ 7x7 receptive fields via stacked
    3x3 convs, concatenated on the channel axis."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        half, quarter = features // 2, features // 4
        self.conv3 = ConvBN(in_ch, half, 3, act=False)
        self.conv5a = ConvBN(in_ch, quarter, 3)
        self.conv5 = ConvBN(quarter, quarter, 3, act=False)
        self.conv7a = ConvBN(quarter, quarter, 3)
        self.conv7 = ConvBN(quarter, quarter, 3, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c3 = self.conv3(x)
        c5a = self.conv5a(x)
        c5 = self.conv5(c5a)
        c7 = self.conv7(self.conv7a(c5a))
        return F.relu(torch.cat([c3, c5, c7], dim=1))


def _up2(t: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of an NCHW tensor."""
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FaceDetector(nn.Module):
    """Backbone + FPN + SSH + per-level anchor heads → raw per-level
    predictions (decoding lives in :class:`DetectorHarness`)."""

    def __init__(self, backbone_width: int = 96, fpn_features: int = 64,
                 num_anchors: int = 2):
        super().__init__()
        w, f = backbone_width, fpn_features
        self.backbone_width = w
        self.num_anchors = num_anchors
        self.stem = ConvBN(3, w, 12, 4)
        self.c3_1 = ResBlock(w, w, 2)
        self.c3_2 = ResBlock(w, w, 1)
        self.c4_1 = ResBlock(w, 2 * w, 2)
        self.c4_2 = ResBlock(2 * w, 2 * w, 1)
        self.c5_1 = ResBlock(2 * w, 4 * w, 2)
        self.c5_2 = ResBlock(4 * w, 4 * w, 1)
        self.lat5 = ConvBN(4 * w, f, 1, act=False)
        self.lat4 = ConvBN(2 * w, f, 1, act=False)
        self.lat3 = ConvBN(w, f, 1, act=False)
        self.smooth4 = ConvBN(f, f, 3)
        self.smooth3 = ConvBN(f, f, 3)
        for i in range(3):
            self.add_module(f"ssh{i}", SSH(f, f))
            # one 1x1 conv per level: [score | 4 box | 10 ldm] per anchor
            self.add_module(f"head{i}", Conv(f, 15 * num_anchors, 1))

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x: (B, 3, H, W) normalized pixels."""
        x = self.stem(x)
        c3 = self.c3_2(self.c3_1(x))
        c4 = self.c4_2(self.c4_1(c3))
        c5 = self.c5_2(self.c5_1(c4))
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _up2(p5)
        p3 = self.lat3(c3) + _up2(p4)
        p4 = self.smooth4(p4)
        p3 = self.smooth3(p3)
        outs = []
        for i, p in enumerate((p3, p4, p5)):
            head = getattr(self, f"head{i}")(getattr(self, f"ssh{i}")(p))
            b, _, hh, ww = head.shape
            # the heads come back to float32 at any compute dtype
            head = head.permute(0, 2, 3, 1).reshape(
                b, hh * ww * self.num_anchors, 15).float()
            outs.append({"score": head[..., 0], "box": head[..., 1:5],
                         "ldm": head[..., 5:15]})
        return outs


def fit_input_size(height: int, width: int, long_side: int = 512,
                   multiple: int = 32) -> Tuple[int, int]:
    """Smallest detector input matching the frame's aspect ratio (long
    side scaled to ``long_side``, never upscaled, each side rounded up
    to the stride multiple)."""
    scale = min(1.0, long_side / max(height, width))
    rnd = lambda v: max(multiple, int(np.ceil(v * scale / multiple)) * multiple)
    return rnd(height), rnd(width)


@functools.lru_cache(maxsize=None)
def anchor_centers(input_size: Tuple[int, int]) -> np.ndarray:
    """All anchors as (A, 4) [cx, cy, w, h] in input pixels, level-major,
    row-major within a level, anchor-minor — matching the head
    reshape."""
    h, w = input_size
    all_anchors = []
    for stride, sizes in zip(STRIDES, ANCHOR_SIZES):
        gh, gw = h // stride, w // stride
        ys = (np.arange(gh) + 0.5) * stride
        xs = (np.arange(gw) + 0.5) * stride
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        centers = np.stack([cx, cy], axis=-1).reshape(gh * gw, 1, 2)
        whs = np.array([[s, s] for s in sizes], np.float32)
        grid = np.concatenate(
            [np.broadcast_to(centers, (gh * gw, len(sizes), 2)),
             np.broadcast_to(whs[None], (gh * gw, len(sizes), 2))],
            axis=-1).reshape(-1, 4)
        all_anchors.append(grid.astype(np.float32))
    return np.concatenate(all_anchors, axis=0)


def decode_scores_boxes(raw: List[Dict[str, torch.Tensor]],
                        anchors: torch.Tensor):
    """→ (scores (B,A), boxes (B,A,4) xyxy, raw landmarks (B,A,10))."""
    score = torch.cat([o["score"] for o in raw], dim=1)
    box = torch.cat([o["box"] for o in raw], dim=1)
    ldm_raw = torch.cat([o["ldm"] for o in raw], dim=1)
    a_cx, a_cy, a_w, a_h = anchors.unbind(-1)
    v0, v1 = VARIANCES
    cx = a_cx + box[..., 0] * v0 * a_w
    cy = a_cy + box[..., 1] * v0 * a_h
    w = a_w * torch.exp((box[..., 2] * v1).clamp(-10, 6))
    h = a_h * torch.exp((box[..., 3] * v1).clamp(-10, 6))
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)
    return torch.sigmoid(score), xyxy, ldm_raw


def decode_landmarks(ldm_raw: torch.Tensor, anchors: torch.Tensor
                     ) -> torch.Tensor:
    """(..., 10) raw landmark offsets + (..., 4) anchors → (..., 5, 2)."""
    a_cx, a_cy, a_w, a_h = anchors.unbind(-1)
    v0 = VARIANCES[0]
    ldm = ldm_raw.reshape(*ldm_raw.shape[:-1], 5, 2)
    lx = a_cx[..., None] + ldm[..., 0] * v0 * a_w[..., None]
    ly = a_cy[..., None] + ldm[..., 1] * v0 * a_h[..., None]
    return torch.stack([lx, ly], dim=-1)


class Detections(NamedTuple):
    """Padded per-frame detections (leading batch axis)."""

    boxes: torch.Tensor      # (B, D, 4) float32, display coords
    scores: torch.Tensor     # (B, D)
    landmarks: torch.Tensor  # (B, D, 5, 2)
    valid: torch.Tensor      # (B, D) bool


@functools.lru_cache(maxsize=None)
def _anchors_on(input_size: Tuple[int, int],
                device: torch.device) -> torch.Tensor:
    """:func:`anchor_centers` on ``device``, uploaded once (a block step
    captured in a CUDA graph may not copy from the host)."""
    return torch.from_numpy(anchor_centers(input_size)).to(device)


@functools.lru_cache(maxsize=None)
def _frame_limits(w: int, h: int, device: torch.device) -> torch.Tensor:
    """[w, h, w, h] as float32 on ``device``, uploaded once."""
    return torch.tensor([w, h, w, h], dtype=torch.float32, device=device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered at idx (B, K) along axis 1."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) pixels in [0, 255] → the detector's (B, 3, H, W)
    input in ``dtype``: (x − 127.5) / 128, as the JAX package's."""
    return ((images.to(dtype) - 127.5) / 128.0).permute(0, 3, 1, 2)


@dataclasses.dataclass
class DetectorHarness:
    """Pixels → padded detections: letterbox, forward, decode, filter,
    NMS (the reference's filters: score > ``score_threshold``, size ≥
    ``min_face_size``)."""

    model: FaceDetector
    input_size: Tuple[int, int] = (512, 512)
    max_detections: int = 16
    score_threshold: float = 0.95
    min_face_size: float = 20.0
    nms_iou: float = 0.4
    # NMS candidates; None = 8 × max_detections (≥ 128)
    n_candidates: Optional[int] = None

    @classmethod
    def create(cls, seed: int = 0, backbone_width: int = 96, device=None,
               dtype: torch.dtype = torch.float32,
               **kwargs) -> "DetectorHarness":
        """Random-initialised harness (weights from ``seed``, drawn in
        float32, then cast to the compute ``dtype``), on the card unless
        ``device="cpu"`` is asked for."""
        model = FaceDetector(backbone_width=backbone_width)
        init_weights(model, torch.Generator().manual_seed(seed))
        model = cast_float_tree(model, dtype)
        return cls(model=model.to(resolve_device(device)).eval(), **kwargs)

    @classmethod
    def from_npz(cls, path: str, device=None,
                 dtype: torch.dtype = torch.float32,
                 **kwargs) -> "DetectorHarness":
        """Harness with the weights of a single-file Flax checkpoint
        (``facerec_tpu/models/weights.py:save_params_npz`` or
        :func:`facerec_torch.models.convert.save_params_npz`), on the
        card unless ``device="cpu"`` is asked for.  The model arguments
        come from a ``<name>.model.json`` beside it when there is one
        (the distiller writes it), else the width from the stem."""
        from facerec_torch.models.convert import (load_flax_npz,
                                                  state_dict_from_flax)

        if not str(path).endswith(".npz"):
            raise ValueError(f"expected a .npz detector checkpoint, got "
                             f"{path!r} (orbax import is not ported)")
        tree = load_flax_npz(path)
        # a distilled checkpoint carries its model arguments beside it
        # (train/distill.py); otherwise the width is the stem's
        sidecar = str(path)[:-len(".npz")] + ".model.json"
        model_kwargs = {}
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                model_kwargs = json.load(f)
        model_kwargs.setdefault("backbone_width", int(np.asarray(
            tree["params"]["stem"]["Conv_0"]["kernel"]).shape[-1]))
        model = FaceDetector(**model_kwargs)
        model.load_state_dict(state_dict_from_flax(model, tree))
        model = cast_float_tree(model, dtype)
        return cls(model=model.to(resolve_device(device)).eval(), **kwargs)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the weights."""
        return next(self.model.parameters()).dtype

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> Detections:
        """(B, H, W, 3) uint8 frames at display resolution, on the
        model's device → detections in display coordinates.  The
        letterbox and the network run in the compute dtype; the decode,
        the filters and NMS in float32.  No host read and no upload
        after the first call at a shape."""
        b, h, w, _ = frames.shape
        ih, iw = self.input_size
        # never upscale: smaller frames are padded
        scale = min(1.0, ih / h, iw / w)
        sh, sw = int(round(h * scale)), int(round(w * scale))

        dtype = self.dtype
        x = frames.to(torch.float32).permute(0, 3, 1, 2)
        if (sh, sw) != (h, w):
            # jax.image.resize anti-aliases on a downscale.  At a
            # reduced compute dtype the JAX package resizes in it; here
            # the resize computes in float32 and its output is rounded
            # to it (PyTorch has no bfloat16 anti-aliased resize on the
            # CPU)
            x = F.interpolate(x, size=(sh, sw), mode="bilinear",
                              align_corners=False, antialias=True)
        x = F.pad(x.to(dtype), (0, iw - sw, 0, ih - sh))

        # the padded batch viewed as NHWC pixels (no copy)
        raw = self.model(normalize_images(x.permute(0, 2, 3, 1), dtype))
        anchors = _anchors_on(tuple(self.input_size), frames.device)
        scores, boxes, ldm_raw = decode_scores_boxes(raw, anchors)
        boxes = boxes / scale
        # clamp to the frame before the size filter
        boxes = torch.minimum(boxes.clamp_min(0.0),
                              _frame_limits(w, h, frames.device))

        wh = torch.minimum(boxes[..., 2] - boxes[..., 0],
                           boxes[..., 3] - boxes[..., 1])
        keep = (scores > self.score_threshold) & (wh >= self.min_face_size)
        masked = torch.where(keep, scores, -1.0)

        n_cand = self.n_candidates or max(128, 8 * self.max_detections)
        n_cand = min(n_cand, masked.shape[1])
        # a stable sort breaks ties toward the lower index, as
        # lax.top_k does, so the -1-masked candidates match too
        top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :n_cand], top_idx[:, :n_cand]
        top_boxes = _take(boxes, top_idx)
        top_ldm = decode_landmarks(_take(ldm_raw, top_idx),
                                   anchors[top_idx]) / scale

        idx, valid = nms(top_boxes, top_scores, self.nms_iou,
                         self.max_detections)
        sel_scores = _take(top_scores, idx)
        return Detections(_take(top_boxes, idx), sel_scores,
                          _take(top_ldm, idx),
                          valid & (sel_scores > self.score_threshold))
