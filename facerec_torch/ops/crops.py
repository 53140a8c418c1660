"""Batched crop + bilinear resize as two float32 matrix products.

Port of ``facerec_tpu/ops/crops.py:crop_resize``: half-pixel centers
with edge clamping; each crop is ``Ry[n] @ frame[n] @ Rx[n]^T`` with
bilinear weight matrices (two nonzero weights per row).  The products
run in full float32: TF32 stays off (the JAX package contracts at
``Precision.HIGHEST``), so the extract entry point disables it.
"""
from __future__ import annotations

import torch


def _axis_weights(src: torch.Tensor, size: int) -> torch.Tensor:
    """(N, S) source coords → (N, S, size) bilinear weights with edge
    clamping."""
    f0 = torch.floor(src)
    t = src - f0
    i0 = f0.to(torch.int32).clamp(0, size - 1)
    i1 = (i0 + 1).clamp(0, size - 1)
    idx = torch.arange(size, dtype=torch.int32, device=src.device)
    w0 = torch.where(idx == i0[..., None], (1.0 - t)[..., None], 0.0)
    w1 = torch.where(idx == i1[..., None], t[..., None], 0.0)
    return w0 + w1


def crop_resize(frames: torch.Tensor, frame_idx: torch.Tensor,
                crop_boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Crop boxes out of a frame block and resize bilinearly.

    Args:
        frames: (B, H, W, C) uint8 or float.
        frame_idx: (N,) int — source frame per crop.
        crop_boxes: (N, 4) float32 [x1, y1, x2, y2], x2/y2 exclusive.
        out_size: output side length S.

    Returns:
        (N, S, S, C) float32 crops.
    """
    h, w = frames.shape[1:3]
    s = out_size
    x1, y1, x2, y2 = crop_boxes.to(torch.float32).unbind(1)
    grid = torch.arange(s, dtype=torch.float32, device=frames.device) + 0.5
    src_x = x1[:, None] + grid[None, :] * ((x2 - x1) / s)[:, None] - 0.5
    src_y = y1[:, None] + grid[None, :] * ((y2 - y1) / s)[:, None] - 0.5
    rx = _axis_weights(src_x, w)                      # (N, S, W)
    ry = _axis_weights(src_y, h)                      # (N, S, H)

    g = frames[frame_idx.long()].to(torch.float32)    # (N, H, W, C)
    n, c = g.shape[0], g.shape[3]
    cols = rx[:, None] @ g                            # (N, H, S, C)
    out = ry @ cols.reshape(n, h, s * c)              # (N, S, S*C)
    return out.reshape(n, s, s, c)
