"""Fixed-shape greedy non-maximum suppression, batched over frames.

Port of ``facerec_tpu/ops/nms.py``: ``k`` argmax+suppress steps, each
over every frame of the batch at once (the JAX package vmaps the
per-frame scan).
"""
from __future__ import annotations

from typing import Tuple

import torch

from facerec_torch.ops.boxes import iou_broadcast

_NEG = -1e30


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per frame.

    Args:
        boxes: (B, N, 4) float32.
        scores: (B, N) float32; very negative for invalid boxes.
        iou_threshold: suppression overlap.
        k: outputs per frame (padded with invalid entries).

    Returns:
        (indices (B, k) int64 in descending score order, valid (B, k)
        bool).
    """
    scores_cur = scores.to(torch.float32).clone()
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    idx, sel = [], []
    for _ in range(k):
        i = torch.argmax(scores_cur, dim=1)
        sel.append(scores_cur[rows, i])
        overlap = iou_broadcast(boxes[rows, i][:, None, :], boxes)
        scores_cur = torch.where(overlap > iou_threshold, _NEG, scores_cur)
        # always drop the selected box (a scalar scatter: no host value
        # crosses to the card, so a CUDA graph can capture the step)
        scores_cur = scores_cur.scatter(1, i[:, None], _NEG)
        idx.append(i)
    return torch.stack(idx, 1), torch.stack(sel, 1) > _NEG / 2
