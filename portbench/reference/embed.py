"""Face crops and the four FaceNet embeddings, plainly.

The crop of a saved face is its rounded box widened by 8 px a side
(clipped to the frame), resampled to 160x160 bilinearly with half-pixel
centres: on each axis the taps are i0 = clip(floor(src)) and
i1 = clip(i0 + 1) with weights 1 - t and t (t = src - floor(src)),
computed here by gathering the two neighbours.  Each crop is
standardised over all its pixels and channels (population std, at
least 1e-6), run through Inception-ResNet-v1 and L2-normalised.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.nets import FaceNet

SIZE = 160
MARGIN = 8.0


def crop_box(box: Sequence[int], width: int, height: int) -> List[float]:
    x1, y1, x2, y2 = box
    return [max(x1 - MARGIN, 0.0), max(y1 - MARGIN, 0.0),
            min(x2 + MARGIN, float(width)), min(y2 + MARGIN, float(height))]


def _taps(lo, hi, n: int, device):
    g = torch.arange(SIZE, dtype=torch.float32, device=device) + 0.5
    src = lo[:, None] + g[None] * ((hi - lo) / SIZE)[:, None] - 0.5
    f0 = torch.floor(src)
    t = src - f0
    i0 = f0.long().clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)          # from the clamped tap
    return i0, i1, t


def crops(frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """frames (N, H, W, 3) uint8, one a crop; boxes (N, 4) float32 →
    (N, 160, 160, 3) float32."""
    n, h, w, _ = frames.shape
    x0, x1, tx = _taps(boxes[:, 0], boxes[:, 2], w, frames.device)
    y0, y1, ty = _taps(boxes[:, 1], boxes[:, 3], h, frames.device)
    f = frames.float()
    idx = torch.arange(n, device=frames.device)[:, None, None]

    def at(yy, xx):
        return f[idx, yy[:, :, None], xx[:, None, :]]

    top = (at(y0, x0) * (1 - tx)[:, None, :, None]
           + at(y0, x1) * tx[:, None, :, None])
    bot = (at(y1, x0) * (1 - tx)[:, None, :, None]
           + at(y1, x1) * tx[:, None, :, None])
    return top * (1 - ty)[:, :, None, None] + bot * ty[:, :, None, None]


class Embedders:
    """The four checkpoints from their state dicts (``{name: (dim,
    state_dict)}``)."""

    def __init__(self, weights: Dict[str, tuple], device: torch.device):
        self.nets = {}
        for name, (dim, sd) in weights.items():
            net = FaceNet(dim)
            net.load_state_dict(sd)
            self.nets[name] = net.to(device).eval()
        self.device = device

    @torch.no_grad()
    def __call__(self, crop_px: torch.Tensor, batch: int = 64
                 ) -> Dict[str, np.ndarray]:
        x = crop_px.to(self.device)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = ((x - mean) / std.clamp_min(1e-6)).permute(0, 3, 1, 2)
        out = {}
        for name, net in self.nets.items():
            e = torch.cat([net(c) for c in x.split(batch)])
            e = e / torch.linalg.vector_norm(e, dim=1, keepdim=True
                                             ).clamp_min(1e-12)
            out[name] = e.cpu().numpy().astype(np.float64)
        return out
