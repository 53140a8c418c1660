"""ArcFace IResNet-100 and its five-point alignment, plainly.

The network is insightface's ``iresnet100``
(``recognition/arcface_torch/backbones/iresnet.py``; Deng et al.,
arXiv:1801.07698), written out from its layer list over a state dict
with the published parameter names: a 3x3 stem to 64 channels with batch
norm and PReLU; four stages of ``IBasicBlock`` ([3, 13, 30, 3] at widths
64, 128, 256, 512), a block being BN, 3x3 conv, BN, PReLU, 3x3 conv
(carrying the stage's stride 2 in its first block), BN, plus the
identity (a strided 1x1 conv and BN in each stage's first block), with
no activation after the sum; then BN, the 512x7x7 map flattened channel
first, a dense layer to 512 and a batch norm whose scale is 1.  Every
batch norm has eps 1e-5 and runs on its running statistics.

The crop is insightface's ``face_align.norm_crop``: the least-squares
similarity from the face's five landmarks to ``TEMPLATE`` (Umeyama's
solution by SVD, as skimage's ``SimilarityTransform.estimate``), then
``cv2.warpAffine``'s bilinear sampling, each output pixel (x, y) taken
at the inverse map of (x, y, 1) with integer pixel centres and zeros
outside the frame, here in float64 at the exact point (OpenCV rounds
its taps to 1/32 px), gathered as four taps.  A set of landmarks whose
spread sum |a - mean(a)|^2 is below ``DEGENERATE`` px^2 has no such
similarity: it is mapped by the translation that takes its mean onto
the template's.  Pixels are scaled as (x - 127.5) / 127.5.

It imports nothing of the program.  The caller sets the float32
precision (``portbench.reference.pipeline.precision``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SIZE = 112
# insightface's arcface_dst, in pixels of the 112x112 crop
TEMPLATE = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                     [56.0252, 71.7366], [41.5493, 92.3655],
                     [70.7299, 92.2041]], np.float64)
LAYERS = (3, 13, 30, 3)
WIDTHS = (64, 128, 256, 512)
FEATURES = 512
EPS = 1e-5
DEGENERATE = 1e-6


def _bn_shapes(prefix: str, n: int) -> Dict[str, tuple]:
    return {f"{prefix}.weight": (n,), f"{prefix}.bias": (n,),
            f"{prefix}.running_mean": (n,), f"{prefix}.running_var": (n,),
            f"{prefix}.num_batches_tracked": ()}


def shapes(layers: Sequence[int] = LAYERS) -> Dict[str, tuple]:
    """{name: shape} of the published state dict, in its order."""
    out = {"conv1.weight": (64, 3, 3, 3)}
    out.update(_bn_shapes("bn1", 64))
    out["prelu.weight"] = (64,)
    cin = 64
    for s, (n, width) in enumerate(zip(layers, WIDTHS)):
        for i in range(n):
            k = f"layer{s + 1}.{i}"
            out.update(_bn_shapes(f"{k}.bn1", cin))
            out[f"{k}.conv1.weight"] = (width, cin, 3, 3)
            out.update(_bn_shapes(f"{k}.bn2", width))
            out[f"{k}.prelu.weight"] = (width,)
            out[f"{k}.conv2.weight"] = (width, width, 3, 3)
            out.update(_bn_shapes(f"{k}.bn3", width))
            if i == 0:
                out[f"{k}.downsample.0.weight"] = (width, cin, 1, 1)
                out.update(_bn_shapes(f"{k}.downsample.1", width))
            cin = width
    out.update(_bn_shapes("bn2", WIDTHS[-1]))
    flat = WIDTHS[-1] * (SIZE >> len(layers)) ** 2
    out["fc.weight"] = (FEATURES, flat)
    out["fc.bias"] = (FEATURES,)
    out.update(_bn_shapes("features", FEATURES))
    return out


def _bn(x, sd, key):
    return F.batch_norm(x, sd[f"{key}.running_mean"],
                        sd[f"{key}.running_var"], sd[f"{key}.weight"],
                        sd[f"{key}.bias"], False, 0.0, EPS)


def trunk(sd, x, layers: Sequence[int] = LAYERS) -> List[torch.Tensor]:
    """(N, 3, 112, 112) → the stem's output and each stage's."""
    x = F.conv2d(x, sd["conv1.weight"], padding=1)
    x = F.prelu(_bn(x, sd, "bn1"), sd["prelu.weight"])
    out = [x]
    for s, n in enumerate(layers):
        for i in range(n):
            k = f"layer{s + 1}.{i}"
            y = F.conv2d(_bn(x, sd, f"{k}.bn1"), sd[f"{k}.conv1.weight"],
                         padding=1)
            y = F.prelu(_bn(y, sd, f"{k}.bn2"), sd[f"{k}.prelu.weight"])
            y = F.conv2d(y, sd[f"{k}.conv2.weight"], stride=2 if i == 0
                         else 1, padding=1)
            y = _bn(y, sd, f"{k}.bn3")
            if i == 0:
                x = _bn(F.conv2d(x, sd[f"{k}.downsample.0.weight"],
                                 stride=2), sd, f"{k}.downsample.1")
            x = y + x
        out.append(x)
    return out


def head(sd, x):
    """The last stage's (N, 512, 7, 7) → (N, 512) features."""
    x = _bn(x, sd, "bn2").flatten(1)
    return _bn(F.linear(x, sd["fc.weight"], sd["fc.bias"]), sd, "features")


def network(sd, x, layers: Sequence[int] = LAYERS):
    return head(sd, trunk(sd, x, layers)[-1])


def flops(layers: Sequence[int] = LAYERS) -> int:
    """Model FLOPs of one crop: two per multiply-accumulate of every
    convolution and the dense layer, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.empty(s, device="meta")
          for k, s in shapes(layers).items()}
    counter = FlopCounterMode(display=False)
    with counter:
        network(sd, torch.empty((1, 3, SIZE, SIZE), device="meta"), layers)
    return int(counter.get_total_flops())


def similarity(landmarks) -> np.ndarray:
    """(5, 2) landmarks → the (2, 3) float64 map onto ``TEMPLATE``:
    Umeyama's least-squares similarity by SVD, or the translation of a
    degenerate set."""
    src = np.asarray(landmarks, np.float64)
    dst = TEMPLATE
    sm, dm = src.mean(0), dst.mean(0)
    sc, dc = src - sm, dst - dm
    if (sc ** 2).sum() < DEGENERATE:
        return np.hstack([np.eye(2), (dm - sm)[:, None]])
    a = dc.T @ sc / len(src)
    d = np.ones(2)
    if np.linalg.det(a) < 0:
        d[1] = -1.0
    u, s, vt = np.linalg.svd(a)
    r = u @ np.diag(d) @ vt
    scale = (s @ d) / sc.var(0).sum()
    return np.hstack([scale * r, (dm - scale * r @ sm)[:, None]])


def warp(frames: torch.Tensor, maps: np.ndarray) -> torch.Tensor:
    """frames (N, H, W, 3) uint8, one a crop; maps (N, 2, 3) frame →
    crop → (N, 3, 112, 112) float32 scaled crops."""
    n, h, w, _ = frames.shape
    dev = frames.device
    full = np.zeros((n, 3, 3))
    full[:, :2] = maps
    full[:, 2, 2] = 1.0
    inv = torch.from_numpy(np.linalg.inv(full)).to(dev)
    g = torch.arange(SIZE, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    sx = (inv[:, 0, 0, None, None] * xx + inv[:, 0, 1, None, None] * yy
          + inv[:, 0, 2, None, None])
    sy = (inv[:, 1, 0, None, None] * xx + inv[:, 1, 1, None, None] * yy
          + inv[:, 1, 2, None, None])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    f = frames.to(torch.float64)
    idx = torch.arange(n, device=dev)[:, None, None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        return f[idx, yc, xc] * inside[..., None]

    fx, fy = fx[..., None], fy[..., None]
    v = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
         + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    return ((v - 127.5) / 127.5).permute(0, 3, 1, 2).float().contiguous()


class Embedder:
    """The network from a state dict on ``device``: frames and faces
    (``frame``, float ``landmarks`` (5, 2)) → L2-normalised (n, 512)
    float64, ``batch`` crops a forward."""

    def __init__(self, state_dict, device: torch.device,
                 layers: Sequence[int] = LAYERS):
        self.sd = {k: v.to(device) for k, v in state_dict.items()}
        self.layers = layers

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor, faces, batch: int = 64
                 ) -> np.ndarray:
        out = []
        for a in range(0, len(faces), batch):
            part = faces[a:a + batch]
            idx = torch.tensor([f["frame"] for f in part],
                               device=frames.device)
            maps = np.stack([similarity(f["landmarks"]) for f in part])
            e = network(self.sd, warp(frames[idx], maps), self.layers)
            e = e / torch.linalg.vector_norm(e, dim=1, keepdim=True
                                             ).clamp_min(1e-12)
            out.append(e.cpu().numpy().astype(np.float64))
        return np.concatenate(out)
