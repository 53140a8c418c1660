"""Five-point face alignment for ArcFace: the hand-written CUDA kernel
``align_warp`` (``csrc/align.cu``) and its plain PyTorch version.

Each crop is insightface's ``face_align.norm_crop``: the least-squares
similarity x -> [[p, -q], [q, p]] x + t that takes the face's five
landmarks (display pixels, integer pixel centres) onto insightface's
112-px template ``TEMPLATE``, then ``cv2.warpAffine``'s bilinear
sampling: output pixel (x, y) is read at the inverse map of (x, y, 1),
a tap outside the frame reads 0.  Two departures from OpenCV: the
sampling point is exact (float64), where OpenCV rounds its taps to
1/32 px, and the values stay unrounded, where OpenCV writes uint8.  The
crops come out as (N, 3, 112, 112) float32 scaled as
(x - 127.5) / 127.5, the layout the network's stem takes.

The closed form is Umeyama's solution in two dimensions (the one that
skimage's ``SimilarityTransform.estimate`` computes by SVD): with a, b
the landmarks and the template less their means,
p = sum(a . b) / S and q = sum(a x b) / S, S = sum |a|^2.  A set whose
spread S is below ``DEGENERATE`` px^2 has no such map; it gets p = 1,
q = 0, the translation of its mean onto the template's (:func:`degenerate`
finds such sets on the host, for the ``align_degenerate`` counter).

The plain version repeats the kernel's float64 arithmetic operation for
operation (the kernel is built without fused multiply-adds), so the two
agree bit for bit where PyTorch divides exactly, as on the CPU (its CUDA
kernels multiply by a scalar divisor's reciprocal, which can move the
last bit).  :func:`align` takes a CPU tensor to the plain version and a
CUDA tensor to the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from facerec_torch.ops import _build

SIZE = 112
# insightface's arcface_dst, in pixels of the 112x112 crop
TEMPLATE = ((38.2946, 51.6963), (73.5318, 51.5014), (56.0252, 71.7366),
            (41.5493, 92.3655), (70.7299, 92.2041))
DEGENERATE = 1e-6   # px^2

# Launch count of the kernel (runtime/launches.py reads it).
launches: Dict[str, int] = {"align_warp": 0}

_lib = None


def degenerate(landmarks: np.ndarray) -> np.ndarray:
    """(N, 5, 2) landmarks → (N,) bool: spread below ``DEGENERATE``."""
    ldm = np.asarray(landmarks, np.float64)
    spread = ((ldm - ldm.mean(1, keepdims=True)) ** 2).sum((1, 2))
    return ~(spread >= DEGENERATE)


def inverse_maps(landmarks: torch.Tensor) -> torch.Tensor:
    """(N, 5, 2) float32 landmarks → (N, 6) float64 inverse maps
    (a11, a12, b1, a21, a22, b2): crop pixel → frame point, in the
    kernel's order of operations."""
    ldm = landmarks.to(torch.float64)
    n = len(TEMPLATE)
    mx = my = dmx = dmy = 0.0
    for i in range(n):
        mx = mx + ldm[:, i, 0]
        my = my + ldm[:, i, 1]
        dmx, dmy = dmx + TEMPLATE[i][0], dmy + TEMPLATE[i][1]
    mx, my, dmx, dmy = mx / n, my / n, dmx / n, dmy / n
    s = a = b = 0.0
    for i in range(n):
        ax, ay = ldm[:, i, 0] - mx, ldm[:, i, 1] - my
        bx, by = TEMPLATE[i][0] - dmx, TEMPLATE[i][1] - dmy
        s = s + (ax * ax + ay * ay)
        a = a + (ax * bx + ay * by)
        b = b + (ax * by - ay * bx)
    ok = s >= DEGENERATE
    safe = torch.where(ok, s, 1.0)
    p = torch.where(ok, a / safe, 1.0)
    q = torch.where(ok, b / safe, 0.0)
    tx = dmx - (p * mx - q * my)
    ty = dmy - (q * mx + p * my)
    # cv2.invertAffineTransform of [[p, -q, tx], [q, p, ty]]
    d = 1.0 / (p * p + q * q)
    a11, a12 = p * d, q * d
    a21, a22 = -q * d, p * d
    b1 = -(a11 * tx) - a12 * ty
    b2 = -(a21 * tx) - a22 * ty
    return torch.stack([a11, a12, b1, a21, a22, b2], 1)


def align_plain(frames: torch.Tensor, frame_idx: torch.Tensor,
                landmarks: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`align_warp`, on any device."""
    _check(frames, frame_idx, landmarks)
    n = landmarks.shape[0]
    h, w = frames.shape[1:3]
    m = inverse_maps(landmarks)[:, :, None, None]
    g = torch.arange(SIZE, dtype=torch.float64, device=frames.device)
    y, x = torch.meshgrid(g, g, indexing="ij")
    sx = (m[:, 0] * x + m[:, 1] * y) + m[:, 2]
    sy = (m[:, 3] * x + m[:, 4] * y) + m[:, 5]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    src = frames[frame_idx.long()]
    row = torch.arange(n, device=frames.device)[:, None, None]

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        px = src[row, yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
        return torch.where(inside[..., None], px.to(torch.float64), 0.0)

    fx, fy = fx[..., None], fy[..., None]
    gx = 1.0 - fx
    top = gx * tap(y0, x0) + fx * tap(y0, x0 + 1)
    bot = gx * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)
    v = (1.0 - fy) * top + fy * bot
    out = ((v - 127.5) / 127.5).to(torch.float32)
    return out.permute(0, 3, 1, 2).contiguous()


def _check(frames, frame_idx, landmarks) -> None:
    if frames.dim() != 4 or frames.shape[-1] != 3 \
            or frames.dtype != torch.uint8:
        raise ValueError(f"expected (B, H, W, 3) uint8 frames, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    n = frame_idx.shape[0]
    if frame_idx.dim() != 1 or frame_idx.dtype != torch.int64:
        raise ValueError("frame_idx must be (N,) int64")
    if landmarks.shape != (n, 5, 2) or landmarks.dtype != torch.float32:
        raise ValueError(f"landmarks must be ({n}, 5, 2) float32, got "
                         f"{tuple(landmarks.shape)} {landmarks.dtype}")
    if frame_idx.device != frames.device \
            or landmarks.device != frames.device:
        raise ValueError("frames, frame_idx and landmarks must share a "
                         "device")


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("align")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fr_align_warp.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.fr_align_warp.restype = i
        _lib = lib
    return _lib


def align_warp(frames: torch.Tensor, frame_idx: torch.Tensor,
               landmarks: torch.Tensor) -> torch.Tensor:
    """Kernel ``align_warp``: (B, H, W, 3) uint8 CUDA frames, (N,) int64
    frame indices into them (the caller checks their range) and (N, 5,
    2) float32 landmarks → (N, 3, 112, 112) float32 crops.  One launch,
    no host read."""
    _check(frames, frame_idx, landmarks)
    if frames.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got "
                         f"{frames.device}")
    frames, frame_idx, landmarks = (t.contiguous() for t in
                                    (frames, frame_idx, landmarks))
    lib = _kernels()
    b, h, w, _ = frames.shape
    n = int(landmarks.shape[0])
    with torch.cuda.device(frames.device):
        out = torch.empty((n, 3, SIZE, SIZE), dtype=torch.float32,
                          device=frames.device)
        if n:
            stream = torch.cuda.current_stream(frames.device).cuda_stream
            err = lib.fr_align_warp(frames.data_ptr(), frame_idx.data_ptr(),
                                    landmarks.data_ptr(), out.data_ptr(), n,
                                    b, h, w, stream)
            if err:
                raise RuntimeError(f"align_warp launch failed: "
                                   f"cudaError {err}")
            launches["align_warp"] += 1
    return out


def align(frames: torch.Tensor, frame_idx: torch.Tensor,
          landmarks: torch.Tensor) -> torch.Tensor:
    """The aligned crops: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if frames.device.type == "cpu":
        return align_plain(frames, frame_idx, landmarks)
    return align_warp(frames, frame_idx, landmarks)
