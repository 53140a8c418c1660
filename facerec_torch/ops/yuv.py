"""The delta wire formats: host encode (numpy) and device decode (torch).

Port of ``facerec_tpu/ops/yuv.py``.  The ``rgb-delta`` wire ships each
block of RGB frames with frames 1..B-1 stored as uint8 wraparound
differences from the previous frame; the device undoes them exactly.
The ``yuv420-delta`` wire does the same over I420 planes (1.5 bytes a
pixel instead of 3) and then converts BT.601 limited range to RGB on
the device.  Both were built to save link bandwidth; on the port they
keep the JAX package's options and its bytes.

The device half is plain tensor code (the JAX decode is XLA code
outside any Pallas kernel).  :func:`i420_to_rgb` reproduces the jitted
JAX function bit for bit: XLA's CPU backend contracts some of its
products into fused multiply-adds, and this module redoes exactly those
roundings in float64, where every product and sum of these float32
values is exact.

The host half copies OpenCV's fixed-point I420 conversions in numpy
(``cvtColor`` with ``COLOR_RGB2YUV_I420``, ``COLOR_BGR2YUV_I420`` and
``COLOR_YUV2RGB_I420``), byte for byte, because the card's host has no
OpenCV.
"""
from __future__ import annotations

import numpy as np
import torch

# BT.601 limited range, as the JAX package writes them (float32)
_CY, _CVR, _CVG, _CUG, _CUB = (float(np.float32(c)) for c in
                               (1.164, 1.596, 0.813, 0.391, 2.018))

# OpenCV's fixed point (imgproc/src/color_yuv.simd.hpp, ITUR_BT_601_*)
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_FX_CY, _FX_CUB, _FX_CUG, _FX_CVG, _FX_CVR = (1220542, 2116026, -409993,
                                              -852492, 1673527)
_FX_CRY, _FX_CGY, _FX_CBY = 269484, 528482, 102760
_FX_CRU, _FX_CGU, _FX_CBU = -155188, -305135, 460324
_FX_CGV, _FX_CBV = -385875, -74448


def i420_rows(height: int) -> int:
    """Rows of one frame's I420 image: the Y plane (H rows), then the U
    and V planes, each (H/2)·(W/2) bytes, packed at full width."""
    if height % 2:
        raise ValueError(f"I420 needs even height, got {height}")
    return height + height // 2


def _planes(yuv, height: int):
    """(Y (..., H, W), U, V (..., H/2, W/2)) views of I420 frames."""
    *lead, rows, w = yuv.shape
    if rows != i420_rows(height) or w % 2:
        raise ValueError(f"bad I420 shape {tuple(yuv.shape)} for height "
                         f"{height}")
    n, q = height * w, (height // 2) * (w // 2)
    flat = yuv.reshape(*lead, rows * w)
    return (flat[..., :n].reshape(*lead, height, w),
            flat[..., n:n + q].reshape(*lead, height // 2, w // 2),
            flat[..., n + q:n + 2 * q].reshape(*lead, height // 2, w // 2))


def delta_decode(delta: torch.Tensor) -> torch.Tensor:
    """Undo a block's temporal delta: (B, ...) uint8 where frames 1..B-1
    are wraparound differences from the previous frame → absolute
    frames.  Exact: an int32 cumulative sum (B·255 < 2^31) mod 256."""
    return torch.remainder(torch.cumsum(delta, dim=0, dtype=torch.int32),
                           256).to(torch.uint8)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """Round float64 values to float32 and back (exact in float64)."""
    return t.float().double()


def i420_to_rgb(yuv: torch.Tensor, height: int) -> torch.Tensor:
    """(B, H·3/2, W) uint8 I420 frames → (B, H, W, 3) uint8 RGB.

    BT.601 limited range with 2×2 nearest chroma, ``max(Y − 16, 0)``,
    round half to even, clip.  The roundings are those of the jitted JAX
    function on the CPU, where XLA keeps ``1.164·Y`` unrounded in G only
    and fuses the chroma product into the sum in R, B and G's last
    term::

      R = fma(1.596, V, f32(1.164·Y))
      G = fma(−0.391, U, fma(1.164, Y, −f32(0.813·V)))
      B = fma(2.018, U, f32(1.164·Y))
    """
    y, u, v = _planes(yuv, height)
    up = lambda t: t.repeat_interleave(2, -2).repeat_interleave(2, -1)
    u = up(u.double() - 128.0)
    v = up(v.double() - 128.0)
    yl = _CY * (y.double() - 16.0).clamp_min(0.0)
    yl32 = _f32(yl)
    r = _f32(yl32 + _CVR * v)
    g = _f32(_f32(yl - _f32(_CVG * v)) - _CUG * u)
    b = _f32(yl32 + _CUB * u)
    rgb = torch.stack([r, g, b], dim=-1).float()
    return torch.round(rgb).clamp(0.0, 255.0).to(torch.uint8)


def delta_i420_to_rgb(delta: torch.Tensor, height: int) -> torch.Tensor:
    """The whole yuv420-delta decode: delta-I420 block → uint8 RGB."""
    return i420_to_rgb(delta_decode(delta), height)


def encode_delta(block: np.ndarray) -> np.ndarray:
    """Host temporal delta of an absolute block (I420 planes or RGB
    frames): frame 0 stays, frames 1..B-1 become uint8 wraparound
    differences (what :func:`delta_decode` undoes).  The repo's native
    library does it multithreaded when it loads
    (:func:`facerec_torch.runtime.native.delta_u8`), numpy otherwise;
    both give the same bytes (:func:`encode_path` says which runs)."""
    block = np.ascontiguousarray(block)
    if block.dtype == np.uint8:
        from facerec_torch.runtime import native

        delta = np.empty_like(block)
        if native.delta_u8(block, delta):
            return delta
    delta = block.copy()
    delta[1:] -= block[:-1]
    return delta


def encode_path() -> str:
    """``"native"`` when :func:`encode_delta` runs the native library,
    else ``"numpy"``."""
    from facerec_torch.runtime import native

    return "native" if native.delta_available() else "numpy"


def rgb_to_i420(frames: np.ndarray, bgr: bool = False) -> np.ndarray:
    """(..., H, W, 3) uint8 RGB (or BGR) → (..., H·3/2, W) I420: OpenCV's
    ``COLOR_RGB2YUV_I420`` / ``COLOR_BGR2YUV_I420`` in numpy, byte for
    byte.  Chroma is taken from the top-left pixel of each 2×2 block."""
    *lead, h, w, _ = frames.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even frame sizes, got {w}x{h}")
    if lead:
        # frame by frame: the int32 planes of one frame stay in cache
        out = np.empty((*lead, i420_rows(h), w), np.uint8)
        for idx in np.ndindex(*lead):
            out[idx] = rgb_to_i420(frames[idx], bgr)
        return out
    px = frames.astype(np.int32)
    r, g, b = (px[..., i] for i in ((2, 1, 0) if bgr else (0, 1, 2)))
    y = (_FX_CRY * r + _FX_CGY * g + _FX_CBY * b + _HALF
         + (16 << _SHIFT)) >> _SHIFT
    r0, g0, b0 = (c[0::2, 0::2] for c in (r, g, b))
    u = (_FX_CRU * r0 + _FX_CGU * g0 + _FX_CBU * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    v = (_FX_CBU * r0 + _FX_CGV * g0 + _FX_CBV * b0 + _HALF
         + (128 << _SHIFT)) >> _SHIFT
    planes = [np.clip(p, 0, 255).astype(np.uint8).reshape(-1)
              for p in (y, u, v)]
    return np.concatenate(planes).reshape(i420_rows(h), w)


def i420_frame_to_rgb(frame_i420: np.ndarray) -> np.ndarray:
    """One absolute (H·3/2, W) I420 frame → (H, W, 3) uint8 RGB: OpenCV's
    ``COLOR_YUV2RGB_I420`` in numpy, byte for byte (the face-image path
    of the yuv420-delta wire)."""
    rows, w = frame_i420.shape
    height = rows * 2 // 3
    y, u, v = _planes(frame_i420, height)
    up = lambda p: np.repeat(np.repeat(p.astype(np.int32) - 128, 2, 0), 2, 1)
    uu, vv = up(u), up(v)
    yy = np.maximum(y.astype(np.int32) - 16, 0) * _FX_CY
    out = np.empty((height, w, 3), np.uint8)
    for c, off in enumerate((_HALF + _FX_CVR * vv,
                             _HALF + _FX_CVG * vv + _FX_CUG * uu,
                             _HALF + _FX_CUB * uu)):
        out[..., c] = np.clip((yy + off) >> _SHIFT, 0, 255)
    return out


def encode_block(frames_rgb: np.ndarray) -> np.ndarray:
    """Host wire encode from RGB: (B, H, W, 3) uint8 → (B, H·3/2, W)
    delta-I420 (:func:`rgb_to_i420`, then :func:`encode_delta`)."""
    return encode_delta(rgb_to_i420(frames_rgb))
