"""Raw histogram equalization of luminance planes: the hand-written
CUDA kernels ``hist256`` + ``cum_lookup`` (``csrc/equalize.cu``) and
their plain PyTorch version.

Counterpart of ``facerec_tpu/ops/pallas/equalize.py`` (the three Pallas
kernels ``_fused_kernel``, ``_hist_kernel``, ``_eq_kernel``) and of the
bincount path of ``facerec_tpu/ops/scene.py:_equalize_raw``.  The TPU
kernels' lane fold (``FACEREC_EQ_FOLD``) is a knob for the TPU's tiled
layout and is not ported.

:func:`equalize_stats` takes a CPU tensor to the plain version and a
CUDA tensor to the kernels; it never moves data between the two.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from facerec_torch.ops import _build

ROWS = 8              # row multiple of a packed plane
BINS = 256
# pixels one CTA covers (a few row strips); enough CTAs per frame to
# fill the card at the main path's (128, 384, 768) block
_CTA_PIXELS = 16384

# Launch counts of the kernels, one per launch; chip_smoke.py zeroes
# them before the main path and reads them after.
launches: Dict[str, int] = {"hist256": 0, "cum_lookup": 0}

_lib = None


def pack_planes(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 → (B, R, W): rows padded to a multiple of 8 with
    -1, the padding sentinel of the equalize kernels."""
    h = y.shape[1]
    hp = (h + ROWS - 1) // ROWS * ROWS
    if hp != h:
        y = F.pad(y, (0, 0, 0, hp - h), value=-1.0)
    return y


def _bins(y_packed: torch.Tensor) -> torch.Tensor:
    """(B, R, W) → (B, R*W) int32 bins; padding (y < 0) → 256."""
    flat = y_packed.reshape(y_packed.shape[0], -1)
    return torch.where(flat < 0.0, BINS,
                       flat.to(torch.int32).clamp(0, BINS - 1))


def hist256_plain(y_packed: torch.Tensor) -> torch.Tensor:
    """Plain version of ``hist256``: one bincount over frame-offset
    bins → (B, 256) int32 counts of the non-padding pixels."""
    b = y_packed.shape[0]
    offs = torch.arange(b, device=y_packed.device)[:, None] * (BINS + 1)
    counts = torch.bincount((_bins(y_packed) + offs).reshape(-1),
                            minlength=b * (BINS + 1))
    return counts.reshape(b, BINS + 1)[:, :BINS].to(torch.int32)


def cum_lookup_plain(y_packed: torch.Tensor, hist: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``cum_lookup``: cumsum + gather."""
    idx = _bins(y_packed)
    cum = torch.cumsum(hist.to(torch.float32), dim=-1)
    eq_raw = torch.where(
        idx == BINS, 0.0, torch.gather(cum, 1, idx.clamp_max(BINS - 1).long()))
    return eq_raw.reshape(y_packed.shape), cum


def equalize_stats_plain(y_packed: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`equalize_stats`: the bincount +
    cumsum + gather of ``facerec_tpu/ops/scene.py:_equalize_raw``
    (exact integer counts in float32)."""
    return cum_lookup_plain(y_packed, hist256_plain(y_packed))


def _check(y: torch.Tensor) -> None:
    if y.dim() != 3:
        raise ValueError(f"expected a (B, R, W) plane, got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("expected a contiguous plane")
    b, r, w = y.shape
    if r % ROWS or r == 0 or b == 0 or w == 0:
        raise ValueError(
            f"rows must be a positive multiple of {ROWS} (pack_planes); "
            f"got {tuple(y.shape)}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")


def _check_cuda(y: torch.Tensor) -> None:
    _check(y)
    if y.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {y.device}")


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("equalize")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fr_hist256.argtypes = [vp, vp, i, i, i, i, vp]
        lib.fr_hist256.restype = i
        lib.fr_cum_lookup.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
        lib.fr_cum_lookup.restype = i
        _lib = lib
    return _lib


def rows_per_cta(width: int) -> int:
    return max(1, _CTA_PIXELS // width)


def hist256(y: torch.Tensor) -> torch.Tensor:
    """Kernel ``hist256``: (B, R, W) CUDA plane → (B, 256) int32 counts
    of the non-padding pixels."""
    _check_cuda(y)
    lib = _kernels()
    b, r, w = y.shape
    hist = torch.zeros((b, BINS), dtype=torch.int32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.fr_hist256(y.data_ptr(), hist.data_ptr(), b, r, w,
                         rows_per_cta(w), stream)
    if err:
        raise RuntimeError(f"hist256 launch failed: cudaError {err}")
    launches["hist256"] += 1
    return hist


def cum_lookup(y: torch.Tensor, hist: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``cum_lookup``: plane + (B, 256) int32 counts → (eq_raw
    (B, R, W) f32, cum (B, 256) f32)."""
    _check_cuda(y)
    lib = _kernels()
    b, r, w = y.shape
    if hist.shape != (b, BINS) or hist.dtype != torch.int32 \
            or hist.device != y.device or not hist.is_contiguous():
        raise ValueError("hist must be a contiguous (B, 256) int32 tensor "
                         "on the plane's device")
    eq = torch.empty_like(y)
    cum = torch.empty((b, BINS), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.fr_cum_lookup(y.data_ptr(), hist.data_ptr(), eq.data_ptr(),
                            cum.data_ptr(), b, r, w, rows_per_cta(w),
                            stream)
    if err:
        raise RuntimeError(f"cum_lookup launch failed: cudaError {err}")
    launches["cum_lookup"] += 1
    return eq, cum


def equalize_stats(y_packed: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, R, W) row-padded f32 luminance → (eq_raw (B, R, W), cum
    (B, 256)): each pixel's inclusive cumulative count (0 at padding)
    and the frame's cumulative histogram of real pixels.

    A CPU tensor runs the plain version; a CUDA tensor runs the two
    kernels."""
    _check(y_packed)
    if y_packed.device.type == "cpu":
        return equalize_stats_plain(y_packed)
    with torch.cuda.device(y_packed.device):
        return cum_lookup(y_packed, hist256(y_packed))
