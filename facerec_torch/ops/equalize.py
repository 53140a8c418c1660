"""Raw histogram equalization of luminance planes: the hand-written
CUDA kernels ``hist256`` + ``cum_lookup`` (``csrc/equalize.cu``) and
their plain PyTorch versions.

Counterpart of ``facerec_tpu/ops/pallas/equalize.py`` (the three Pallas
kernels ``_fused_kernel``, ``_hist_kernel``, ``_eq_kernel``), of the
bincount path of ``facerec_tpu/ops/scene.py:_equalize_raw``, and of the
luminance that feeds them.  The TPU kernels' lane fold
(``FACEREC_EQ_FOLD``) is a knob for the TPU's tiled layout and is not
ported.

``hist256`` has two entry points: :func:`hist256` takes a packed f32
plane (the counterpart of ``equalize_stats_tpu``'s input) and
:func:`hist256_rgb` takes the uint8 frames and computes the plane
itself, so the scene stage reads each frame once.  The kernel wrappers
take CUDA tensors only; :func:`equalize_stats` takes a CPU tensor to
the plain versions and a CUDA tensor to the kernels, and never moves
data between the two.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from facerec_torch.ops import _build

ROWS = 8              # row multiple of a packed plane
BINS = 256

# Luminance weights as float32 values, widened to float64 (see
# :func:`luminance`).
_W = [float(torch.tensor(w, dtype=torch.float32))
      for w in (0.299, 0.587, 0.114)]

# Launch counts of the kernels, one per launch; chip_smoke.py zeroes
# them before the main path and reads them after.
launches: Dict[str, int] = {"hist256": 0, "cum_lookup": 0}

_lib = None


def luminance(frames: torch.Tensor) -> torch.Tensor:
    """RGB uint8 (..., H, W, 3) → float32 luminance Y.

    The JAX package's CPU path computes this 3-term dot as
    ``fma(b, w2, fma(g, w1, r * w0))`` in float32.  Each step is
    reproduced exactly here in float64: the products of a uint8 and a
    float32 weight, and the sums of two such terms below 512, are exact
    in float64, so rounding to float32 after each step gives the same
    single roundings as the fused multiply-adds.  A pixel whose Y lies
    on an integer boundary therefore lands in the same histogram bin on
    every device.
    """
    f32, f64 = torch.float32, torch.float64
    p = (frames[..., 0].to(f32) * _W[0]).to(f64)
    q = (p + frames[..., 1].to(f64) * _W[1]).to(f32).to(f64)
    return (q + frames[..., 2].to(f64) * _W[2]).to(f32)


def pack_planes(y: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 → (B, R, W): rows padded to a multiple of 8 with
    -1, the padding sentinel of the equalize kernels."""
    h = y.shape[1]
    hp = packed_rows(h)
    if hp != h:
        y = F.pad(y, (0, 0, 0, hp - h), value=-1.0)
    return y


def packed_rows(rows: int) -> int:
    return (rows + ROWS - 1) // ROWS * ROWS


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


def hist256_rgb_plain(frames: torch.Tensor, lo: int, hi: int,
                      grayscale: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`hist256_rgb`: the luminance of rows
    [lo, hi) (channel 0 as float32 when ``grayscale``), packed, and its
    counts."""
    rows = frames[:, lo:hi]
    y = rows[..., 0].to(torch.float32) if grayscale else luminance(rows)
    y = pack_planes(y).contiguous()
    return y, hist256_plain(y)


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
    if y.data_ptr() % 16:
        raise ValueError("the kernels read the plane in 16-byte vectors; "
                         "it must start on a 16-byte boundary")


def _check_frames(frames: torch.Tensor, lo: int, hi: int) -> None:
    if frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) frames, got {tuple(frames.shape)}")
    if frames.dtype != torch.uint8:
        raise TypeError(f"expected uint8 frames, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("expected contiguous frames")
    b, h, w, _ = frames.shape
    if b == 0 or w == 0 or not 0 <= lo < hi <= h:
        raise ValueError(f"bad crop rows [{lo}, {hi}) of frames "
                         f"{tuple(frames.shape)}")
    if frames.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got {frames.device}")


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("equalize")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fr_hist256.argtypes = [vp, vp, i, i, i, vp]
        lib.fr_hist256.restype = i
        lib.fr_hist256_rgb.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, vp]
        lib.fr_hist256_rgb.restype = i
        lib.fr_cum_lookup.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        lib.fr_cum_lookup.restype = i
        _lib = lib
    return _lib


def _count(err: int, name: str) -> None:
    """Raise on a failed launch, else count it."""
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    launches[name] += 1


def hist256(y: torch.Tensor) -> torch.Tensor:
    """Kernel ``hist256``: (B, R, W) CUDA plane → (B, 256) int32 counts
    of the non-padding pixels."""
    _check_cuda(y)
    lib = _kernels()
    b, r, w = y.shape
    with torch.cuda.device(y.device):
        hist = torch.zeros((b, BINS), dtype=torch.int32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _count(lib.fr_hist256(y.data_ptr(), hist.data_ptr(), b, r, w,
                                 stream), "hist256")
    return hist


def hist256_rgb(frames: torch.Tensor, lo: int, hi: int,
                grayscale: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``hist256`` on uint8 frames: (B, H, W, 3) CUDA frames and
    the crop rows [lo, hi) → (y_packed (B, R, W) f32 luminance, rows
    ``hi-lo..R`` = -1; hist (B, 256) int32 counts).  ``y`` is
    bit-identical to :func:`luminance` (channel 0 as float32 when
    ``grayscale``)."""
    _check_frames(frames, lo, hi)
    lib = _kernels()
    b, h, w, _ = frames.shape
    r = packed_rows(hi - lo)
    with torch.cuda.device(frames.device):
        y = torch.empty((b, r, w), dtype=torch.float32, device=frames.device)
        hist = torch.zeros((b, BINS), dtype=torch.int32, device=frames.device)
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        _count(lib.fr_hist256_rgb(
            frames.data_ptr(), y.data_ptr(), hist.data_ptr(), b, h, w, lo,
            hi, r, int(grayscale), stream), "hist256")
    return y, hist


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
    with torch.cuda.device(y.device):
        eq = torch.empty_like(y)
        cum = torch.empty((b, BINS), dtype=torch.float32, device=y.device)
        stream = torch.cuda.current_stream(y.device).cuda_stream
        _count(lib.fr_cum_lookup(y.data_ptr(), hist.data_ptr(),
                                    eq.data_ptr(), cum.data_ptr(), b, r, w,
                                    stream), "cum_lookup")
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
    return cum_lookup(y_packed, hist256(y_packed))
