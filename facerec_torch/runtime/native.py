"""ctypes bindings for the native C++ runtime components.

``NativeVideoReader`` — double-buffered background decode
(native/decode.cpp); ``delta_u8`` — the wire's temporal delta (same
library); ``NativeJpegWriter`` — async libjpeg face-crop
writer (native/jpegio.cpp).  The port's own copy of
``facerec_tpu/runtime/native.py``: it loads the repo's prebuilt
libraries from ``native/``; when one does not load, callers use
OpenCV/PIL instead.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")

_decode_lib = None
_jpeg_lib = None


def _load(name: str):
    path = os.path.join(_NATIVE_DIR, name)
    if not os.path.exists(path):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def decode_lib():
    global _decode_lib
    if _decode_lib is None:
        lib = _load("libfacerec_decode.so")
        if lib is not None:
            lib.frd_open.restype = ctypes.c_void_p
            lib.frd_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
            lib.frd_info.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64)]
            lib.frd_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64]
            lib.frd_next_block.restype = ctypes.c_int
            lib.frd_next_block.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64)]
            lib.frd_close.argtypes = [ctypes.c_void_p]
            if hasattr(lib, "frd_delta_u8"):
                lib.frd_delta_u8.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int64, ctypes.c_int64]
        _decode_lib = lib or False
    return _decode_lib or None


def delta_available() -> bool:
    """Whether :func:`delta_u8` runs the native code."""
    lib = decode_lib()
    return lib is not None and hasattr(lib, "frd_delta_u8")


def delta_u8(src: np.ndarray, dst: np.ndarray) -> bool:
    """Native multithreaded per-block temporal delta (the wire encode,
    ``frd_delta_u8``): dst[0] = src[0], dst[i] = src[i] - src[i-1] in
    uint8 wraparound.  False when the library or the symbol does not
    load (the library links OpenCV); the caller then uses numpy."""
    if not delta_available():
        return False
    if not (src.dtype == dst.dtype == np.uint8 and src.shape == dst.shape
            and src.flags["C_CONTIGUOUS"] and dst.flags["C_CONTIGUOUS"]):
        raise ValueError("delta_u8 needs two C-contiguous uint8 arrays of "
                         "one shape")
    n = src.shape[0]
    decode_lib().frd_delta_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, src.nbytes // max(1, n))
    return True


def jpeg_lib():
    global _jpeg_lib
    if _jpeg_lib is None:
        lib = _load("libfacerec_jpeg.so")
        if lib is not None:
            lib.fjw_open.restype = ctypes.c_void_p
            lib.fjw_open.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.fjw_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.fjw_pending.restype = ctypes.c_int
            lib.fjw_pending.argtypes = [ctypes.c_void_p]
            lib.fjw_close.argtypes = [ctypes.c_void_p]
        _jpeg_lib = lib or False
    return _jpeg_lib or None


class NativeVideoReader:
    """Multi-worker block decoder (drop-in for
    :class:`facerec_torch.video.reader.VideoReader` block iteration).

    ``n_workers`` decoder threads each own a demuxer and claim frame
    blocks round-robin; delivery stays strictly in order.  Default is
    1 (sequential, no per-block seeks); parallel decode is opt-in via
    ``n_workers`` or ``FACEREC_DECODE_WORKERS`` because per-block
    seeking assumes frame-accurate seeks (true for closed-GOP film
    files — the same assumption shard seeking already makes)."""

    def __init__(self, path: str, display_w: int, display_h: int,
                 block_frames: int, ring_blocks: int = 2,
                 n_workers: int = 0, pixel_format: str = "rgb"):
        lib = decode_lib()
        if lib is None:
            raise RuntimeError("native decoder not built "
                               "(make -C native)")
        if n_workers == 0:
            n_workers = int(os.environ.get("FACEREC_DECODE_WORKERS", "0"))
        if pixel_format not in ("rgb", "i420"):
            raise ValueError(f"unknown pixel_format {pixel_format!r}")
        self.pixel_format = pixel_format
        # resolved worker count (frd_open treats <=0 as sequential)
        self.n_workers = max(1, n_workers)
        self.lib = lib
        self.handle = lib.frd_open(path.encode(), display_w, display_h,
                                   block_frames, ring_blocks, n_workers,
                                   1 if pixel_format == "i420" else 0)
        if not self.handle:
            raise ValueError(f"Invalid video file <{path}>")
        self.display_w = display_w
        self.display_h = display_h
        self.block_frames = block_frames
        info = (ctypes.c_int64 * 4)()
        lib.frd_info(self.handle, info)
        self.n_frames = int(info[0])
        self.storage_w = int(info[1])
        self.storage_h = int(info[2])
        self.fps = info[3] / 1000.0

    def blocks(self, beg: int, end: int) -> Iterator[Tuple[int, np.ndarray]]:
        self.lib.frd_start(self.handle, beg, end)
        if self.pixel_format == "i420":
            buf = np.empty((self.block_frames,
                            self.display_h * 3 // 2, self.display_w),
                           np.uint8)
        else:
            buf = np.empty((self.block_frames, self.display_h,
                            self.display_w, 3), np.uint8)
        first = ctypes.c_int64()
        while True:
            n = self.lib.frd_next_block(
                self.handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(first))
            if n < 0:
                raise RuntimeError(
                    "native decoder: no worker could open the video "
                    "(fd limit or codec failure)")
            if n == 0:
                return
            yield int(first.value), buf[:n].copy()

    def close(self) -> None:
        if self.handle:
            self.lib.frd_close(self.handle)
            self.handle = None


class NativeJpegWriter:
    """Async JPEG writer pool."""

    def __init__(self, n_threads: int = 2, quality: int = 65):
        lib = jpeg_lib()
        if lib is None:
            raise RuntimeError("native jpeg writer not built "
                               "(make -C native)")
        self.lib = lib
        self.handle = lib.fjw_open(n_threads, quality)

    def submit(self, path: str, image: np.ndarray) -> None:
        """image: (H, W, 3) RGB or (H, W) grayscale uint8, contiguous."""
        image = np.ascontiguousarray(image, np.uint8)
        channels = 1 if image.ndim == 2 else image.shape[2]
        self.lib.fjw_submit(
            self.handle, path.encode(),
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            image.shape[1], image.shape[0], channels)

    def pending(self) -> int:
        return self.lib.fjw_pending(self.handle)

    def close(self) -> None:
        if self.handle:
            self.lib.fjw_close(self.handle)
            self.handle = None
