"""Video probing and block decoding (host side).

Port of ``facerec_tpu/video/reader.py``: frame count/fps probing,
display-aspect-ratio correction (container SAR or an
``aspect_ratios.csv`` override), and contiguous (B, H, W, 3) uint8 RGB
blocks, or (B, H·3/2, W) I420 planes for the yuv420-delta wire.
Decoding goes through the repo's native decoder
(``native/libfacerec_decode.so``, sequential or with parallel workers)
when it loads, else OpenCV; both are imported only when a file is
opened, because a host may have neither.

An in-memory :class:`~facerec_torch.video.synth.SynthClip` is accepted
wherever a path is (:func:`source_info`, :func:`open_reader`): it
exists only so that a host without a video decoder can drive the
pipeline on synthetic frames, and adds no capability to the pipeline.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import sys
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    n_frames: int
    fps: float
    storage_width: int
    storage_height: int
    display_width: int
    display_height: int


def probe_video(path: str,
                display_size: Optional[Tuple[int, int]] = None) -> VideoInfo:
    """Probe container properties and derive the display resolution
    (DAR = SAR × PAR; an explicit ``display_size`` wins)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n_frames <= 0:
            raise ValueError(f"Invalid video file <{path}>")
        fps = cap.get(cv2.CAP_PROP_FPS)
        sw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        sh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        if display_size is not None:
            dw, dh = display_size
        else:
            sar = sw / sh
            par = ((cap.get(cv2.CAP_PROP_SAR_NUM) or 1.0)
                   / (cap.get(cv2.CAP_PROP_SAR_DEN) or 1.0))
            dh = sh
            dw = round(sh * (sar * par))
        return VideoInfo(n_frames, fps, sw, sh, dw, dh)
    finally:
        cap.release()


def load_aspect_ratio_csv(csv_path: str,
                          file_basename: str) -> Optional[Tuple[int, int]]:
    """Look up a precomputed display size."""
    if not os.path.exists(csv_path):
        return None
    with open(csv_path, "r") as f:
        reader = csv.reader(f, delimiter=",", quotechar='"')
        headers = next(reader)
        name_i = headers.index("filename")
        w_i = headers.index("display_width")
        h_i = headers.index("display_height")
        for row in reader:
            if row[name_i] == file_basename:
                return int(row[w_i]), int(row[h_i])
    return None


class VideoReader:
    """OpenCV decode of a frame range into fixed-size RGB (or I420)
    blocks."""

    def __init__(self, path: str, info: VideoInfo,
                 pixel_format: str = "rgb"):
        import cv2

        _check_format(info, pixel_format)
        self.cv2 = cv2
        self.info = info
        self.pixel_format = pixel_format
        self.cap = cv2.VideoCapture(path)

    def read_block(self, n: int) -> np.ndarray:
        """Up to ``n`` frames as (m, H, W, 3) uint8 RGB, or (m, H·3/2, W)
        planar I420, at display resolution (m < n at end of stream)."""
        info = self.info
        i420 = self.pixel_format == "i420"
        frames = []
        for _ in range(n):
            ok, frame = self.cap.read()
            if not ok:
                break
            if (info.display_width != info.storage_width
                    or info.display_height != info.storage_height):
                frame = self.cv2.resize(
                    frame, (info.display_width, info.display_height))
            if i420:
                frames.append(self.cv2.cvtColor(
                    frame, self.cv2.COLOR_BGR2YUV_I420))
            else:
                frames.append(frame[..., ::-1])  # BGR → RGB
        if not frames:
            shape = ((0, info.display_height * 3 // 2, info.display_width)
                     if i420 else
                     (0, info.display_height, info.display_width, 3))
            return np.zeros(shape, np.uint8)
        return np.ascontiguousarray(np.stack(frames))

    def blocks(self, beg: int, end: int, block: int
               ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (first_frame, frames) blocks covering [beg, end)."""
        if not self.cap.set(self.cv2.CAP_PROP_POS_FRAMES, beg):
            raise RuntimeError(f"Couldn't seek to frame {beg}")
        f = beg
        while f < end:
            chunk = self.read_block(min(block, end - f))
            if len(chunk) == 0:
                break
            yield f, chunk
            f += len(chunk)

    def close(self) -> None:
        self.cap.release()


def _check_format(info: VideoInfo, pixel_format: str) -> None:
    if pixel_format not in ("rgb", "i420"):
        raise ValueError(f"unknown pixel_format {pixel_format!r}")
    if pixel_format == "i420" and (info.display_width % 2
                                   or info.display_height % 2):
        raise ValueError("i420 needs even display dims")


class NativeReader:
    """The native C++ block decoder (``n_workers`` decode threads, 1 =
    sequential)."""

    def __init__(self, path: str, info: VideoInfo, block_frames: int,
                 ring_blocks: int = 2, n_workers: int = 0,
                 pixel_format: str = "rgb"):
        from facerec_torch.runtime.native import NativeVideoReader

        _check_format(info, pixel_format)
        self.native = NativeVideoReader(
            path, info.display_width, info.display_height, block_frames,
            ring_blocks=ring_blocks, n_workers=n_workers,
            pixel_format=pixel_format)

    def blocks(self, beg: int, end: int, block: int):
        return self.native.blocks(beg, end)

    def close(self) -> None:
        self.native.close()


class MemoryReader:
    """Blocks sliced from an in-memory (N, H, W, 3) uint8 clip (an
    array, or :class:`~facerec_torch.video.synth.PaintedFrames`, which
    paints each block as it is sliced); in ``i420`` each block is
    converted on the host (:func:`facerec_torch.ops.yuv.rgb_to_i420`,
    OpenCV's bytes)."""

    def __init__(self, frames: np.ndarray, pixel_format: str = "rgb"):
        n, h, w, _ = frames.shape
        _check_format(VideoInfo(n, 0.0, w, h, w, h), pixel_format)
        self.frames = frames
        self.pixel_format = pixel_format

    def blocks(self, beg: int, end: int, block: int):
        from facerec_torch.ops.yuv import rgb_to_i420

        for f in range(beg, min(end, len(self.frames)), block):
            chunk = self.frames[f:min(f + block, end)]
            yield f, (rgb_to_i420(chunk) if self.pixel_format == "i420"
                      else np.ascontiguousarray(chunk))

    def close(self) -> None:
        pass


# (path, n_workers, pixel_format, block_frames) → the probe's verdict:
# one probe per film and setting, not one per open
_seek_probe_cache: dict = {}


def _parallel_seek_probe(path: str, info: VideoInfo, block_frames: int,
                         n_workers: int, pixel_format: str) -> bool:
    """True iff ``n_workers``-parallel decode of the first two blocks is
    bit-identical to sequential decode of the same range.  Parallel
    workers seek per block, which is frame-accurate for closed-GOP film
    files but not for every codec; a mismatch drops the reader to one
    worker instead of producing wrong frames."""
    from facerec_torch.runtime.native import NativeVideoReader

    key = (path, n_workers, pixel_format, block_frames)
    if key in _seek_probe_cache:
        return _seek_probe_cache[key]
    end = min(info.n_frames, 2 * block_frames)
    outs = []
    for w in (1, n_workers):
        r = NativeVideoReader(path, info.display_width, info.display_height,
                              block_frames, ring_blocks=n_workers + 1,
                              n_workers=w, pixel_format=pixel_format)
        try:
            outs.append(list(r.blocks(0, end)))
        finally:
            r.close()
    seq, par = outs
    ok = (len(seq) == len(par)
          and all(fa == fb and a.shape == b.shape and np.array_equal(a, b)
                  for (fa, a), (fb, b) in zip(seq, par)))
    _seek_probe_cache[key] = ok
    return ok


def open_block_reader(path: str, info: VideoInfo, block_frames: int,
                      decode_workers: int = 0, ring_blocks: int = 2,
                      pixel_format: str = "rgb"):
    """The native decoder when its library loads, else OpenCV.

    ``decode_workers`` > 1 decodes blocks in parallel threads (0 reads
    ``FACEREC_DECODE_WORKERS``, else sequential), after a probe that
    parallel decode gives the sequential bytes on this film.
    ``ring_blocks`` bounds how far decode runs ahead (see
    :func:`fetch_ring_blocks`).  ``pixel_format="i420"`` emits
    (m, H·3/2, W) planar 4:2:0 blocks."""
    from facerec_torch.runtime.native import decode_lib

    _check_format(info, pixel_format)
    if decode_lib() is not None:
        try:
            reader = NativeReader(path, info, block_frames, ring_blocks,
                                  decode_workers, pixel_format)
            n = reader.native.n_workers
            if (n > 1 and os.environ.get("FACEREC_SEEK_CHECK", "1") != "0"
                    and not _parallel_seek_probe(path, info, block_frames,
                                                 n, pixel_format)):
                print(f"WARNING: parallel decode seek probe failed for "
                      f"{os.path.basename(path)}; falling back to 1 "
                      f"decode worker", file=sys.stderr, flush=True)
                reader.close()
                reader = NativeReader(path, info, block_frames, ring_blocks,
                                      1, pixel_format)
            return reader
        except ValueError:
            pass       # the native demuxer rejected the file
    return VideoReader(path, info, pixel_format=pixel_format)


def fetch_ring_blocks(group: int, block_frames: int, height: int,
                      width: int, budget_bytes: int = 2 << 30) -> int:
    """Decode-ring depth for a fetch group: group + 2 blocks ahead, so
    decode continues through a group's fetch, capped by a host-memory
    budget."""
    block_bytes = max(1, block_frames * height * width * 3)
    return max(2, min(group + 2, budget_bytes // block_bytes))


def source_info(file, display: Optional[Tuple[int, int]]):
    """(name, VideoInfo) of a film path or an in-memory clip (any object
    with ``path``, ``frames`` and ``fps``)."""
    if isinstance(file, (str, os.PathLike)):
        path = os.fspath(file)
        return path, probe_video(path, display)
    n, h, w, _ = np.shape(file.frames)
    if display is not None and tuple(display) != (w, h):
        raise ValueError("an in-memory clip is already at display size "
                         f"{w}x{h}, not {display[0]}x{display[1]}")
    return file.path, VideoInfo(n, float(file.fps), w, h, w, h)


def open_reader(file, info: VideoInfo, block_frames: int,
                decode_workers: int = 0, ring_blocks: int = 2,
                pixel_format: str = "rgb"):
    """The block reader of a film path (:func:`open_block_reader`) or of
    an in-memory clip (:class:`MemoryReader`)."""
    if isinstance(file, (str, os.PathLike)):
        return open_block_reader(
            os.fspath(file), info, block_frames,
            decode_workers=decode_workers, ring_blocks=ring_blocks,
            pixel_format=pixel_format)
    return MemoryReader(file.frames, pixel_format)
