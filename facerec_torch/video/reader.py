"""Video probing and block decoding (host side).

Port of ``facerec_tpu/video/reader.py``: frame count/fps probing,
display-aspect-ratio correction (container SAR or an
``aspect_ratios.csv`` override), and contiguous (B, H, W, 3) uint8 RGB
blocks.  Decoding goes through the repo's native decoder
(``native/libfacerec_decode.so``, one sequential worker) when it loads,
else OpenCV; both are imported only when a file is opened, because a
host may have neither.

An in-memory :class:`~facerec_torch.video.synth.SynthClip` is accepted
wherever a path is (:func:`open_source`): it exists only so that a host
without a video decoder can drive the pipeline on synthetic frames, and
adds no capability to the pipeline.
"""
from __future__ import annotations

import csv
import dataclasses
import os
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
    """OpenCV decode of a frame range into fixed-size RGB blocks."""

    def __init__(self, path: str, info: VideoInfo):
        import cv2

        self.cv2 = cv2
        self.info = info
        self.cap = cv2.VideoCapture(path)

    def read_block(self, n: int) -> np.ndarray:
        """Up to ``n`` frames as (m, H, W, 3) uint8 RGB at display
        resolution (m < n at end of stream)."""
        info = self.info
        frames = []
        for _ in range(n):
            ok, frame = self.cap.read()
            if not ok:
                break
            if (info.display_width != info.storage_width
                    or info.display_height != info.storage_height):
                frame = self.cv2.resize(
                    frame, (info.display_width, info.display_height))
            frames.append(frame[..., ::-1])  # BGR → RGB
        if not frames:
            return np.zeros((0, info.display_height, info.display_width, 3),
                            np.uint8)
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


class NativeReader:
    """The native C++ block decoder, one sequential worker."""

    def __init__(self, path: str, info: VideoInfo, block_frames: int):
        from facerec_torch.runtime.native import NativeVideoReader

        self.native = NativeVideoReader(
            path, info.display_width, info.display_height, block_frames)

    def blocks(self, beg: int, end: int, block: int):
        return self.native.blocks(beg, end)

    def close(self) -> None:
        self.native.close()


class MemoryReader:
    """Blocks sliced from an in-memory (N, H, W, 3) uint8 clip."""

    def __init__(self, frames: np.ndarray):
        self.frames = frames

    def blocks(self, beg: int, end: int, block: int):
        for f in range(beg, min(end, len(self.frames)), block):
            yield f, np.ascontiguousarray(
                self.frames[f:min(f + block, end)])

    def close(self) -> None:
        pass


def open_block_reader(path: str, info: VideoInfo, block_frames: int):
    """The native decoder when its library loads, else OpenCV."""
    from facerec_torch.runtime.native import decode_lib

    if decode_lib() is not None:
        try:
            return NativeReader(path, info, block_frames)
        except ValueError:
            pass       # the native demuxer rejected the file
    return VideoReader(path, info)


def open_source(file, display: Optional[Tuple[int, int]], block_frames: int):
    """(name, VideoInfo, reader) of a film path or an in-memory clip
    (any object with ``path``, ``frames`` and ``fps``)."""
    if isinstance(file, (str, os.PathLike)):
        path = os.fspath(file)
        info = probe_video(path, display)
        return path, info, open_block_reader(path, info, block_frames)
    frames = np.asarray(file.frames)
    n, h, w, _ = frames.shape
    if display is not None and tuple(display) != (w, h):
        raise ValueError("an in-memory clip is already at display size "
                         f"{w}x{h}, not {display[0]}x{display[1]}")
    info = VideoInfo(n, float(file.fps), w, h, w, h)
    return file.path, info, MemoryReader(frames)
