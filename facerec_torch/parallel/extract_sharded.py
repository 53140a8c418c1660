"""Frame-axis sharded extract step: one block split over the ranks.

Counterpart of ``facerec_tpu/parallel/extract_sharded.py``, one process
per device in place of one ``shard_map`` program:

  - scene statistics: each rank computes the luminance planes, their
    raw equalization and cumulative histograms of its own frames (the
    CUDA kernels ``hist256_rgb`` and ``cum_lookup`` on a card) and
    receives a 2-frame halo of all three from its left neighbour
    (:func:`~facerec_torch.parallel.mesh.shift_right`), the state the
    serial detector carries, so sharded flags equal serial ones;
  - detection: per frame, so per rank;
  - tracking: a tracker per rank over its frames, with uids from
    ``rank << 20``; the merge stage stitches the sub-ranges as it
    stitches file shards.

It demonstrates the halo formulation within one block; the production
multi-device path is :mod:`facerec_torch.parallel.extract_mesh`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from facerec_torch.models.detector import Detections
from facerec_torch.ops import scene as scene_ops
from facerec_torch.parallel.mesh import shift_right
from facerec_torch.track import TrackerConfig, init_tracker, run_block
from facerec_torch.track.tracker import TrackEmit

UID_STRIDE = 1 << 20  # per-rank uid namespace


class ShardedBlockOut(NamedTuple):
    flags: torch.Tensor       # (L,) bool scene changes of the rank's frames
    detections: Detections    # (L, D, ...) padded
    emit: TrackEmit           # (L, T, ...) tracker emissions


def _scene_flags_with_halo(frames: torch.Tensor, frame0: int, crop: bool,
                           group=None) -> torch.Tensor:
    """(L,) scene flags of a rank's (L, H, W, 3) frames whose first is
    global frame ``frame0``, given the left neighbour's last two."""
    l, h, w, _ = frames.shape
    if l < 2:
        raise ValueError(f"a rank needs at least 2 frames for the halo, "
                         f"got {l}")
    lo, hi = scene_ops.crop_bounds(h, w, crop)
    p = (hi - lo) * w
    scale = 255.0 / p
    y, eq, cum = scene_ops.equalize_planes(frames, lo, hi)

    # the right shift of the last two frames' planes, equalized planes
    # and cumulative histograms, as one buffer
    plane = y[0].numel()
    halo = shift_right(torch.cat([y[-2:].reshape(2, -1),
                                  eq[-2:].reshape(2, -1), cum[-2:]], dim=1),
                       group)
    y_ext = torch.cat([halo[:, :plane].reshape(2, *y.shape[1:]), y])
    eq_ext = torch.cat([halo[:, plane:2 * plane].reshape(2, *y.shape[1:]),
                        eq])
    cum_ext = torch.cat([halo[:, 2 * plane:], cum])

    # statistics of extended frames 1..L+1 (frame i against i-1), the
    # serial formulas: sums over packed planes (padding rows add 0) over
    # the real pixel count, fv from the histogram
    mafd_ext = (y_ext[1:] - y_ext[:-1]).abs().sum(dim=(1, 2)) / p
    mafd_eq_ext = (eq_ext[1:] * scale
                   - eq_ext[:-1] * scale).abs().sum(dim=(1, 2)) / p
    fv_ext = scene_ops.fv_stats(cum_ext[1:], mafd_eq_ext, p)

    mafd = mafd_ext[1:]
    mafd_eq = mafd_eq_ext[1:]
    sdmafd_eq = mafd_eq_ext[1:] - mafd_eq_ext[:-1]
    adfv_eq = (fv_ext[1:] - fv_ext[:-1]).abs()

    # rank 0 has no left neighbour: its first two frames warm up locally,
    # as every reference shard does; for the film's first block that is
    # global_idx >= 2
    local_idx = torch.arange(l, dtype=torch.int32, device=frames.device)
    global_idx = frame0 + local_idx
    rank = dist.get_rank(group)
    valid = (global_idx >= 2) & ((rank > 0) | (local_idx >= 2))
    return scene_ops.decide(mafd, mafd_eq, sdmafd_eq, adfv_eq) & valid


def sharded_extract_step(detector, tracker_cfg: TrackerConfig,
                         frames: torch.Tensor, block_frame0: int = 0,
                         crop: bool = True, group=None) -> ShardedBlockOut:
    """This rank's share of one block sharded over the process group.

    Args:
        detector: callable (L, H, W, 3) → :class:`Detections`, on the
            frames' device (``set_block_start`` is called when it has
            one).
        frames: (L, H, W, 3) uint8, this rank's frames: rank r holds
            block frames [r·L, (r+1)·L), every rank the same L ≥ 2.
        block_frame0: global index of the block's first frame.
    """
    rank = dist.get_rank(group)
    frame0 = block_frame0 + rank * frames.shape[0]
    flags = _scene_flags_with_halo(frames, frame0, crop, group)
    if hasattr(detector, "set_block_start"):
        detector.set_block_start(frame0)
    det = detector(frames)
    state = init_tracker(tracker_cfg, frames.device)._replace(
        next_uid=torch.tensor(rank * UID_STRIDE, dtype=torch.int32,
                              device=frames.device))
    _, emit = run_block(tracker_cfg, state, det.boxes, det.valid, flags,
                        frame0)
    return ShardedBlockOut(flags, det, emit)
