"""SORT as a fixed-capacity track table advanced one frame at a time.

Port of ``facerec_tpu/track/tracker.py``.  The table — (T,) state
vectors plus a batched Kalman state — lives on the tracker's device.
Lifecycle rules are those of the JAX package: scene-cut kill before the
frame's predict, the ``min_hits`` starting rule, ``max_age`` expiry and
posterior-vs-prior history entries.

:func:`run_block` scans a block of frames.  On a card it is one launch
of the hand-written kernel ``tracker_scan`` (``csrc/tracker.cu``: one
CTA of 8 threads a slot), which keeps the whole frame loop on the chip
and takes 1..128 slots and detections (the JAX package sets no limit;
the plain loop sets none either); on the CPU it is
:func:`run_block_plain`, a Python loop of :func:`step` over the frames
in place of ``lax.scan`` and the kernel's plain version (about a
hundred small tensor operations per frame, and host reads that steer
the association: on a card it is bound by the host).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch

from facerec_torch.ops import _build, assignment, boxes, kalman

_I32 = torch.int32
# the kernel's capacity in track slots and in detections per frame: 8
# threads a slot, 1,024 at most in its one CTA
MAX_SLOTS = 128

# Launches of the tracker_scan kernel; chip_smoke.py zeroes it before
# the main path and reads it after.
launches: Dict[str, int] = {"tracker": 0}

_lib = None


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    max_tracks: int = 32
    max_detections: int = 16
    max_age: int = 5
    min_hits: int = 3
    iou_threshold: float = 0.5


class TrackerState(NamedTuple):
    kf: kalman.KalmanState
    active: torch.Tensor        # (T,) bool — currently followed
    uid: torch.Tensor           # (T,) int32 — global track id
    first_frame: torch.Tensor   # (T,) int32
    hist_len: torch.Tensor      # (T,) int32 — history entries so far
    tsu: torch.Tensor           # (T,) int32 — time since last update
    hits: torch.Tensor          # (T,) int32
    initial_hits: torch.Tensor  # (T,) int32
    next_uid: torch.Tensor      # () int32


class TrackEmit(NamedTuple):
    """Per-frame outputs of one tracker step (leading axis = frames)."""

    box: torch.Tensor          # (T, 4) float32 state box
    emit: torch.Tensor         # (T,) bool — slot produced a history entry
    detected: torch.Tensor     # (T,) bool — entry is a posterior
    uid: torch.Tensor          # (T,) int32
    first_frame: torch.Tensor  # (T,) int32
    det_slot: torch.Tensor     # (D,) int32 — track slot per detection
    overflow: torch.Tensor     # () int32 — detections dropped


def init_tracker(cfg: TrackerConfig,
                 device: torch.device = torch.device("cpu")
                 ) -> TrackerState:
    t = cfg.max_tracks
    zeros = torch.zeros((t,), dtype=_I32, device=device)
    return TrackerState(
        kf=kalman.init_state(t, device),
        active=torch.zeros((t,), dtype=torch.bool, device=device),
        uid=torch.full((t,), -1, dtype=_I32, device=device),
        first_frame=zeros, hist_len=zeros.clone(), tsu=zeros.clone(),
        hits=zeros.clone(), initial_hits=zeros.clone(),
        next_uid=torch.zeros((), dtype=_I32, device=device))


def _onehot_rows(eq: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(T, D) bool one-hot (≤1 per row) × (D, 4) → (T, 4), exact: rows
    without a True are 0.  Elementwise, so no matmul precision mode
    can touch the selected values."""
    return (eq[:, :, None].to(z.dtype) * z[None]).sum(dim=1)


def step(cfg: TrackerConfig, state: TrackerState, det_boxes: torch.Tensor,
         det_valid: torch.Tensor, scene_change: torch.Tensor,
         frame: Union[int, torch.Tensor]) -> Tuple[TrackerState, TrackEmit]:
    """Advance the tracker by one frame.

    Args:
        det_boxes: (D, 4) float32 detections [x1,y1,x2,y2].
        det_valid: (D,) bool.
        scene_change: () bool — kill all live tracks before this frame.
        frame: global frame index.
    """
    t = cfg.max_tracks
    dev = det_boxes.device
    arange_t = torch.arange(t, dtype=_I32, device=dev)

    # 1. scene-change kill: slots become reusable now
    was_active = state.active & ~scene_change

    # 2. predict all, keep only followed slots' results
    prior = kalman.predict(state.kf)
    kf = kalman.KalmanState(
        x=torch.where(was_active[:, None], prior.x, state.kf.x),
        p=torch.where(was_active[:, None, None], prior.p, state.kf.p))
    tsu = torch.where(was_active, state.tsu + 1, state.tsu)
    hist_len = torch.where(was_active, state.hist_len + 1, state.hist_len)

    # 3. associate detections with prior boxes
    prior_boxes = boxes.z_to_box(kf.x[:, :4])
    iou = boxes.iou_matrix(det_boxes, prior_boxes)
    det_slot = assignment.associate(iou, det_valid, was_active,
                                    cfg.iou_threshold)

    # 4. invert detection→slot and update the matched posteriors;
    # padding boxes are degenerate (0/0 aspect): zero them
    zd = boxes.box_to_z(det_boxes)
    zd = torch.where(torch.isfinite(zd), zd, 0.0)
    match_eq = (det_slot[None, :] == arange_t[:, None]) & (
        det_slot[None, :] >= 0)                          # (T, D)
    matched = match_eq.any(dim=1)
    kf = kalman.update(kf, _onehot_rows(match_eq, zd), matched)
    hits = torch.where(matched, state.hits + 1, state.hits)
    tsu = torch.where(matched, 0, tsu)
    initial_hits = torch.where(matched & (hist_len == hits),
                               state.initial_hits + 1, state.initial_hits)

    # 5. unfollow rules, on followed slots
    expired = was_active & (tsu > cfg.max_age) & (hist_len >= cfg.min_hits)
    not_started = was_active & (hist_len <= cfg.min_hits) & (
        initial_hits < hist_len)
    still_active = was_active & ~(expired | not_started)

    # 6. spawn unmatched detections into non-emitting slots: the r-th
    # spawning detection takes the r-th free slot
    unmatched = det_valid & (det_slot < 0)
    free = ~was_active
    n_free = free.sum(dtype=_I32)
    spawn_rank = torch.cumsum(unmatched.to(_I32), 0, dtype=_I32) - 1
    will_spawn = unmatched & (spawn_rank < n_free)
    overflow = (unmatched & ~will_spawn).sum(dtype=_I32)

    free_rank = torch.cumsum(free.to(_I32), 0, dtype=_I32) - 1
    spawn_eq = (free[:, None] & will_spawn[None, :]
                & (free_rank[:, None] == spawn_rank[None, :]))  # (T, D)
    spawned = spawn_eq.any(dim=1)
    spawn_i = spawn_eq.to(_I32)
    slot_for_det = (spawn_i * arange_t[:, None]).sum(0, dtype=_I32)

    kf = kalman.reset_tracks(kf, spawned, _onehot_rows(spawn_eq, zd))
    uid = torch.where(
        spawned,
        state.next_uid + (spawn_i * spawn_rank[None, :]).sum(1, dtype=_I32),
        state.uid)
    first_frame = torch.where(spawned, frame, state.first_frame).to(_I32)
    hist_len = torch.where(spawned, 1, hist_len)
    hits = torch.where(spawned, 1, hits)
    initial_hits = torch.where(spawned, 1, initial_hits)
    tsu = torch.where(spawned, 0, tsu)
    det_slot = torch.where(will_spawn, slot_for_det, det_slot)

    new_state = TrackerState(
        kf=kf, active=still_active | spawned, uid=uid,
        first_frame=first_frame, hist_len=hist_len, tsu=tsu, hits=hits,
        initial_hits=initial_hits,
        next_uid=state.next_uid + will_spawn.sum(dtype=_I32))
    emit = TrackEmit(
        box=boxes.z_to_box(kf.x[:, :4]), emit=was_active | spawned,
        detected=matched | spawned, uid=uid, first_frame=first_frame,
        det_slot=det_slot, overflow=overflow)
    return new_state, emit


def run_block(cfg: TrackerConfig, state: TrackerState,
              det_boxes: torch.Tensor, det_valid: torch.Tensor,
              scene_changes: torch.Tensor,
              frame0: Union[int, torch.Tensor]
              ) -> Tuple[TrackerState, TrackEmit]:
    """Run the tracker over a block of frames: the ``tracker_scan``
    kernel on CUDA tensors, :func:`run_block_plain` on CPU tensors.

    Args:
        det_boxes: (B, D, 4) float32.
        det_valid: (B, D) bool.
        scene_changes: (B,) bool.
        frame0: global index of the block's first frame (an int, or a
            () int32 tensor on the detections' device).

    Returns:
        (new_state, emissions with a leading (B,) axis on every field).
    """
    if det_boxes.device.type == "cuda":
        return run_block_cuda(cfg, state, det_boxes, det_valid,
                              scene_changes, frame0)
    return run_block_plain(cfg, state, det_boxes, det_valid, scene_changes,
                           frame0)


def run_block_plain(cfg: TrackerConfig, state: TrackerState,
                    det_boxes: torch.Tensor, det_valid: torch.Tensor,
                    scene_changes: torch.Tensor,
                    frame0: Union[int, torch.Tensor]
                    ) -> Tuple[TrackerState, TrackEmit]:
    """The plain version of ``tracker_scan``: :func:`step` frame by
    frame, on any device (arguments as :func:`run_block`'s)."""
    frame0 = int(frame0)
    emits = []
    for i in range(det_boxes.shape[0]):
        state, e = step(cfg, state, det_boxes[i], det_valid[i],
                        scene_changes[i], frame0 + i)
        emits.append(e)
    return state, TrackEmit(*(torch.stack(f) for f in zip(*emits)))


def check_scan_shapes(cfg: TrackerConfig, det_boxes: torch.Tensor) -> None:
    """The kernel's limits: T and D in 1..MAX_SLOTS, (B, D, 4) boxes."""
    if det_boxes.dim() != 3 or det_boxes.shape[-1] != 4:
        raise ValueError(f"expected (B, D, 4) detections, got "
                         f"{tuple(det_boxes.shape)}")
    t, d = cfg.max_tracks, det_boxes.shape[1]
    if not (1 <= t <= MAX_SLOTS and 1 <= d <= MAX_SLOTS):
        raise ValueError(
            f"tracker_scan takes 1..{MAX_SLOTS} track slots and "
            f"detections per frame, got T={t}, D={d}")


_IN_PTRS = ("det_boxes", "det_valid", "scene", "frame0", "x", "p", "active",
            "uid", "first_frame", "hist_len", "tsu", "hits", "initial_hits",
            "next_uid")
_OUT_PTRS = ("x_out", "p_out", "active_out", "uid_out", "first_frame_out",
             "hist_len_out", "tsu_out", "hits_out", "initial_hits_out",
             "next_uid_out", "e_box", "e_emit", "e_detected", "e_uid",
             "e_first_frame", "e_det_slot", "e_overflow")
_STATE_I32 = ("uid", "first_frame", "hist_len", "tsu", "hits",
              "initial_hits")


class _ScanArgs(ctypes.Structure):
    """``ScanArgs`` of ``csrc/tracker.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _IN_PTRS + _OUT_PTRS]
                + [(n, ctypes.c_int) for n in (
                    "frames", "tracks", "dets", "max_age", "min_hits")]
                + [("iou_threshold", ctypes.c_float),
                   ("q", ctypes.c_float * 8), ("p0", ctypes.c_float * 8),
                   ("r", ctypes.c_float * 4)])


def _kernel():
    """The ctypes entry point of the kernel."""
    global _lib
    if _lib is None:
        lib = _build.load("tracker")
        lib.fr_tracker_scan.argtypes = [ctypes.POINTER(_ScanArgs),
                                        ctypes.c_void_p]
        lib.fr_tracker_scan.restype = ctypes.c_int
        _lib = lib
    return _lib.fr_tracker_scan


@functools.lru_cache(maxsize=64)
def _const_args(cfg: TrackerConfig) -> _ScanArgs:
    """The launch arguments that depend on the config alone (pointers and
    the frame and detection counts are filled in per call)."""
    return _ScanArgs(
        tracks=cfg.max_tracks, max_age=cfg.max_age, min_hits=cfg.min_hits,
        iou_threshold=cfg.iou_threshold,
        q=(ctypes.c_float * 8)(*np.diag(kalman.Q_NP)),
        p0=(ctypes.c_float * 8)(*np.diag(kalman.P0_NP)),
        r=(ctypes.c_float * 4)(*np.diag(kalman.R_NP)))


@functools.lru_cache(maxsize=64)
def _out_layout(b: int, t: int, d: int):
    """Where :func:`output_views` cuts its views: the float32 and int32
    buffers' lengths, then (shape, strides, offset in elements) of each
    float32 view, each int32 view and each flag (bytes after the int32s,
    offsets in bytes)."""
    def cut(specs, at=0):
        out = []
        for shape in specs:
            strides = tuple(int(np.prod(shape[k + 1:]))
                            for k in range(len(shape)))
            out.append((shape, strides, at))
            at += int(np.prod(shape))
        return out, at
    f32, n_f32 = cut([(t, 8), (t, 8, 8), (b, t, 4)])
    i32, n_i32 = cut([(t,)] * 6 + [(), (b, t), (b, t), (b, d), (b,)])
    flags, end = cut([(t,), (b, t), (b, t)], 4 * n_i32)
    return n_f32, -(-end // 4), f32, i32, flags


def output_views(b: int, t: int, d: int, device: torch.device
                 ) -> Tuple[TrackerState, TrackEmit]:
    """The kernel's outputs, the new state and the emissions, as
    contiguous views of one float32 and one int32 buffer (the flags as
    bool views of the int32 buffer's tail): two allocations a block in
    place of seventeen.  No two views overlap."""
    n_f32, n_i32, f32_at, i32_at, flag_at = _out_layout(b, t, d)
    f32 = torch.empty(n_f32, dtype=torch.float32, device=device)
    i32 = torch.empty(n_i32, dtype=_I32, device=device)
    flags = i32.view(torch.uint8).view(torch.bool)
    x, p, box = (f32.as_strided(*v) for v in f32_at)
    ints = [i32.as_strided(*v) for v in i32_at]
    active, emit, detected = (flags.as_strided(*v) for v in flag_at)
    return (TrackerState(kalman.KalmanState(x, p), active, *ints[:7]),
            TrackEmit(box, emit, detected, *ints[7:]))


def _arg(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev,
         what: str) -> int:
    """The address of ``x`` (made contiguous) after checking it."""
    if x.dtype != dtype or x.shape != shape or x.device != dev:
        raise ValueError(f"tracker_scan: {what} must be {dtype} "
                         f"{tuple(shape)} on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    return x.contiguous().data_ptr()


def run_block_cuda(cfg: TrackerConfig, state: TrackerState,
                   det_boxes: torch.Tensor, det_valid: torch.Tensor,
                   scene_changes: torch.Tensor,
                   frame0: Union[int, torch.Tensor]
                   ) -> Tuple[TrackerState, TrackEmit]:
    """Kernel ``tracker_scan``: :func:`run_block` on CUDA tensors in one
    launch on the current stream.  No host read and no host→device copy
    (an int ``frame0`` is filled in on the card), so a CUDA graph can
    capture it."""
    check_scan_shapes(cfg, det_boxes)
    dev = det_boxes.device
    if dev.type != "cuda":
        raise ValueError(f"tracker_scan takes CUDA tensors, got {dev}")
    b, d, _ = det_boxes.shape
    t = cfg.max_tracks
    f32, u8 = torch.float32, torch.bool     # the kernel reads bools as u8
    with torch.cuda.device(dev):
        if not isinstance(frame0, torch.Tensor):
            frame0 = torch.full((), int(frame0), dtype=_I32, device=dev)
        ptrs = [_arg(det_boxes, f32, (b, d, 4), dev, "det_boxes"),
                _arg(det_valid, u8, (b, d), dev, "det_valid"),
                _arg(scene_changes, u8, (b,), dev, "scene_changes"),
                _arg(frame0, _I32, (), dev, "frame0"),
                _arg(state.kf.x, f32, (t, 8), dev, "kf.x"),
                _arg(state.kf.p, f32, (t, 8, 8), dev, "kf.p"),
                _arg(state.active, u8, (t,), dev, "active")]
        ptrs += [_arg(getattr(state, n), _I32, (t,), dev, n)
                 for n in _STATE_I32]
        ptrs.append(_arg(state.next_uid, _I32, (), dev, "next_uid"))
        new, emit = output_views(b, t, d, dev)
        ptrs += [x.data_ptr() for x in (*new.kf, *new[1:], *emit)]
        args = _ScanArgs.from_buffer_copy(_const_args(cfg))
        for n, ptr in zip(_IN_PTRS + _OUT_PTRS, ptrs):
            setattr(args, n, ptr)
        args.frames, args.dets = b, d
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"tracker_scan launch failed: cudaError {err}")
    launches["tracker"] += 1
    return new, emit
