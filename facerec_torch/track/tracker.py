"""SORT as a fixed-capacity track table advanced one frame at a time.

Port of ``facerec_tpu/track/tracker.py``.  The table — (T,) state
vectors plus a batched Kalman state — lives on the tracker's device;
:func:`run_block` is a Python loop over the block's frames in place of
``lax.scan``.  Lifecycle rules are those of the JAX package: scene-cut
kill before the frame's predict, the ``min_hits`` starting rule,
``max_age`` expiry and posterior-vs-prior history entries.

Each frame runs about a hundred small tensor operations, so on the card
the scan is bound by kernel launches (its time per block is recorded in
PERF.md).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

from facerec_torch.ops import assignment, boxes, kalman

_I32 = torch.int32


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
              scene_changes: torch.Tensor, frame0: int
              ) -> Tuple[TrackerState, TrackEmit]:
    """Run the tracker over a block of frames.

    Args:
        det_boxes: (B, D, 4) float32.
        det_valid: (B, D) bool.
        scene_changes: (B,) bool.
        frame0: global index of the block's first frame.

    Returns:
        (new_state, emissions with a leading (B,) axis on every field).
    """
    frame0 = int(frame0)
    emits = []
    for i in range(det_boxes.shape[0]):
        state, e = step(cfg, state, det_boxes[i], det_valid[i],
                        scene_changes[i], frame0 + i)
        emits.append(e)
    return state, TrackEmit(*(torch.stack(f) for f in zip(*emits)))
