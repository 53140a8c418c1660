"""Host-side trajectory assembly from tracker scan emissions.

The device tracker (:mod:`facerec_torch.track.tracker`) emits, per frame,
the state box / posterior flag / uid of every live track slot.  This
module folds those emissions back into trajectory records with the
reference's write ordering and filtering semantics:

  - a track is finalized once it stops emitting (unfollowed on device);
  - finalized tracks are *popped* on the first frame where
    ``frame - last_update_frame >= expiry_age``, in uid order within a
    frame — reproducing ``Sort.pop_expired`` file ordering
    (reference facerec/sort.py:338-378, extract.py:326-327);
  - only tracks whose leading all-detected run reaches ``min_hits`` are
    written (sort.py:369), with trailing non-observed predictions
    stripped (sort.py:371);
  - boxes are rounded/clamped to the display resolution at write time
    (extract.py:55-66).

It also answers per-track *face validity* (``has_valid_tracker``,
sort.py:297-308): a detection's face is saved iff its track's initial
all-detected run reaches ``min_hits``; that is decidable within
``min_hits`` frames of any detection, matching the reference's frame
buffer delay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from facerec_torch.contract import records
from facerec_torch.ops.boxes import round_clip_box


@dataclasses.dataclass
class _Track:
    uid: int
    first_frame: int
    boxes: List[np.ndarray]
    detected: List[bool]
    prefix_len: int          # leading all-detected run
    prefix_broken: bool
    last_update: int         # frame of last posterior entry
    finalized: bool = False


class TrajectoryAssembler:
    def __init__(self, width: int, height: int, min_hits: int = 3,
                 expiry_age: int = 6):
        self.width = width
        self.height = height
        self.min_hits = min_hits
        self.expiry_age = expiry_age
        self.tracks: Dict[int, _Track] = {}
        self._validity: Dict[int, bool] = {}
        self.n_written = 0
        self.overflow = 0

    # ------------------------------------------------------------------
    def feed(self, emit, frame0: int) -> List[dict]:
        """Consume one block of emissions; return trajectory records
        finalized during the block, in reference order.

        Args:
            emit: :class:`~facerec_torch.track.tracker.TrackEmit` with
                numpy-convertible (B, ...) fields.
            frame0: global index of the block's first frame.
        """
        box = np.asarray(emit.box)
        emitted = np.asarray(emit.emit)
        detected = np.asarray(emit.detected)
        uid = np.asarray(emit.uid)
        first_frame = np.asarray(emit.first_frame)
        self.overflow += int(np.asarray(emit.overflow).sum())

        out: List[dict] = []
        n_frames, n_slots = emitted.shape
        # one bulk conversion instead of B×S numpy scalar reads — the
        # dense slot scan costs more than the tracks it finds
        emitted_l = emitted.tolist()
        uid_l = uid.tolist()
        detected_l = detected.tolist()
        first_frame_l = first_frame.tolist()
        for i in range(n_frames):
            frame = frame0 + i
            seen = set()
            row = emitted_l[i]
            for s in range(n_slots):
                if not row[s]:
                    continue
                u = uid_l[i][s]
                seen.add(u)
                trk = self.tracks.get(u)
                if trk is None:
                    trk = _Track(
                        uid=u, first_frame=first_frame_l[i][s],
                        boxes=[], detected=[], prefix_len=0,
                        prefix_broken=False, last_update=frame,
                    )
                    self.tracks[u] = trk
                trk.boxes.append(box[i, s])
                d = bool(detected_l[i][s])
                trk.detected.append(d)
                if d:
                    trk.last_update = frame
                if d and not trk.prefix_broken:
                    trk.prefix_len += 1
                else:
                    trk.prefix_broken = True
                if trk.prefix_broken or trk.prefix_len >= self.min_hits:
                    self._validity[u] = trk.prefix_len >= self.min_hits
            # tracks that stopped emitting are finalized
            for trk in self.tracks.values():
                if not trk.finalized and trk.uid not in seen and trk.boxes:
                    trk.finalized = True
                    # unfollowed before reaching min_hits ⇒ invalid
                    self._validity.setdefault(
                        trk.uid, trk.prefix_len >= self.min_hits)
            out.extend(self._pop(frame))
        return out

    def finish(self) -> List[dict]:
        """End of stream: force-pop every remaining track
        (``pop_expired(expiry_age=0)``, extract.py:357)."""
        for trk in self.tracks.values():
            trk.finalized = True
            self._validity.setdefault(trk.uid,
                                      trk.prefix_len >= self.min_hits)
        return self._pop(None)

    # ------------------------------------------------------------------
    def track_valid(self, uid: int) -> Optional[bool]:
        """Face-save validity of a track; None while undecided."""
        return self._validity.get(uid)

    # ------------------------------------------------------------------
    def _pop(self, frame: Optional[int]) -> List[dict]:
        out = []
        for u in sorted(self.tracks):
            trk = self.tracks[u]
            if not trk.finalized:
                if frame is not None:
                    continue
            elif frame is not None and frame - trk.last_update < self.expiry_age:
                continue
            del self.tracks[u]
            if trk.prefix_len < self.min_hits:
                continue
            # strip trailing predictions (sort.py:371)
            length = trk.last_update - trk.first_frame + 1
            bbs = [round_clip_box(b, self.width, self.height)
                   for b in trk.boxes[:length]]
            out.append(records.trajectory_record(
                trk.first_frame, bbs, trk.detected[:length],
                self.width, self.height))
            self.n_written += 1
        return out
