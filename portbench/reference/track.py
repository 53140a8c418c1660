"""SORT over the film, plainly (float64 numpy), with the extract
stage's lifecycle, trajectory records and face selection.

Per frame: a scene cut drops every track; the followed tracks predict
(constant-velocity Kalman filter on [cx, cy, area, aspect]); valid
detections are matched to tracks by the assignment that makes the most
pairs with IoU >= ``iou_threshold`` and, among those, the largest total
IoU; matched tracks update (Joseph form); a track is dropped when it
has gone ``max_age`` frames unmatched after ``min_hits`` entries, or
missed a match within its first ``min_hits`` entries; each unmatched
detection starts a track while fewer than ``max_tracks`` are followed.

A track's trajectory record holds its entries up to its last matched
frame, boxes rounded half to even and clipped to the frame, and is
written when its first ``min_hits`` entries were all matched.  A face is
saved at each frame divisible by ``save_every`` for each detection that
joined such a track: its posterior box, rounded, and its landmarks,
rounded (``keypoints``) and as they are (``landmarks``, (5, 2)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

F = np.eye(8) + np.eye(8, k=4)
H = np.eye(4, 8)
R = np.diag([1.0, 1.0, 10.0, 10.0])
Q = np.eye(8)
Q[4:, 4:] *= 0.01
Q[7, 7] *= 0.01
P0 = np.eye(8)
P0[4:, 4:] *= 1000.0
P0 *= 10.0


def box_to_z(b: np.ndarray) -> np.ndarray:
    w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    return np.stack([b[..., 0] + w / 2, b[..., 1] + h / 2, w * h, w / h], -1)


def z_to_box(z: np.ndarray) -> np.ndarray:
    w = np.sqrt(np.clip(z[..., 2] * z[..., 3], 0, None))
    h = np.where(w > 0, z[..., 2] / np.where(w > 0, w, 1.0), 0.0)
    return np.stack([z[..., 0] - w / 2, z[..., 1] - h / 2,
                     z[..., 0] + w / 2, z[..., 1] + h / 2], -1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a[:, None], b[None]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def max_weight_matching(w: np.ndarray) -> List[Tuple[int, int]]:
    """Rows matched to columns maximising the total of ``w`` >= 0 (the
    Hungarian method on the square matrix padded with zeros)."""
    n = max(w.shape)
    cost = np.zeros((n, n))
    cost[:w.shape[0], :w.shape[1]] = -w
    u, v = np.zeros(n + 1), np.zeros(n + 1)
    p, way = np.zeros(n + 1, int), np.zeros(n + 1, int)
    for i in range(1, n + 1):
        p[0], j0 = i, 0
        minv = np.full(n + 1, np.inf)
        used = np.zeros(n + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return [(int(p[j]) - 1, j - 1) for j in range(1, n + 1)
            if p[j] and p[j] - 1 < w.shape[0] and j - 1 < w.shape[1]]


def associate(iou: np.ndarray, thr: float) -> Dict[int, int]:
    """detection → track: the most pairs at IoU >= thr, then the
    largest total IoU."""
    ok = iou >= thr
    if not ok.any():
        return {}
    w = np.where(ok, iou + 1.0, 0.0)
    rows = np.flatnonzero(ok.any(1))
    best = w[rows].argmax(1)
    unique = (w[rows] == w[rows].max(1, keepdims=True)).sum(1) == 1
    if unique.all() and len(set(best.tolist())) == len(best):
        return dict(zip(rows.tolist(), best.tolist()))
    return {d: t for d, t in max_weight_matching(w) if ok[d, t]}


@dataclasses.dataclass
class Track:
    uid: int
    first: int
    x: np.ndarray
    p: np.ndarray
    hist: int = 1
    hits: int = 1
    initial: int = 1
    tsu: int = 0
    boxes: List[np.ndarray] = dataclasses.field(default_factory=list)
    detected: List[bool] = dataclasses.field(default_factory=list)


def round_clip(box, w: int, h: int) -> List[int]:
    b = np.minimum(np.maximum(np.asarray(box, np.float64), 0),
                   [w, h, w, h])
    return [int(c) for c in np.round(b)]


@dataclasses.dataclass
class Result:
    trajectories: List[dict]      # {"start", "len", "bbs", "detected"}
    faces: List[dict]             # {"frame", "box", "keypoints", "landmarks"}


def run(dets: Sequence, cuts: np.ndarray, width: int, height: int,
        max_tracks: int = 32, max_age: int = 5, min_hits: int = 3,
        iou_threshold: float = 0.5, save_every: int = 5) -> Result:
    """``dets[i]``: frame i's detections (``boxes``, ``landmarks`` in
    pick order); ``cuts[i]``: frame i starts a shot."""
    tracks: List[Track] = []
    done: List[Track] = []
    joined: List[Tuple[int, Track, np.ndarray]] = []   # (frame, track, ldm)
    next_uid = 0
    for f in range(len(cuts)):
        if cuts[f]:
            done.extend(tracks)
            tracks = []
        for t in tracks:
            x = t.x.copy()
            if x[6] + x[2] < 1e-3:
                x[6] = 0.0
            if x[7] + x[3] < 1e-3:
                x[7] = 0.0
            t.x, t.p = F @ x, F @ t.p @ F.T + Q
            t.tsu += 1
            t.hist += 1
        d = dets[f]
        boxes = np.asarray(d.boxes, np.float64).reshape(-1, 4)
        match: Dict[int, int] = {}
        if len(tracks) and len(boxes):
            prior = z_to_box(np.stack([t.x[:4] for t in tracks]))
            match = associate(iou_matrix(boxes, prior), iou_threshold)
        matched = set(match.values())
        for di, ti in match.items():
            t = tracks[ti]
            s = H @ t.p @ H.T + R
            k = t.p @ H.T @ np.linalg.inv(s)
            t.x = t.x + k @ (box_to_z(boxes[di]) - H @ t.x)
            ikh = np.eye(8) - k @ H
            t.p = ikh @ t.p @ ikh.T + k @ R @ k.T
            t.hits += 1
            t.tsu = 0
            if t.hist == t.hits:
                t.initial += 1
        keep = []
        for i, t in enumerate(tracks):
            t.boxes.append(z_to_box(t.x[:4]))
            t.detected.append(i in matched)
            expired = t.tsu > max_age and t.hist >= min_hits
            not_started = t.hist <= min_hits and t.initial < t.hist
            (done if expired or not_started else keep).append(t)
        for di, ti in match.items():
            joined.append((f, tracks[ti], d.landmarks[di]))
        free = max_tracks - len(tracks)
        for di in range(len(boxes)):
            if di in match or free <= 0:
                continue
            free -= 1
            z = box_to_z(boxes[di])
            t = Track(next_uid, f, np.concatenate([z, np.zeros(4)]),
                      P0.copy())
            next_uid += 1
            t.boxes.append(z_to_box(z))
            t.detected.append(True)
            keep.append(t)
            joined.append((f, t, d.landmarks[di]))
        tracks = keep
    done.extend(tracks)

    def prefix(t: Track) -> int:
        n = 0
        while n < len(t.detected) and t.detected[n]:
            n += 1
        return n

    valid = {t.uid: prefix(t) >= min_hits for t in done}
    trajectories = []
    for t in done:
        if not valid[t.uid]:
            continue
        last = max(i for i, d in enumerate(t.detected) if d)
        trajectories.append({
            "start": t.first, "len": last + 1,
            "bbs": [round_clip(b, width, height) for b in t.boxes[:last + 1]],
            "detected": list(t.detected[:last + 1])})
    faces = []
    for f, t, ldm in joined:
        if f % save_every or not valid[t.uid]:
            continue
        faces.append({
            "frame": f,
            "box": round_clip(t.boxes[f - t.first], width, height),
            "keypoints": [int(round(float(v))) for v in
                          np.asarray(ldm, np.float64).reshape(-1)],
            "landmarks": np.asarray(ldm, np.float64).reshape(5, 2)})
    return Result(trajectories, faces)
