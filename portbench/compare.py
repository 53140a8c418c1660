"""The comparison that decides ``correct``: the program's outputs
against the reference's, as numbers each held to a limit.

- ``cuts_off``: cut frames in one set of scene changes and not the other.
- ``det_unpaired``: detections of the pool's first pass with no partner
  (IoU >= 0.5) on the other side.
- ``det_px``: the widest gap of a paired detection's box corner or
  landmark, in pixels.
- ``det_score``: the widest gap of a paired detection's score.
- ``files_ppm``: integers of the trajectory and face records (start,
  length, boxes, detected flags; frame, box, keypoints) that differ,
  per million; a record without a partner counts whole.
- ``emb_gap``: the widest gap of an embedding element, over a sample
  (drawn from the seed) of the faces whose boxes agree, all four
  checkpoints.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NAMES = ("cuts_off", "det_unpaired", "det_px", "det_score", "files_ppm",
         "emb_gap")


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a[:, None], b[None]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2])
                 - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3])
                 - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def _greedy(score: np.ndarray, ok) -> List[Tuple[int, int]]:
    """Pairs (i, j) taken best ``score`` first (higher is better)."""
    pairs, used_i, used_j = [], set(), set()
    for flat in np.argsort(-score, axis=None, kind="stable"):
        i, j = np.unravel_index(flat, score.shape)
        if i in used_i or j in used_j or not ok(score[i, j]):
            continue
        pairs.append((int(i), int(j)))
        used_i.add(i)
        used_j.add(j)
    return pairs


def detections(got, want) -> Dict[str, float]:
    unpaired, px, sc = 0, 0.0, 0.0
    for g, w in zip(got, want):
        gb, wb = np.asarray(g.boxes, np.float64), np.asarray(w.boxes,
                                                            np.float64)
        pairs = (_greedy(_iou(gb, wb), lambda v: v >= 0.5)
                 if len(gb) and len(wb) else [])
        unpaired += len(gb) + len(wb) - 2 * len(pairs)
        for i, j in pairs:
            px = max(px, float(np.abs(gb[i] - wb[j]).max()),
                     float(np.abs(np.asarray(g.landmarks[i], np.float64)
                                  - w.landmarks[j]).max()))
            sc = max(sc, abs(float(g.scores[i]) - float(w.scores[j])))
    # frames one side has and the other lacks: all their detections
    for extra in (got[len(want):], want[len(got):]):
        unpaired += sum(len(f.boxes) for f in extra)
    return {"det_unpaired": unpaired, "det_px": px, "det_score": sc}


def _by(records, key):
    out: Dict[int, list] = {}
    for i, r in enumerate(records):
        out.setdefault(r[key], []).append(i)
    return out


def _pair_groups(got, want, key, first_box):
    """Pairs of record indices with the same ``key``, nearest first box."""
    gg, wg = _by(got, key), _by(want, key)
    pairs = []
    for k in set(gg) & set(wg):
        gi, wi = gg[k], wg[k]
        d = np.array([[np.abs(np.subtract(first_box(got[a]),
                                          first_box(want[b]))).sum()
                       for b in wi] for a in gi], np.float64)
        pairs.extend((gi[a], wi[b]) for a, b in _greedy(-d, lambda v: True))
    return pairs


def _traj_ints(t) -> int:
    return 2 + 5 * t["len"]


def _traj_diff(a, b) -> int:
    n = min(a["len"], b["len"])
    d = sum(int(x != y) for x, y in zip(a["detected"][:n], b["detected"][:n]))
    d += sum(int(x != y) for p, q in zip(a["bbs"][:n], b["bbs"][:n])
             for x, y in zip(p, q))
    return d + int(a["len"] != b["len"]) + 5 * abs(a["len"] - b["len"])


def _face_diff(a, b) -> int:
    return (sum(int(x != y) for x, y in zip(a["box"], b["box"]))
            + sum(int(x != y) for x, y in zip(a["keypoints"], b["keypoints"])))


def files(got, want, notes=None) -> Tuple[float, List[Tuple[int, int]]]:
    """(files_ppm, face pairs whose boxes agree); the first differing
    pairs go to ``notes``."""
    diff = 0
    tp = _pair_groups(got.trajectories, want.trajectories, "start",
                      lambda t: t["bbs"][0])
    for i, j in tp:
        d = _traj_diff(got.trajectories[i], want.trajectories[j])
        diff += d
        if d and notes is not None and len(notes) < 8:
            a, b = got.trajectories[i], want.trajectories[j]
            at = [k for k, (p, q) in enumerate(zip(a["bbs"], b["bbs"]))
                  if p != q][:3]
            notes.append(f"trajectory start {a['start']} len {a['len']}/"
                         f"{b['len']}: boxes differ at {at}: "
                         f"{[(a['bbs'][k], b['bbs'][k]) for k in at]}")
    for side, paired, what in ((got.trajectories, {i for i, _ in tp},
                                "program"),
                               (want.trajectories, {j for _, j in tp},
                                "reference")):
        alone = [t for k, t in enumerate(side) if k not in paired]
        diff += sum(map(_traj_ints, alone))
        if alone and notes is not None:
            notes.append(f"{len(alone)} trajectories of the {what} "
                         f"unpaired, e.g. start {alone[0]['start']} len "
                         f"{alone[0]['len']}")
    fp = _pair_groups(got.faces, want.faces, "frame", lambda f: f["box"])
    for i, j in fp:
        d = _face_diff(got.faces[i], want.faces[j])
        diff += d
        if d and notes is not None and len(notes) < 8:
            notes.append(f"face {got.faces[i]} / {want.faces[j]}")
    for side, paired, what in ((got.faces, {i for i, _ in fp}, "program"),
                               (want.faces, {j for _, j in fp}, "reference")):
        alone = [k for k in range(len(side)) if k not in paired]
        diff += 15 * len(alone)
        if alone and notes is not None:
            notes.append(f"{len(alone)} faces of the {what} unpaired, "
                         f"e.g. {side[alone[0]]}")
    total = max(sum(map(_traj_ints, got.trajectories)) + 15 * len(got.faces),
                sum(map(_traj_ints, want.trajectories))
                + 15 * len(want.faces), 1)
    same = [(i, j) for i, j in fp
            if got.faces[i]["box"] == want.faces[j]["box"]]
    return 1e6 * diff / total, same


def embeddings(got, want, same, seed: int, sample: int) -> float:
    if not same:
        return float("inf")
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 63), 3]))
    pick = sorted(rng.choice(len(same), min(sample, len(same)),
                             replace=False).tolist())
    g = got.embed([same[k][0] for k in pick])
    w = want.embed([same[k][1] for k in pick])
    return max(float(np.abs(np.asarray(g[name], np.float64)
                            - w[name]).max()) for name in w)


def compare(got, want, seed: int, sample: int = 512,
            notes=None) -> Dict[str, float]:
    """The numbers compared; what differs goes to ``notes`` (a list)."""
    out = {"cuts_off": len(set(got.cuts) ^ set(want.cuts))}
    out.update(detections(got.pool_dets, want.pool_dets))
    out["files_ppm"], same = files(got, want, notes)
    out["emb_gap"] = embeddings(got, want, same, seed, sample)
    return out
