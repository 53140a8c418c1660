"""Detection scoring of ``facerec_tpu/tools/selfcheck.py``.

Only :func:`score_detections` is ported: the probe-quality replay scores
the port's extract + merge output with it.  The rest of ``selfcheck``
trains a detector and an embedder, and waits for the trainers.
"""
from __future__ import annotations

import json
import os

from facerec_torch.ops.boxes import iou_single


def score_detections(data_dir: str, truth, iou_thr: float = 0.5,
                     save_every: int = 5):
    """One-to-one greedy matching of features.jsonl boxes against the
    per-frame ground truth: each truth box is consumed by at most one
    prediction (duplicates count against precision), and recall counts
    every truth box on every feature-cadence frame — whole-frame misses
    count against recall."""
    preds_by_frame = {}
    with open(os.path.join(data_dir, "features.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            preds_by_frame.setdefault(rec["frame"], []).append(rec["box"])

    n_pred = n_match = n_truth = 0
    for fr, gts_full in truth.items():
        if fr % save_every != 0:
            continue
        gts = [t[0] for t in gts_full]
        preds = preds_by_frame.get(fr, [])
        used = [False] * len(gts)
        n_pred += len(preds)
        n_truth += len(gts)
        for p in preds:
            cand = [(iou_single(p, g), k) for k, g in enumerate(gts)
                    if not used[k]]
            if not cand:
                continue
            best, k = max(cand)
            if best >= iou_thr:
                used[k] = True
                n_match += 1
    precision = n_match / n_pred if n_pred else 0.0
    recall = n_match / n_truth if n_truth else 0.0
    return {"n_pred": n_pred, "n_matched": n_match,
            "precision": round(precision, 3), "recall": round(recall, 3)}
