"""Embedding-parity meter: our features.jsonl vs a reference run's.

Port of ``facerec_tpu/tools/embedding_eval.py`` (host numpy); its
report equals the JAX package's on the same files.

The other half of BASELINE.md's north star is *embedding parity*: a
user switching from the reference must get the same FaceNet vectors
for the same faces.  This tool takes a ``features.jsonl`` produced by
the REFERENCE pipeline (reference facerec/extract.py:186-195 —
its exact record schema is our contract schema) and one produced by
ours for the same film, matches records by frame + box IoU (the boxes
need not be byte-equal: the detectors differ slightly), and reports
per-checkpoint cosine-distance distributions with a pass/fail gate::

  python -m facerec_torch.tools.embedding_eval \
      --ref ref-data/features.jsonl --ours port-data/features.jsonl \
      --max-p95 0.1

Exit code 1 when any shared checkpoint's p95 cosine distance exceeds
the gate — usable as a CI/parity assertion after a weight import
(models/load.py).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import numpy as np


def _iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def load_features(path: str) -> Dict[int, List[dict]]:
    """features.jsonl → frame → [{"box", "embeddings"}]."""
    by_frame: Dict[int, List[dict]] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            by_frame.setdefault(int(rec["frame"]), []).append(rec)
    return by_frame


def match_records(ref: Dict[int, List[dict]], ours: Dict[int, List[dict]],
                  iou_thr: float = 0.5) -> List[Tuple[dict, dict]]:
    """Greedy best-IoU one-to-one matching per frame."""
    pairs = []
    for frame, ref_recs in ref.items():
        cand = ours.get(frame, [])
        used = [False] * len(cand)
        for r in ref_recs:
            best, best_k = 0.0, -1
            for k, o in enumerate(cand):
                if used[k]:
                    continue
                v = _iou(r["box"], o["box"])
                if v > best:
                    best, best_k = v, k
            if best >= iou_thr:
                used[best_k] = True
                pairs.append((r, cand[best_k]))
    return pairs


def cosine_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise 1 - cosine similarity (0 = identical direction)."""
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    denom = np.maximum(na * nb, 1e-12)
    return 1.0 - (a * b).sum(axis=-1) / denom


def evaluate_embedding_parity(ref_path: str, ours_path: str,
                              iou_thr: float = 0.5,
                              max_p95: float = 0.1) -> dict:
    """Per-checkpoint cosine-distance distribution over matched faces."""
    ref = load_features(ref_path)
    ours = load_features(ours_path)
    pairs = match_records(ref, ours, iou_thr)
    n_ref = sum(len(v) for v in ref.values())
    n_ours = sum(len(v) for v in ours.values())

    ref_names = {n for recs in ref.values() for r in recs
                 for n in r["embeddings"]}
    our_names = {n for recs in ours.values() for r in recs
                 for n in r["embeddings"]}
    shared = sorted(ref_names & our_names)

    report = {
        "n_ref_faces": n_ref,
        "n_our_faces": n_ours,
        "n_matched": len(pairs),
        "match_rate": round(len(pairs) / n_ref, 4) if n_ref else 0.0,
        "checkpoints_ref_only": sorted(ref_names - our_names),
        "checkpoints_ours_only": sorted(our_names - ref_names),
        "checkpoints": {},
        "max_p95": max_p95,
    }
    ok = bool(shared) and bool(pairs)
    for name in shared:
        both = [(r["embeddings"][name], o["embeddings"][name])
                for r, o in pairs
                if name in r["embeddings"] and name in o["embeddings"]]
        if not both:
            report["checkpoints"][name] = {"n": 0}
            ok = False
            continue
        a = np.asarray([b[0] for b in both], np.float64)
        b = np.asarray([b[1] for b in both], np.float64)
        d = cosine_distance(a, b)
        p95 = float(np.percentile(d, 95))
        report["checkpoints"][name] = {
            "n": len(d),
            "mean_cos_dist": round(float(d.mean()), 6),
            "median_cos_dist": round(float(np.median(d)), 6),
            "p95_cos_dist": round(p95, 6),
            "max_cos_dist": round(float(d.max()), 6),
            "pass": p95 <= max_p95,
        }
        ok = ok and p95 <= max_p95
    report["pass"] = ok
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--ref", required=True,
                        help="features.jsonl from the reference pipeline")
    parser.add_argument("--ours", required=True,
                        help="features.jsonl from this pipeline")
    parser.add_argument("--iou", type=float, default=0.5,
                        help="box IoU to match faces across the runs")
    parser.add_argument("--max-p95", type=float, default=0.1,
                        help="parity gate: p95 cosine distance per "
                             "checkpoint must stay below this")
    parser.add_argument("--out", default=None,
                        help="write the report JSON here too")
    args = parser.parse_args(argv)

    report = evaluate_embedding_parity(args.ref, args.ours,
                                       iou_thr=args.iou,
                                       max_p95=args.max_p95)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if not report["pass"]:
        print("EMBEDDING PARITY: FAIL", file=sys.stderr)
        return 1
    print("EMBEDDING PARITY: PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
