"""Detector evaluation harness: precision/recall/IoU vs ground truth.

Port of ``facerec_tpu/tools/detector_eval.py``.  Quantifies detector
quality at the reference's operating point (``face_threshold=0.95``,
``min_face_size=20``; reference facerec/detector.py:20-27) against any
of:

  - a synthetic clip's ground truth (``--truth-pkl``, a pickled
    ``SynthClip`` — the port's or the JAX package's, read without
    importing the JAX package),
  - a JSONL of reference-produced detections (``--boxes-jsonl``,
    records ``{"frame": i, "box": [x1,y1,x2,y2]}``), which makes this
    the box-IoU parity meter.

Recall is reported per face-size bucket (<20 px, 20-50 px, ≥50 px) and
``--sweep-long-side`` re-runs the harness at several detector input
scales.  :func:`evaluate_detections` is host code;
:func:`harness_predictions` runs a
:class:`~facerec_torch.models.detector.DetectorHarness` on its own
device; ``--weights`` takes a single-file ``.npz`` checkpoint.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

SIZE_BUCKETS = ((0.0, 20.0), (20.0, 50.0), (50.0, float("inf")))


def _iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


def evaluate_detections(
    preds: Dict[int, List[Tuple[List[float], float]]],
    truth: Dict[int, List[List[float]]],
    iou_thr: float = 0.5,
) -> dict:
    """Greedy one-to-one matching (descending score) per frame.

    Args:
        preds: frame → [(box, score)].
        truth: frame → [box].
    Returns P/R/mean-matched-IoU overall plus per-size-bucket recall.
    """
    n_pred = n_match = n_truth = 0
    iou_sum = 0.0
    bucket_truth = [0] * len(SIZE_BUCKETS)
    bucket_match = [0] * len(SIZE_BUCKETS)

    def bucket_of(box) -> int:
        side = min(box[2] - box[0], box[3] - box[1])
        for k, (lo, hi) in enumerate(SIZE_BUCKETS):
            if lo <= side < hi:
                return k
        return len(SIZE_BUCKETS) - 1

    # union of frames: a prediction on a frame with no truth entry is
    # a false positive and counts toward n_pred/precision
    for frame in sorted(set(truth) | set(preds)):
        gts = truth.get(frame, [])
        n_truth += len(gts)
        for g in gts:
            bucket_truth[bucket_of(g)] += 1
        used = [False] * len(gts)
        for box, _score in sorted(preds.get(frame, []),
                                  key=lambda t: -t[1]):
            n_pred += 1
            cand = [(_iou(box, g), k) for k, g in enumerate(gts)
                    if not used[k]]
            if not cand:
                continue
            best, k = max(cand)
            if best >= iou_thr:
                used[k] = True
                n_match += 1
                iou_sum += best
                bucket_match[bucket_of(gts[k])] += 1
    return {
        "n_pred": n_pred,
        "n_truth": n_truth,
        "n_matched": n_match,
        "precision": round(n_match / n_pred, 4) if n_pred else 0.0,
        "recall": round(n_match / n_truth, 4) if n_truth else 0.0,
        "mean_matched_iou": (round(iou_sum / n_match, 4)
                             if n_match else 0.0),
        "recall_by_size": {
            f"{int(lo)}-{'' if hi == float('inf') else int(hi)}px":
                (round(m / t, 4) if t else None)
            for (lo, hi), m, t in zip(SIZE_BUCKETS, bucket_match,
                                      bucket_truth)
        },
        "truth_by_size": {
            f"{int(lo)}-{'' if hi == float('inf') else int(hi)}px": t
            for (lo, hi), t in zip(SIZE_BUCKETS, bucket_truth)
        },
    }


def harness_predictions(harness,
                        frames_by_index: Iterable[Tuple[int, np.ndarray]],
                        batch: int = 16) -> Dict[int, list]:
    """Run a DetectorHarness over (frame_index, RGB image) pairs, in
    batches on the harness's device."""
    preds: Dict[int, list] = {}
    chunk: List[Tuple[int, np.ndarray]] = []

    def flush():
        if not chunk:
            return
        ims = torch.from_numpy(np.stack([c[1] for c in chunk]))
        det = harness(ims.to(harness.device))
        boxes, scores, valid = (t.cpu().numpy()
                                for t in (det.boxes, det.scores, det.valid))
        for row, (fi, _) in enumerate(chunk):
            preds[fi] = [(boxes[row, d].tolist(), float(scores[row, d]))
                         for d in range(valid.shape[1]) if valid[row, d]]
        chunk.clear()

    for fi, img in frames_by_index:
        chunk.append((fi, img))
        if len(chunk) == batch:
            flush()
    flush()
    return preds


def _decode_film(path: str):
    """(index, RGB frame) of every frame, through the port's reader at
    the film's storage size."""
    from facerec_torch.video.reader import open_block_reader, probe_video

    info = probe_video(path)
    info = type(info)(info.n_frames, info.fps, info.storage_width,
                      info.storage_height, info.storage_width,
                      info.storage_height)
    reader = open_block_reader(path, info, 64)
    try:
        for f0, block in reader.blocks(0, info.n_frames, 64):
            for i, frame in enumerate(block):
                yield f0 + i, np.ascontiguousarray(frame)
    finally:
        reader.close()


class _TruthUnpickler(pickle.Unpickler):
    """Reads a pickled ``SynthClip`` of either package as the port's
    (a plain ``pickle.load`` would import the JAX package)."""

    def find_class(self, module, name):
        if (module, name) == ("facerec_tpu.video.synth", "SynthClip"):
            from facerec_torch.video.synth import SynthClip

            return SynthClip
        if module.split(".")[0] == "facerec_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in the port")
        return super().find_class(module, name)


def load_truth_pickle(path: str):
    """The ``SynthClip`` pickled at ``path``."""
    with open(path, "rb") as f:
        return _TruthUnpickler(f).load()


def _load_truth(args) -> Dict[int, List[List[float]]]:
    if args.truth_pkl:
        clip = load_truth_pickle(args.truth_pkl)
        return {f: [t[0].tolist() for t in entries]
                for f, entries in clip.truth.items()}
    truth: Dict[int, List[List[float]]] = {}
    with open(args.boxes_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            truth.setdefault(int(rec["frame"]), []).append(
                [float(v) for v in rec["box"]])
    return truth


def build_harness(size, weights: Optional[str], face_threshold: float,
                  min_face_size: float, device=None):
    """The detector harness at input ``size``: from a ``.npz``
    checkpoint, else random-initialised (with the usual warning)."""
    from facerec_torch.models.detector import DetectorHarness
    from facerec_torch.models.load import warn_random_init

    kwargs = dict(input_size=size, max_detections=32,
                  score_threshold=face_threshold,
                  min_face_size=min_face_size)
    if weights:
        if os.path.isdir(weights):
            raise ValueError(
                f"{weights!r} is a directory (an orbax checkpoint?), which "
                f"the port cannot read without JAX; export it with "
                f"facerec_tpu.models.weights.save_params_npz and pass the "
                f".npz")
        return DetectorHarness.from_npz(weights, device=device, **kwargs)
    warn_random_init("The face detector", "--weights")
    return DetectorHarness.create(device=device, **kwargs)


def main(argv=None):
    from facerec_torch.models.detector import fit_input_size

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--film", required=True)
    parser.add_argument("--truth-pkl", default=None,
                        help="pickled SynthClip with ground truth")
    parser.add_argument("--boxes-jsonl", default=None,
                        help="JSONL of {'frame', 'box'} truth records "
                             "(e.g. reference MTCNN detections)")
    parser.add_argument("--weights", default=None,
                        help="single-file .npz detector checkpoint")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--face-threshold", type=float, default=0.95)
    parser.add_argument("--min-face-size", type=float, default=20.0)
    parser.add_argument("--iou-threshold", type=float, default=0.5)
    parser.add_argument("--sweep-long-side", default="0,512",
                        help="comma-separated detector long sides; "
                             "0 = native resolution (the parity "
                             "default; 512 is the speed opt-in)")
    parser.add_argument("--out", default=None,
                        help="write the report JSON here too")
    args = parser.parse_args(argv)
    if not args.truth_pkl and not args.boxes_jsonl:
        parser.error("need --truth-pkl or --boxes-jsonl")

    truth = _load_truth(args)
    frames = list(_decode_film(args.film))
    h, w = frames[0][1].shape[:2]

    report = {"film": args.film, "n_frames": len(frames),
              "resolution": [h, w], "sweeps": {}}
    for long_side in [int(s) for s in args.sweep_long_side.split(",")]:
        size = fit_input_size(h, w, long_side=long_side or max(h, w))
        harness = build_harness(size, args.weights, args.face_threshold,
                                args.min_face_size, args.device)
        preds = harness_predictions(harness, frames)
        metrics = evaluate_detections(preds, truth,
                                      iou_thr=args.iou_threshold)
        key = str(long_side) if long_side else "native"
        report["sweeps"][key] = {"input_size": list(size), **metrics}
        print(f"long_side={key} input={size}: "
              f"P={metrics['precision']} R={metrics['recall']} "
              f"IoU={metrics['mean_matched_iou']} "
              f"by_size={metrics['recall_by_size']}", flush=True)

    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
