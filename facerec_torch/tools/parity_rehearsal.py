"""Parity rehearsal: one command from a reference run to a verdict.

Port of ``facerec_tpu/tools/parity_rehearsal.py``: the chain is the
port's distillation (its checkpoint is the ``.npz`` that
:func:`facerec_torch.train.distill.distill` writes), ``detector_eval``,
``run_extract`` and ``embedding_eval``, on ``--device`` (the card
unless ``cpu``).  Its data needs a video decoder (OpenCV or the repo's
native library).

THE migration-validation path for a reference user.  Given a film and
the ``features.jsonl`` a reference pipeline run produced for it
(reference facerec/extract.py:186-195 — carries the MTCNN boxes,
5-point keypoints, and all four FaceNet embeddings), this chains the
whole parity toolchain into a single pass/fail report:

  1. **distill** — train our FPN+SSH detector on the reference's
     detections over the film's decoded frames
     (:mod:`facerec_torch.train.distill`); skipped when
     ``--detector-weights`` provides an existing checkpoint.
  2. **detector_eval** — run the (distilled) detector over the frames
     the reference detected on; box precision/recall/IoU vs the
     reference boxes (:mod:`facerec_torch.tools.detector_eval`).
  3. **extract** — the REAL production stage with the distilled
     detector (+ imported FaceNet weights when given), parity-first
     defaults (rgb wire, native-resolution detector).
  4. **embedding_eval** — reference vs our ``features.jsonl``,
     per-checkpoint cosine-distance gates
     (:mod:`facerec_torch.tools.embedding_eval`).

Run::

  python -m facerec_torch.tools.parity_rehearsal \
      --film 125261-Name.mp4 --ref-features ref-data/features.jsonl \
      --out /tmp/rehearsal --steps 4000 \
      --facenet-weights facenet_ckpts/

Exit code 1 unless every gate passes (detector recall/precision at
matched-IoU ≥ the gates AND every shared FaceNet checkpoint's p95
cosine distance ≤ the gate).  The report JSON lands in
``<out>/parity_report.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from facerec_torch.config import ExtractConfig
from facerec_torch.contract.naming import movie_id_from_filename


def _ref_boxes_by_frame(ref_features: str) -> Dict[int, List[List[float]]]:
    truth: Dict[int, List[List[float]]] = {}
    with open(ref_features) as f:
        for line in f:
            rec = json.loads(line)
            truth.setdefault(int(rec["frame"]), []).append(
                [float(v) for v in rec["box"]])
    return truth


def _frames_subset(film: str, wanted, limit: int):
    """Decode only the frames the reference detected on (capped)."""
    from facerec_torch.tools.detector_eval import _decode_film

    wanted = set(sorted(wanted)[:limit])
    last = max(wanted, default=-1)
    for i, img in _decode_film(film):
        if i in wanted:
            yield i, img
        if i >= last:
            break


def run_rehearsal(
    film: str,
    ref_features: str,
    out: str,
    steps: int = 4000,
    detector_weights: Optional[str] = None,
    facenet_weights: Optional[str] = None,
    long_side: int = 512,
    max_p95: float = 0.1,
    min_recall: float = 0.8,
    min_precision: float = 0.8,
    iou: float = 0.5,
    save_every: int = 5,
    max_eval_frames: int = 200,
    model_kwargs: Optional[dict] = None,
    distill_kwargs: Optional[dict] = None,
    extract_cfg: Optional[ExtractConfig] = None,
    detector=None,
    embedders=None,
    device=None,
) -> dict:
    """Distill → detector_eval → extract → embedding_eval → verdict, on
    ``device`` (the card unless ``"cpu"``).

    ``detector``/``embedders`` allow injecting prebuilt objects (test
    stubs, on ``device``); production callers pass checkpoint paths
    instead.
    """
    from facerec_torch.pipeline.extract import run_extract
    from facerec_torch.runtime.device import resolve_device
    from facerec_torch.tools.detector_eval import (evaluate_detections,
                                                   harness_predictions)
    from facerec_torch.tools.embedding_eval import evaluate_embedding_parity

    device = resolve_device(device)

    os.makedirs(out, exist_ok=True)
    report: dict = {"film": os.path.basename(film),
                    "ref_features": ref_features}

    # 1. distill (or reuse weights)
    ckpt = detector_weights
    if detector is None and ckpt is None:
        from facerec_torch.train.distill import distill
        from facerec_torch.train.widerface import npz_path

        ckpt = npz_path(os.path.join(out, "detector_ckpt"))
        print(f"[rehearsal 1/4] distilling detector ({steps} steps) -> "
              f"{ckpt}", flush=True)
        losses = distill(film, ref_features, ckpt, steps=steps,
                         long_side=long_side,
                         model_kwargs=model_kwargs, device=device,
                         **(distill_kwargs or {}))
        report["distill"] = {"steps": steps,
                             "first_loss": round(float(losses[0]), 4),
                             "last_loss": round(float(losses[-1]), 4)}

    # 2. detector parity on the frames the reference detected on
    print("[rehearsal 2/4] detector eval vs reference boxes", flush=True)
    truth = _ref_boxes_by_frame(ref_features)
    harness = detector
    if harness is None:
        from facerec_torch.models.detector import (DetectorHarness,
                                                   fit_input_size)
        from facerec_torch.video.reader import probe_video

        info = probe_video(film, None)
        size = fit_input_size(info.display_height, info.display_width,
                              long_side=long_side)
        harness = DetectorHarness.from_npz(
            ckpt, device=device, input_size=size, max_detections=16,
            score_threshold=0.5, min_face_size=10.0)
    frames = _frames_subset(film, truth, max_eval_frames)
    preds = harness_predictions(harness, frames)
    truth_eval = {f: truth[f] for f in preds}
    det_report = evaluate_detections(preds, truth_eval, iou_thr=iou)
    det_report["pass"] = (det_report["recall"] >= min_recall
                          and det_report["precision"] >= min_precision)
    det_report["gates"] = {"min_recall": min_recall,
                           "min_precision": min_precision, "iou": iou}
    report["detector"] = det_report

    # 3. production extract with the rehearsed weights
    print("[rehearsal 3/4] production extract", flush=True)
    cfg = extract_cfg or ExtractConfig(save_every=save_every,
                                       resume=False)
    extract_out = os.path.join(out, "extract")
    run_extract(film, cfg, extract_out,
                detector=detector, embedders=embedders,
                detector_weights=None if detector is not None else ckpt,
                facenet_weights=facenet_weights, device=device)
    movie_id = movie_id_from_filename(film)
    feat_dir = os.path.join(extract_out, f"{movie_id}-data", "features")
    (feat_file,) = os.listdir(feat_dir)
    ours_features = os.path.join(feat_dir, feat_file)
    report["our_features"] = ours_features

    # 4. embedding parity
    print("[rehearsal 4/4] embedding eval vs reference features",
          flush=True)
    emb_report = evaluate_embedding_parity(ref_features, ours_features,
                                           iou_thr=iou, max_p95=max_p95)
    report["embeddings"] = emb_report

    report["pass"] = bool(det_report["pass"] and emb_report["pass"])
    report_path = os.path.join(out, "parity_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    report["report_path"] = report_path
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--film", required=True)
    parser.add_argument("--ref-features", required=True,
                        help="features.jsonl from a reference run of "
                             "the same film")
    parser.add_argument("--out", required=True,
                        help="work dir (checkpoint, extract output, "
                             "parity_report.json)")
    parser.add_argument("--steps", type=int, default=4000,
                        help="distillation steps")
    parser.add_argument("--detector-weights", default=None,
                        help="existing .npz detector checkpoint (skips "
                             "the distill step)")
    parser.add_argument("--facenet-weights", default=None,
                        help="FaceNet checkpoints dir (models/load.py); "
                             "without it the "
                             "embedding gate cannot pass against a "
                             "real reference run")
    parser.add_argument("--long-side", type=int, default=512,
                        help="distill/eval detector input long side")
    parser.add_argument("--max-p95", type=float, default=0.1,
                        help="embedding gate: p95 cosine distance")
    parser.add_argument("--min-recall", type=float, default=0.8)
    parser.add_argument("--min-precision", type=float, default=0.8)
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--save-every", type=int, default=5)
    parser.add_argument("--max-eval-frames", type=int, default=200,
                        help="cap on decoded frames for detector eval")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    args = parser.parse_args(argv)

    report = run_rehearsal(
        args.film, args.ref_features, args.out, steps=args.steps,
        detector_weights=args.detector_weights,
        facenet_weights=args.facenet_weights, long_side=args.long_side,
        max_p95=args.max_p95, min_recall=args.min_recall,
        min_precision=args.min_precision, iou=args.iou,
        save_every=args.save_every,
        max_eval_frames=args.max_eval_frames, device=args.device)

    det = report["detector"]
    print(f"detector: P={det['precision']:.3f} R={det['recall']:.3f} "
          f"matched-IoU={det['mean_matched_iou']:.3f} "
          f"-> {'PASS' if det['pass'] else 'FAIL'}")
    for name, ck in report["embeddings"]["checkpoints"].items():
        print(f"embeddings[{name}]: n={ck.get('n', 0)} "
              f"p95={ck.get('p95_cos_dist', 'n/a')} "
              f"-> {'PASS' if ck.get('pass') else 'FAIL'}")
    print(f"report: {report['report_path']}")
    print(f"PARITY REHEARSAL: {'PASS' if report['pass'] else 'FAIL'}",
          file=sys.stderr)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
