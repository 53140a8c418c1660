"""End-to-end self-check: train both models → full pipeline → score.

Port of ``facerec_tpu/tools/selfcheck.py``.  Trains the single-stage
detector (anchor multi-task loss) and the FaceNet embedder (semi-hard
triplet mining) from scratch on synthetic faces with persistent
identities, recalibrates their BatchNorm statistics, deploys both
through extract → merge → cluster → classify on a fresh synthetic film,
and scores the output against ground truth:

  - detection precision/recall at IoU 0.5 (one-to-one matching)
  - scene-cut exactness
  - cluster identity purity (trajectories of one actor cluster together)
  - classification accuracy (each cluster's top predicted actor is its
    majority ground-truth identity, via an actor DB built from held-out
    crops embedded with the trained embedder)

Trainers, weight save/load, the extract path, merge, clustering and KNN
classification in one command, with no external data or checkpoints.
The film is painted in memory and deployed with ``save_images=False``,
so no video or image codec is needed (the card's host has none).

Usage (the JAX package's pinned probe budget):
    python -m facerec_torch.tools.selfcheck --out /tmp/selfcheck \\
        --film-width 384 --film-height 288 --detector-size 384 \\
        --identities 3 --film-frames 180 --assert
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

from facerec_torch.ops.boxes import iou_single


def deploy_style_batch(rng, batch: int, input_size, deploy_hw,
                       face_size, identities: int = 64,
                       identity_base: int = 1000):
    """One training/calibration batch rendered at display resolution and
    pushed through the deploy harness's bilinear downscale (anti-aliased,
    as ``jax.image.resize``) and letterbox pad, with targets scaled to
    input pixels.

    Returns (frames uint8 (B, ih, iw, 3), boxes, valid, landmarks) as
    numpy arrays — the distribution :class:`DetectorHarness` sees at
    deploy, down to the resize smoothing and letterbox boundary.
    """
    from facerec_torch.video.synth import synth_batch

    ih, iw = input_size
    dh, dw = deploy_hw
    scale = min(ih / dh, iw / dw)
    ch, cw = int(round(dh * scale)), int(round(dw * scale))
    frames, boxes, valid, ldm = synth_batch(
        rng, batch, dw, dh, face_size=face_size, identities=identities,
        identity_base=identity_base)
    if (ch, cw) != (dh, dw):
        x = torch.from_numpy(frames).to(torch.float32).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(ch, cw), mode="bilinear",
                          align_corners=False, antialias=True)
        frames = np.clip(np.round(x.permute(0, 2, 3, 1).numpy()), 0,
                         255).astype(np.uint8)
    frames = np.pad(frames, ((0, 0), (0, ih - ch), (0, iw - cw), (0, 0)))
    return frames, boxes * scale, valid, ldm * scale


def _content_hw(input_size, deploy_hw, batch: int) -> np.ndarray:
    ih, iw = input_size
    dh, dw = deploy_hw
    scale = min(ih / dh, iw / dw)
    return np.tile(np.asarray(
        [round(dh * scale), round(dw * scale)], np.float32), (batch, 1))


def recalibrate_detector(model, input_size, deploy_hw, face_size,
                         n_batches: int = 32, batch: int = 16,
                         seed: int = 12345) -> None:
    """Fresh BN running statistics for ``model`` (in place, on its
    device) from deploy-matched synthetic batches; the seed is disjoint
    from the training stream, so the calibration set is held out."""
    from facerec_torch.models.detector import normalize_images
    from facerec_torch.train.recalibrate import recalibrate_batch_stats

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    recalibrate_batch_stats(
        model, (deploy_style_batch(rng, batch, input_size, deploy_hw,
                                   face_size)[0] for _ in range(n_batches)),
        lambda m, x: m(normalize_images(torch.as_tensor(x, device=dev))))


def recalibrate_embedder(model, n_identities: int, n_batches: int = 16,
                         crops_per_id: int = 4, ids_per_batch: int = 4,
                         seed: int = 54321) -> None:
    """Fresh BN running statistics for the trained FaceNet (in place)
    from held-out identity crops (the trainer's distribution, a
    disjoint seed); each BN unwinds at its own momentum."""
    from facerec_torch.models.facenet import prewhiten
    from facerec_torch.train.recalibrate import recalibrate_batch_stats
    from facerec_torch.video.synth import identity_crops

    dev = next(model.parameters()).device
    rng = np.random.default_rng(seed)

    def batches():
        for _ in range(n_batches):
            ids = rng.choice(n_identities,
                             size=min(ids_per_batch, n_identities),
                             replace=False)
            yield np.concatenate([
                identity_crops(rng, int(a), crops_per_id) for a in ids])

    recalibrate_batch_stats(
        model, batches(),
        forward=lambda m, x: m(prewhiten(torch.from_numpy(x).to(dev))
                               .permute(0, 3, 1, 2)))


def train_detector(steps: int, batch: int, input_size, deploy_hw,
                   face_size, seed: int = 0, log_every: int = 50,
                   backbone_width: int = 96, device=None):
    """Train a FaceDetector from scratch (weights from ``seed``) on
    synthetic frames through the deploy resize + letterbox, padding
    anchors labelled negative.  64 random identity styles from a
    disjoint id range: the film's identities 0..K-1 stay held out.

    Returns (model in train mode, losses logged every ``log_every``
    steps and at the last)."""
    from facerec_torch.models.detector import FaceDetector
    from facerec_torch.models.layers import init_weights
    from facerec_torch.train import DetectorTrainer

    rng = np.random.default_rng(seed)
    model = FaceDetector(backbone_width=backbone_width)
    init_weights(model, torch.Generator().manual_seed(seed))
    trainer = DetectorTrainer(model, input_size=input_size,
                              learning_rate=1e-3, device=device)
    content = _content_hw(input_size, deploy_hw, batch)
    losses = []
    for s in range(steps):
        frames, boxes, valid, ldm = deploy_style_batch(
            rng, batch, input_size, deploy_hw, face_size)
        loss = trainer.step(frames, boxes, valid, ldm, content_hw=content)
        if s % log_every == 0 or s == steps - 1:
            losses.append(float(loss))
            print(f"step {s}: loss {losses[-1]:.3f}", flush=True)
    return trainer.model, losses


def embedder_batch(rng, n_identities: int, ids_per_batch: int = 4,
                   crops_per_id: int = 4):
    """One PK batch of synthetic identity crops: (crops, labels)."""
    from facerec_torch.video.synth import identity_crops

    ids = rng.choice(n_identities, size=min(ids_per_batch, n_identities),
                     replace=False)
    crops = np.concatenate([identity_crops(rng, int(a), crops_per_id)
                            for a in ids])
    return crops, np.repeat(ids.astype(np.int32), crops_per_id)


def train_embedder(steps: int, n_identities: int, ids_per_batch: int = 4,
                   crops_per_id: int = 4, seed: int = 1,
                   log_every: int = 50, device=None):
    """Train the 128-d FaceNet from scratch with semi-hard triplet
    mining on synthetic identity crops; returns (model, losses)."""
    from facerec_torch.train.facenet_train import FaceNetTrainer

    rng = np.random.default_rng(seed)
    trainer = FaceNetTrainer(embedding_dim=128, learning_rate=3e-4,
                             device=device)
    losses = []
    for s in range(steps):
        loss = trainer.step(*embedder_batch(rng, n_identities,
                                            ids_per_batch, crops_per_id))
        if s % log_every == 0 or s == steps - 1:
            losses.append(float(loss))
            print(f"embed step {s}: loss {losses[-1]:.4f}", flush=True)
    return trainer.model, losses


def trajectory_identities(data_dir: str, clip, iou_thr: float = 0.5):
    """Majority ground-truth identity per trajectory (IoU vote of each
    trajectory's boxes against the clip's truth); -1 where no box ever
    matched."""
    out = []
    with open(os.path.join(data_dir, "trajectories.jsonl")) as f:
        for line in f:
            t = json.loads(line)
            votes = {}
            for k, bb in enumerate(t["bbs"]):
                fr = t["start"] + k
                for g, (gbox, _) in enumerate(clip.truth.get(fr, [])):
                    if iou_single(bb, gbox) >= iou_thr:
                        ident = clip.truth_ids[fr][g]
                        votes[ident] = votes.get(ident, 0) + 1
            out.append(max(votes, key=votes.get) if votes else -1)
    return out


def cluster_purity(clusters, traj_ids):
    """Weighted majority-identity fraction over clusters (trajectories
    of unknown identity -1 are left out of both sides, so a cluster of
    spurious detections does not count as pure), plus the majority
    identity per cluster (-1 when a cluster has no known identity)."""
    clusters = np.asarray(clusters)
    traj_ids = np.asarray(traj_ids)
    pure = known = 0
    majority = {}
    for c in np.unique(clusters):
        ids = traj_ids[(clusters == c) & (traj_ids >= 0)]
        if ids.size == 0:
            majority[int(c)] = -1
            continue
        vals, counts = np.unique(ids, return_counts=True)
        k = int(np.argmax(counts))
        majority[int(c)] = int(vals[k])
        pure += int(counts[k])
        known += int(ids.size)
    return (round(pure / known, 3) if known else None), majority


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


def check_gates(report: dict, min_precision: float = 0.9,
                min_recall: float = 0.9, min_purity: float = 0.9,
                min_accuracy: float = 0.9):
    """Quality gates on a selfcheck report; returns failure messages
    (empty = every gate passes)."""
    failures = []
    det = report.get("detection", {})

    def gate(name, value, minimum):
        if value is None:
            failures.append(f"{name}: missing (expected >= {minimum})")
        elif value < minimum:
            failures.append(f"{name}: {value} < {minimum}")

    gate("detection precision", det.get("precision"), min_precision)
    gate("detection recall", det.get("recall"), min_recall)
    gate("cluster purity", report.get("cluster_purity"), min_purity)
    gate("classify accuracy", report.get("classify_accuracy"),
         min_accuracy)
    found = set(report.get("scene_cuts_found", []))
    for cut in report.get("scene_cuts_truth", []):
        if cut not in found:
            failures.append(f"scene cut {cut}: not detected "
                            f"(found {sorted(found)})")
    return failures


def write_actor_zip(path: str, embedder, n_identities: int,
                    seed: int = 99) -> None:
    """An ``actor-images.zip`` of JSON sidecars (no images): actor
    100+i is identity i, 8 held-out crops each embedded with
    ``embedder``."""
    from facerec_torch.config import EMB_NAME
    from facerec_torch.video.synth import identity_crops

    rng = np.random.default_rng(seed)
    with zipfile.ZipFile(path, "w") as z:
        for a in range(n_identities):
            crops = identity_crops(rng, a, 8)
            vecs = embedder(torch.from_numpy(crops).to(
                next(embedder.model.parameters()).device)).cpu().numpy()
            for i, v in enumerate(vecs):
                z.writestr(f"img_{a}_{i}.jpeg.json", json.dumps({
                    "box": [0, 0, 10, 10],
                    "embeddings": {EMB_NAME: v.tolist()},
                    "actorID": str(100 + a),
                    "actorname": f"Actor {a}",
                }))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    """Train, recalibrate, deploy and score (the body of :func:`main`);
    returns the report, which also lands in ``<out>/selfcheck.json``.
    ``wall_s`` holds the wall seconds of each part."""
    from facerec_torch.config import (EMB_NAME, FACENET_DIMS,
                                      FACENET_MODELS, ClusterConfig,
                                      ExtractConfig, MergeConfig,
                                      PipelineConfig)
    from facerec_torch.models.convert import save_params_npz
    from facerec_torch.models.detector import DetectorHarness
    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.models.load import load_facenet_embedders
    from facerec_torch.pipeline.extract import EmbedderBank
    from facerec_torch.pipeline.orchestrate import build_stages, run_pipeline
    from facerec_torch.runtime.device import resolve_device
    from facerec_torch.video.synth import make_frames

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    size = (args.detector_size, args.detector_size)
    film_hw = (args.film_height, args.film_width)
    film_faces = (28.0, 44.0)   # make_frames' face-width range
    k = args.identities
    wall = {}

    def part(name, fn):
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        wall[name] = time.perf_counter() - t
        return out

    print("=== training detector on synthetic faces ===", flush=True)
    det_model, det_losses = part("train_detector", lambda: train_detector(
        args.train_steps, args.batch, size, deploy_hw=film_hw,
        face_size=film_faces, backbone_width=args.backbone_width,
        device=dev))
    if args.recalibrate:
        print("=== recalibrating detector BN statistics ===", flush=True)
        part("recalibrate_detector", lambda: recalibrate_detector(
            det_model, size, film_hw, film_faces))
    weights_path = os.path.join(args.out, "detector.npz")
    save_params_npz(weights_path, det_model)

    print("=== training embedder on synthetic identities ===", flush=True)
    emb_model, emb_losses = part("train_embedder", lambda: train_embedder(
        args.embedder_steps, k, device=dev))
    if args.recalibrate:
        print("=== recalibrating embedder BN statistics ===", flush=True)
        part("recalibrate_embedder",
             lambda: recalibrate_embedder(emb_model, k))
    weights_dir = os.path.join(args.out, "facenet")
    os.makedirs(weights_dir, exist_ok=True)
    save_params_npz(os.path.join(weights_dir, EMB_NAME + ".npz"), emb_model)

    def deploy():
        # the trained weights come back through the loaders
        trained = load_facenet_embedders(weights_dir, names=(EMB_NAME,),
                                         device=dev)[EMB_NAME]
        bank = EmbedderBank({
            name: (trained if name == EMB_NAME else
                   FaceNetEmbedder(name, FACENET_DIMS[name], dev, seed=i))
            for i, name in enumerate(FACENET_MODELS)})
        detector = DetectorHarness.from_npz(
            weights_path, device=dev, input_size=size, max_detections=16,
            score_threshold=args.face_threshold, min_face_size=20)
        clip = make_frames(args.film_frames, width=args.film_width,
                           height=args.film_height,
                           cuts=(args.film_frames // 3,
                                 2 * args.film_frames // 3), n_faces=2,
                           identities=k, path="777-Selfcheck_Film.mp4")
        actors_dir = os.path.join(args.out, "actors")
        os.makedirs(actors_dir, exist_ok=True)
        write_actor_zip(os.path.join(actors_dir, "actor-images.zip"),
                        trained, k)
        # probe-scale cluster size: the default (18 trajectories per
        # cluster) lumps a tiny film's trajectories into one cluster
        cfg = PipelineConfig(
            extract=ExtractConfig(face_threshold=args.face_threshold,
                                  resume=False, save_images=False),
            merge=MergeConfig(min_face_size=20),
            cluster=ClusterConfig(size=2, min_size=1, max_size=4))
        data_root = os.path.join(args.out, "data")
        data_dir = os.path.join(data_root, "777-data")
        stages = build_stages(clip, data_root, cfg, actors_dir=actors_dir,
                              device=dev, detector=detector, embedders=bank)
        if not run_pipeline(stages, data_dir=data_dir, device=dev):
            raise RuntimeError("the selfcheck's pipeline failed "
                               "(traceback above)")
        return clip, data_dir

    print("=== running pipeline with trained models ===", flush=True)
    clip, data_dir = part("deploy", deploy)

    def load(name):
        with open(os.path.join(data_dir, name)) as f:
            return json.load(f)

    predictions = load("predictions.json")["predictions"]
    clusters = load("clusters.json")["clusters"]
    purity, majority = cluster_purity(
        clusters, trajectory_identities(data_dir, clip))
    # classification accuracy: top predicted actor == majority identity
    correct = total = 0
    for c, m in majority.items():
        pred = predictions.get(str(c), {})
        if not pred or m < 0:
            continue
        total += 1
        top = max(pred, key=pred.get)
        correct += int(top == f"momaf:elonet_henkilo_{100 + m}")
    counters = load("run_report.json")[
        f"extract_0-{args.film_frames}"]["counters"]
    report = {
        "device": str(dev),
        "detector_loss": [det_losses[0], det_losses[-1]],
        "embedder_loss": [emb_losses[0], emb_losses[-1]],
        "saved_boxes": counters["saved_boxes"],
        "saved_trajectories": counters["saved_trajectories"],
        "detection": score_detections(data_dir, clip.truth),
        "scene_cuts_found": load("scene_changes.json")["frame_indices"],
        "scene_cuts_truth": clip.scene_cuts,
        "cluster_purity": purity,
        "classify_accuracy": (round(correct / total, 3) if total
                              else None),
        "predictions": predictions,
        "wall_s": wall,
    }
    with open(os.path.join(args.out, "selfcheck.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--out", type=str, default="./selfcheck")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default: the card) or cpu")
    parser.add_argument("--train-steps", type=int, default=200)
    parser.add_argument("--embedder-steps", type=int, default=150)
    parser.add_argument("--identities", type=int, default=4)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--film-frames", type=int, default=240)
    parser.add_argument("--film-width", type=int, default=768,
                        help="synthetic film display width; the pinned "
                             "probe budget uses 384x288 (no deploy "
                             "downscale)")
    parser.add_argument("--film-height", type=int, default=576)
    parser.add_argument("--face-threshold", type=float, default=0.9)
    parser.add_argument("--detector-size", type=int, default=512)
    parser.add_argument("--backbone-width", type=int, default=96,
                        help="detector backbone width")
    parser.add_argument("--no-recalibrate", dest="recalibrate",
                        action="store_false",
                        help="skip the post-training BN running-stat "
                             "recalibration (train/recalibrate.py)")
    parser.add_argument("--assert", dest="assert_gates",
                        action="store_true",
                        help="fail (exit 1) when a quality gate misses: "
                             "detection precision/recall, scene cuts, "
                             "cluster purity, classification accuracy")
    parser.add_argument("--min-precision", type=float, default=0.9)
    parser.add_argument("--min-recall", type=float, default=0.9)
    parser.add_argument("--min-purity", type=float, default=0.8)
    parser.add_argument("--min-accuracy", type=float, default=0.9)
    args = parser.parse_args(argv)
    if args.identities < 3:
        parser.error("--identities must be >= 3 (the classify stage "
                     "requires 3 classes and the clip needs 2 faces "
                     "per scene)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    report = run(args)
    print(json.dumps(report, indent=2))
    if args.assert_gates:
        failures = check_gates(
            report, min_precision=args.min_precision,
            min_recall=args.min_recall, min_purity=args.min_purity,
            min_accuracy=args.min_accuracy)
        if failures:
            print("SELFCHECK GATES FAILED:", flush=True)
            for f in failures:
                print(f"  - {f}", flush=True)
            return 1
        print("Selfcheck gates passed.", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
