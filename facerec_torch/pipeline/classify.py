"""KNN actor classification stage.

Port of ``facerec_tpu/pipeline/classify.py``: actor reference
embeddings come from ``actor-images.zip`` sidecars, a balanced training
set is built by upsampling, and per-face KNN probabilities are averaged
per trajectory, then per cluster.  The KNN runs on the device in one
call over every query (:mod:`facerec_torch.ops.knn`); the means stay in
host numpy.  ``predictions.json`` is byte-identical to the JAX
package's on the tested data.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from facerec_torch.config import ACTOR_ID_PREFIX, ClassifyConfig
from facerec_torch.contract import records
from facerec_torch.contract.jsonio import read_json, read_jsonl
from facerec_torch.ops.knn import knn_predict_proba
from facerec_torch.runtime.device import resolve_device, use_full_float32
from facerec_torch.runtime.metrics import StageReport


def read_actor_embeddings(zip_path: str, emb_name: str
                          ) -> Tuple[List[Tuple[int, List[float]]],
                                     Dict[int, str]]:
    """(actor_id, vector) pairs + actor names from the actor DB zip."""
    embeddings = []
    names: Dict[int, str] = {}
    with zipfile.ZipFile(zip_path) as z:
        for member in z.namelist():
            if not member.endswith(".json"):
                continue
            d = json.loads(z.read(member))
            if "box" in d:
                aid = int(d["actorID"])
                embeddings.append((aid, d["embeddings"][emb_name]))
                names[aid] = d["actorname"]
    return embeddings, names


def build_training_set(embeddings: List[Tuple[int, List[float]]],
                       min_samples: int = 20
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced training set, each actor's vectors repeated up to
    ``max(min(counts), min_samples)`` rows."""
    if not embeddings:
        return (np.empty((0, 0), np.float32), np.empty((0,), np.int32))

    actors: Dict[int, List[List[float]]] = {}
    dim = 0
    for aid, vec in embeddings:
        dim = len(vec)
        actors.setdefault(aid, []).append(vec)

    counts = [len(v) for v in actors.values()]
    n_samples = max(min(counts), min_samples)

    x = np.zeros((len(actors) * n_samples, dim), np.float32)
    y = np.zeros(len(actors) * n_samples, np.int32)
    for i, (aid, vectors) in enumerate(actors.items()):
        multiplier = (n_samples + len(vectors) - 1) // len(vectors)
        rows = np.array((vectors * multiplier)[:n_samples], np.float32)
        x[i * n_samples:(i + 1) * n_samples] = rows
        y[i * n_samples:(i + 1) * n_samples] = aid
    return x, y


def run_classify(data_dir: str, x: np.ndarray, y: np.ndarray,
                 cfg: ClassifyConfig, device=None) -> None:
    """Per-cluster actor predictions into ``predictions.json``, the KNN
    on ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    use_full_float32()
    report = StageReport("classify", dev)
    movie_id = int(os.path.basename(data_dir).split("-")[0])
    predictions_path = os.path.join(data_dir, "predictions.json")

    clusters = np.array(read_json(
        os.path.join(data_dir, "clusters.json"))["clusters"])
    uniq_clusters = sorted(set(clusters.tolist()))

    if len(np.unique(y)) < 3 or len(x) == 0:
        records.write_empty_predictions(predictions_path, uniq_clusters)
        report.set("n_classes", int(len(np.unique(y))))
        report.set("n_predictions", 0)
        report.write(data_dir)
        print(f"Not enough actor data. Wrote empty predictions: "
              f"{predictions_path}")
        return
    if cfg.k > len(x):
        raise ValueError(
            f"KNN needs k={cfg.k} training samples but the actor "
            f"training set has only {len(x)}; lower --n-faces/k or "
            f"raise min_samples when building the training set")

    vector_map = records.load_feature_map(
        os.path.join(data_dir, "features.jsonl"))

    # every face of every trajectory in one device call; rows are then
    # averaged per trajectory
    traj_slices = []
    queries = []
    for traj in read_jsonl(os.path.join(data_dir, "trajectories.jsonl")):
        vecs = records.trajectory_vectors(traj, vector_map, cfg.emb_name)
        start = len(queries)
        queries.extend(vecs)
        traj_slices.append((start, len(queries)))

    proba, classes = knn_predict_proba(
        x, y, np.array(queries, np.float32), cfg.k, dev)

    n_classes = len(classes)
    traj_preds = np.zeros((len(traj_slices), n_classes), np.float32)
    for t, (a, b) in enumerate(traj_slices):
        if b > a:
            traj_preds[t] = proba[a:b].mean(axis=0)
    if len(traj_preds) != len(clusters):
        raise ValueError(f"{len(traj_preds)} trajectories but "
                         f"{len(clusters)} cluster labels")

    cluster_preds: Dict[int, Dict[str, float]] = {}
    for ci in uniq_clusters:
        mean_pred = traj_preds[clusters == ci].mean(axis=0)
        passed = np.where(mean_pred > cfg.save_p_higher)[0]
        cluster_preds[int(ci)] = {
            f"{ACTOR_ID_PREFIX}{classes[i]}": round(float(mean_pred[i]), 5)
            for i in passed
        }

    records.write_predictions(predictions_path, movie_id, cluster_preds)
    report.set("n_classes", int(n_classes))
    report.set("n_train", int(len(x)))
    report.set("n_queries", int(len(queries)))
    report.set("n_clusters", int(len(uniq_clusters)))
    report.set("n_predictions",
               int(sum(len(v) for v in cluster_preds.values())))
    report.write(data_dir)
    print(f"Wrote predictions: {predictions_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--path", type=str, default=".",
                        help="movie data directory (glob)")
    parser.add_argument("--actors-dir", type=str, default=".",
                        help="directory containing actor-images.zip")
    args = parser.parse_args(argv)

    cfg = ClassifyConfig()
    embeddings, _ = read_actor_embeddings(
        os.path.join(args.actors_dir, "actor-images.zip"), cfg.emb_name)

    for data_dir in glob.glob(args.path):
        data_dir = data_dir.rstrip("/")
        print(f"Predicting for {data_dir} with k={cfg.k} "
              f"min_samples={cfg.min_samples}")
        x, y = build_training_set(embeddings, cfg.min_samples)
        run_classify(data_dir, x, y, cfg, args.device)
        break  # the reference processes only the first matching dir


if __name__ == "__main__":
    main()
