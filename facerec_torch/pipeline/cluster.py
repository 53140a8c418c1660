"""Trajectory clustering stage.

Port of ``facerec_tpu/pipeline/cluster.py``: mean embedding per
trajectory, complete-linkage clustering into ``N // size`` clusters,
recursive split of clusters above ``max_size`` with the split-and-merge
size repair, then relabeling with the largest clusters first.  The
O(N²) distance work runs on the device (:mod:`facerec_torch.ops.linkage`);
the label bookkeeping is host numpy.  ``clusters.json`` is
byte-identical to the JAX package's for the same merged directory.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import List, Tuple

import numpy as np

from facerec_torch.config import ClusterConfig
from facerec_torch.contract import records
from facerec_torch.contract.jsonio import read_jsonl
from facerec_torch.ops.linkage import cluster_vectors
from facerec_torch.runtime.device import resolve_device, use_full_float32
from facerec_torch.runtime.metrics import StageReport


def split_and_merge(clusters: np.ndarray, min_size: int,
                    max_size: int) -> np.ndarray:
    """Repair cluster sizes into [min_size, max_size] (best effort),
    with the reference's quirks: big clusters split into equal chunks
    in index order; consecutive too-small clusters bundled greedily
    (the trailing one may stay small)."""
    new = np.zeros(clusters.size, np.int32)
    next_id = 0
    ids, counts = np.unique(clusters, return_counts=True)
    for ci, n in zip(ids, counts):
        idx = np.where(clusters == ci)[0]
        if n > max_size:
            n_splits = (n + max_size - 1) // max_size
            chunk = (n + n_splits - 1) // n_splits
            for i in range(n_splits):
                new[idx[i * chunk:(i + 1) * chunk]] = next_id
                next_id += 1
        else:
            new[idx] = next_id
            next_id += 1

    ids, counts = np.unique(new, return_counts=True)
    small = np.where(counts < min_size)[0]
    small_ids = ids[small]
    small_counts = counts[small]
    prev = 0
    for upper in range(1, small.size):
        if (small_counts[prev:upper].sum() >= min_size
                or upper == small.size - 1):
            sel = np.isin(new, small_ids[prev:upper])
            new[sel] = small_ids[prev]
            prev = upper
    return new


def relabel(clusters: np.ndarray) -> np.ndarray:
    """Labels → 0..k-1 by ascending original label."""
    _, inv = np.unique(clusters, return_inverse=True)
    return inv.astype(np.int32)


def cluster_trajectories(embeddings: np.ndarray, size: int, min_size: int,
                         max_size: int, device=None) -> np.ndarray:
    """The full clustering recipe; linkage on ``device``."""
    dev = resolve_device(device)
    n = len(embeddings)
    # N // size unclamped: t=0 means every trajectory its own cluster,
    # exactly as scipy's fcluster handles it
    clusters = cluster_vectors(embeddings, n // size, dev).astype(np.int32)

    ids, counts = np.unique(clusters, return_counts=True)
    for ci, cnt in zip(ids, counts):
        if cnt > max_size:
            n_splits = (cnt + max_size - 1) // max_size
            idx = np.where(clusters == ci)[0]
            sub = cluster_vectors(embeddings[idx], n_splits, dev)
            sub = split_and_merge(sub, min_size, max_size)
            clusters[idx] = clusters.max() + 1 + sub

    clusters = relabel(clusters)
    ids, counts = np.unique(clusters, return_counts=True)
    # biggest cluster becomes 0, and so on (stable for ties by label)
    order = np.argsort(np.argsort(-counts))[ids]
    return order[clusters]


def read_trajectory_embeddings(data_dir: str,
                               emb_name: str) -> Tuple[List[dict], np.ndarray]:
    """Mean embedding per trajectory."""
    vector_map = records.load_feature_map(
        os.path.join(data_dir, "features.jsonl"))
    trajectories, means = [], []
    for traj in read_jsonl(os.path.join(data_dir, "trajectories.jsonl")):
        vectors = records.trajectory_vectors(traj, vector_map, emb_name)
        trajectories.append(traj)
        means.append(vectors.mean(axis=0))
    return trajectories, np.array(means, np.float32)


def run_cluster(data_dir: str, cfg: ClusterConfig, device=None) -> np.ndarray:
    """Cluster a merged movie dir into ``clusters.json``, the linkage on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    use_full_float32()
    report = StageReport("cluster", dev)
    movie_id = int(os.path.basename(data_dir).split("-")[0])
    _, embeddings = read_trajectory_embeddings(data_dir, cfg.emb_name)
    clusters = cluster_trajectories(embeddings, cfg.size, cfg.min_size,
                                    cfg.max_size, dev)
    records.write_clusters(os.path.join(data_dir, "clusters.json"),
                           clusters, movie_id)
    report.set("n_trajectories", int(len(clusters)))
    report.set("n_clusters", int(len(np.unique(clusters)))
               if len(clusters) else 0)
    report.write(data_dir)
    return clusters


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--size", type=int, default=18,
                        help="preferred cluster size (trajectory count)")
    parser.add_argument("--min-size", type=int, default=12)
    parser.add_argument("--max-size", type=int, default=24)
    parser.add_argument("--path", type=str, default=".",
                        help="movie data directory (glob)")
    args = parser.parse_args(argv)

    for data_dir in glob.glob(args.path):
        data_dir = data_dir.rstrip("/")
        print(f"Clustering: {data_dir}")
        cfg = ClusterConfig(size=args.size, min_size=args.min_size,
                            max_size=args.max_size)
        clusters = run_cluster(data_dir, cfg, args.device)
        print(f"Number of clusters: {len(np.unique(clusters))}")


if __name__ == "__main__":
    main()
