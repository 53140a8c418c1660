"""Record schemas and readers/writers for every contract file.

Key orders and formatting quirks are load-bearing: the downstream
video-labeler parses these files, and our golden tests diff bytes.
See SURVEY.md §2.2 for the schema inventory with reference citations.
"""
from __future__ import annotations

from typing import Dict, IO, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from facerec_torch.contract.jsonio import (
    dump_compact,
    dump_default,
    read_json,
    read_jsonl,
    write_jsonl_line,
)

Box = Tuple[int, int, int, int]

KEYPOINT_NAMES = ("left_eye", "right_eye", "nose", "mouth_left", "mouth_right")


# ---------------------------------------------------------------------------
# trajectories*.jsonl

def trajectory_record(
    start: int,
    bbs: Sequence[Sequence[int]],
    detected: Sequence[bool],
    width: int,
    height: int,
) -> dict:
    """Shard-level trajectory record (extract.py:68-76).  ``index`` and
    ``movie_id`` are appended by the merge stage, preserving key order."""
    return {
        "start": int(start),
        "len": len(bbs),
        "bbs": [[int(c) for c in b] for b in bbs],
        "detected": [bool(d) for d in detected],
        "w": int(width),
        "h": int(height),
        "object_type": "face",
    }


def write_trajectory(fp: IO[str], record: dict) -> None:
    write_jsonl_line(fp, record)


def read_trajectories(path: str) -> List[dict]:
    return list(read_jsonl(path))


# ---------------------------------------------------------------------------
# features*.jsonl

def feature_record(
    frame: int,
    tag: str,
    embeddings: Dict[str, Sequence[float]],
    box: Sequence[int],
    keypoints: Dict[str, Tuple[int, int]],
    width: int,
    height: int,
) -> dict:
    """Per-face feature record (extract.py:186-195)."""
    return {
        "frame": int(frame),
        "tag": tag,
        "embeddings": {k: list(v) for k, v in embeddings.items()},
        "box": [int(c) for c in box],
        "keypoints": {k: list(v) for k, v in keypoints.items()},
        "w": int(width),
        "h": int(height),
    }


def write_feature(fp: IO[str], record: dict) -> None:
    write_jsonl_line(fp, record)


# ---------------------------------------------------------------------------
# scene_changes*.json

def write_shard_scene_changes(path: str, frame_indices: Sequence[int]) -> None:
    """Per-shard scene-change file: bare ``frame_indices``, no trailing
    newline (extract.py:361-363)."""
    with open(path, "w") as f:
        dump_compact({"frame_indices": [int(i) for i in frame_indices]}, f,
                     newline=False)


def write_merged_scene_changes(path: str, frame_indices: Iterable[int],
                               movie_id: int) -> None:
    """Merged scene-change file: sorted indices + movie_id + newline
    (merge_shards.py:74-79)."""
    obj = {"frame_indices": sorted(int(i) for i in frame_indices),
           "movie_id": int(movie_id)}
    with open(path, "w") as f:
        dump_compact(obj, f, newline=True)


def read_scene_changes(path: str) -> List[int]:
    return read_json(path)["frame_indices"]


# ---------------------------------------------------------------------------
# clusters.json

def write_clusters(path: str, clusters: Sequence[int], movie_id: int) -> None:
    """(cluster.py:216-223)"""
    obj = {"clusters": [int(c) for c in clusters], "movie_id": int(movie_id)}
    with open(path, "w") as f:
        dump_compact(obj, f, newline=True)


def read_clusters(path: str) -> List[int]:
    return read_json(path)["clusters"]


# ---------------------------------------------------------------------------
# predictions.json

def write_predictions(path: str, movie_id: int,
                      predictions: Dict[int, Dict[str, float]]) -> None:
    """Full predictions file.  NB: default json formatting, no trailing
    newline (classify_knn.py:251-256)."""
    obj = {"movie_id": int(movie_id),
           "predictions": {int(k): v for k, v in predictions.items()}}
    with open(path, "w") as f:
        dump_default(obj, f)


def write_empty_predictions(path: str, cluster_ids: Iterable[int]) -> None:
    """Too-few-classes fallback: a bare ``{cluster: {}}`` map without the
    movie_id/predictions wrapper (classify_knn.py:204-208)."""
    with open(path, "w") as f:
        dump_default({int(ci): {} for ci in cluster_ids}, f)


# ---------------------------------------------------------------------------
# Feature lookup maps (utils/utils.py:90-120 equivalents)

def load_feature_map(features_path: str) -> Dict[int, Dict[Box, dict]]:
    """features.jsonl → ``{frame: {box_tuple: {emb_name: [floats]}}}``
    (utils/utils.py:90-105)."""
    vector_map: Dict[int, Dict[Box, dict]] = {}
    for obj in read_jsonl(features_path):
        frame, box = obj["frame"], tuple(obj["box"])
        vector_map.setdefault(frame, {})[box] = obj["embeddings"]
    return vector_map


def trajectory_vectors(trajectory: dict, vector_map, emb_name: str) -> np.ndarray:
    """All stored embedding vectors along a trajectory, walking ``bbs`` with
    the ``start`` frame offset (utils/utils.py:107-120)."""
    vectors = []
    for frame, bbs in enumerate(trajectory["bbs"], start=trajectory["start"]):
        per_box = vector_map.get(frame)
        if per_box is not None:
            emb = per_box.get(tuple(bbs))
            if emb is not None:
                vectors.append(np.asarray(emb[emb_name], dtype=np.float32))
    return np.array(vectors, dtype=np.float32)


def load_images_map(images_dir: str,
                    features_dir: Optional[str] = None) -> Dict[int, Set[Box]]:
    """Map frame → set of boxes that have a saved face image, with a
    features-file fallback when no images were stored
    (utils/utils.py:26-60)."""
    import os

    image_map: Dict[int, Set[Box]] = {}
    if os.path.isdir(images_dir):
        for name in os.listdir(images_dir):
            stem, ext = os.path.splitext(name)
            if ext != ".jpeg":
                continue
            _, frame_str, box_str = stem.split(":")
            box = tuple(int(p) for p in box_str.split("_"))
            image_map.setdefault(int(frame_str), set()).add(box)

    if not image_map and features_dir is not None and os.path.isdir(features_dir):
        for name in os.listdir(features_dir):
            if not name.endswith(".jsonl"):
                continue
            for obj in read_jsonl(os.path.join(features_dir, name)):
                image_map.setdefault(obj["frame"], set()).add(tuple(obj["box"]))

    return image_map
