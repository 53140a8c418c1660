"""Shard/block merge stage.

Port of ``facerec_tpu/pipeline/merge.py``, host code only: stitches
trajectories across shard (or frame-block) boundaries, unions scene
cuts, concatenates features, filters no-image and too-small
trajectories, and assigns global indices.  The files it writes are
byte-identical to the JAX package's for the same shard files.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Set, Tuple

import torch

from facerec_torch.config import MergeConfig
from facerec_torch.contract import records
from facerec_torch.contract.jsonio import write_jsonl_line
from facerec_torch.contract.naming import parse_shard_file_name
from facerec_torch.ops.boxes import iou_single
from facerec_torch.runtime.metrics import StageReport


def has_image(traj: dict, images_map) -> bool:
    """≥1 bbox of the trajectory has a saved face image."""
    for frame, box in enumerate(traj["bbs"], start=traj["start"]):
        if frame in images_map and tuple(box) in images_map[frame]:
            return True
    return False


def big_enough(traj: dict, min_face_size: int) -> bool:
    """≥1 bbox with min(w, h) >= min_face_size."""
    for x1, y1, x2, y2 in traj["bbs"]:
        if min(x2 - x1, y2 - y1) >= min_face_size:
            return True
    return False


def stitch_within_shard(trajectories: List[dict], scene_cuts: Set[int],
                        iou_threshold: float) -> Tuple[List[dict], int]:
    """Greedy adjacency+IoU merging inside one shard: repeatedly extend
    each trajectory with the best-IoU trajectory starting exactly at its
    end, unless the seam is a scene cut."""
    trajectories = sorted(trajectories, key=lambda t: t["start"])
    consumed = set()
    merged = []
    for i, t1 in enumerate(trajectories):
        if i in consumed:
            continue
        while True:
            end = t1["start"] + t1["len"]
            best_iou, best_j = iou_threshold, None
            for j in range(i + 1, len(trajectories)):
                t2 = trajectories[j]
                if (t2["start"] != end or j in consumed
                        or end in scene_cuts):
                    continue
                value = iou_single(t1["bbs"][-1], t2["bbs"][0])
                if value > best_iou:
                    best_iou, best_j = value, j
            if best_j is None:
                break
            t2 = trajectories[best_j]
            t1["bbs"] = t1["bbs"] + t2["bbs"]
            t1["detected"] = t1["detected"] + t2["detected"]
            t1["len"] = len(t1["bbs"])
            consumed.add(best_j)
        merged.append(t1)
    return merged, len(trajectories) - len(merged)


class _Writer:
    """Streaming trajectory writer with the filters and the global
    index."""

    def __init__(self, fp, images_map, min_face_size: int, movie_id: int):
        self.fp = fp
        self.images_map = images_map
        self.min_face_size = min_face_size
        self.movie_id = movie_id
        self.n_saved = 0
        self.n_removed = 0

    def save(self, trajectories: List[dict]):
        for traj in trajectories:
            if (has_image(traj, self.images_map)
                    and big_enough(traj, self.min_face_size)):
                traj["index"] = self.n_saved
                traj["movie_id"] = self.movie_id
                write_jsonl_line(self.fp, traj)
                self.n_saved += 1
            else:
                self.n_removed += 1


def _shard_files(directory: str, kind: str) -> List[dict]:
    out = []
    for name in os.listdir(directory):
        parsed = parse_shard_file_name(name)
        if parsed and parsed[0] == kind:
            out.append({"s": parsed[2], "e": parsed[3],
                        "path": os.path.join(directory, name)})
    return sorted(out, key=lambda d: d["s"])


def run_merge(data_dir: str, movie_id: int, cfg: MergeConfig) -> dict:
    """Merge all shards of a movie dir; returns counters."""
    report = StageReport("merge", torch.device("cpu"))
    trajectories_dir = os.path.join(data_dir, "trajectories")
    scene_changes_dir = os.path.join(data_dir, "scene_changes")
    features_dir = os.path.join(data_dir, "features")
    images_dir = os.path.join(data_dir, "images")
    for d in (trajectories_dir, scene_changes_dir, features_dir, images_dir):
        if not os.path.isdir(d):
            raise FileNotFoundError(f"Didn't find: {d}")

    traj_files = _shard_files(trajectories_dir, "trajectories")

    # union of the shards' scene cuts
    scene_cuts: Set[int] = set()
    for tf in traj_files:
        name = f"scene_changes_{movie_id}_{tf['s']}-{tf['e']}.json"
        path = os.path.join(scene_changes_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                scene_cuts |= set(json.load(f)["frame_indices"])

    # features concatenated in start order
    with open(os.path.join(data_dir, "features.jsonl"), "w") as out:
        for ff in _shard_files(features_dir, "features"):
            with open(ff["path"]) as f:
                out.write(f.read())

    images_map = records.load_images_map(images_dir, features_dir)

    n_merges = 0
    n_read = 0
    pending: List[dict] = []

    with open(os.path.join(data_dir, "trajectories.jsonl"), "w") as out:
        writer = _Writer(out, images_map, cfg.min_face_size, movie_id)
        for tf in traj_files:
            shard_trajs = records.read_trajectories(tf["path"])
            stitched, n = stitch_within_shard(shard_trajs, scene_cuts,
                                              cfg.iou_threshold)
            n_read += len(stitched)
            n_merges += n

            mergables = [t for t in stitched
                         if t["start"] < tf["s"] + cfg.overlap]
            others = [t for t in stitched
                      if t["start"] >= tf["s"] + cfg.overlap]

            expired = [t for t in pending
                       if t["start"] + t["len"] < tf["s"]]
            pending = [t for t in pending
                       if t["start"] + t["len"] >= tf["s"]]
            writer.save(expired)

            # Cross-shard stitch: an earlier trajectory that overlaps the
            # new one's start, best IoU at the overlapped frame, then
            # splice.  By default equal starts merge too (the overlap
            # halo would otherwise keep duplicate tracks);
            # ``strict_start`` keeps the reference's stricter gates.
            for t1 in mergables:
                best_iou, best_t = cfg.iou_threshold, None
                at_cut = t1["start"] in scene_cuts
                for t2 in pending:
                    if t2["start"] + t2["len"] <= t1["start"]:
                        continue
                    if cfg.strict_start:
                        if at_cut or t2["start"] >= t1["start"]:
                            continue
                    elif t2["start"] > t1["start"]:
                        continue
                    # never bridge an earlier track across a scene cut;
                    # equal-start dedup is safe
                    elif at_cut and t2["start"] < t1["start"]:
                        continue
                    k = t1["start"] - t2["start"]
                    value = iou_single(t2["bbs"][k], t1["bbs"][0])
                    if value > best_iou:
                        best_iou, best_t = value, t2
                if best_t is not None:
                    n_merges += 1
                    cut = t1["start"] - best_t["start"]
                    best_t["bbs"] = best_t["bbs"][:cut] + t1["bbs"]
                    best_t["detected"] = (best_t["detected"][:cut]
                                          + t1["detected"])
                    best_t["len"] = len(best_t["bbs"])
                else:
                    others.append(t1)
            pending += others

        writer.save(pending)

    records.write_merged_scene_changes(
        os.path.join(data_dir, "scene_changes.json"), scene_cuts, movie_id)

    counters = {"merges": n_merges, "read": n_read,
                "saved": writer.n_saved, "removed": writer.n_removed}
    for name, value in counters.items():
        report.set(name, value)
    report.set("scene_cuts", len(scene_cuts))
    report.set("shards", len(traj_files))
    report.write(data_dir)
    print(f"Total merges: {counters['merges']}.")
    print(f"Total removed if they had no images or had too small faces: "
          f"{counters['removed']}.")
    print(f"Done! Read {counters['read']} trajectories and saved "
          f"{counters['saved']}.")
    return counters


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--iou-threshold", type=float, default=0.5)
    parser.add_argument("--overlap", type=int, default=5,
                        help="must match max-trajectory-age at extraction")
    parser.add_argument("--min-face-size", type=int, default=50)
    parser.add_argument("--strict-start", action="store_true",
                        help="reproduce the reference's cross-shard "
                             "merge gates exactly (keeps halo-duplicate "
                             "tracks; see MergeConfig.strict_start)")
    parser.add_argument("--path", type=str, default=".",
                        help="movie data directory (glob)")
    args = parser.parse_args(argv)

    for data_dir in glob.glob(args.path):
        data_dir = data_dir.rstrip("/")
        print(f"Merging shards in: {data_dir}")
        movie_id = int(os.path.basename(data_dir).split("-")[0])
        cfg = MergeConfig(iou_threshold=args.iou_threshold,
                          overlap=args.overlap,
                          min_face_size=args.min_face_size,
                          strict_start=args.strict_start)
        run_merge(data_dir, movie_id, cfg)
        print()


if __name__ == "__main__":
    main()
