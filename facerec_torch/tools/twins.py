"""Twin checker (QA): flag frames where one predicted actor appears in

Port of ``facerec_tpu/tools/twins.py`` (host code).
more than one box simultaneously.

Behavioural rebuild of reference facerec/check_twins.py:76-109.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Tuple

from facerec_torch.contract.jsonio import read_json, read_jsonl
from facerec_torch.tools.subtitles import (load_actor_names, parse_video_metadata,
                                         timestamp, top_actor)


def find_twins(data_dir: str, names: Dict[int, str]
               ) -> List[Tuple[int, str, int]]:
    """(frame, actor_name, count) rows where count > 1."""
    clusters = read_json(os.path.join(data_dir, "clusters.json"))["clusters"]
    preds = read_json(os.path.join(data_dir,
                                   "predictions.json"))["predictions"]

    per_frame: Dict[int, Dict[str, int]] = {}
    for i, traj in enumerate(read_jsonl(
            os.path.join(data_dir, "trajectories.jsonl"))):
        pred = preds.get(str(clusters[i]), {})
        if not pred:
            continue
        actor_id = top_actor(pred)
        name = names.get(actor_id, str(actor_id))
        frame = traj["start"]
        for _ in traj["bbs"]:
            per_frame.setdefault(frame, {}).setdefault(name, 0)
            per_frame[frame][name] += 1
            frame += 1

    out = []
    for frame in sorted(per_frame):
        for name, count in per_frame[frame].items():
            if count != 1:
                out.append((frame, name, count))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Report frames where one actor appears in >1 box")
    parser.add_argument("--path", type=str, required=True)
    parser.add_argument("--metadata", type=str, default=None,
                        help="ffprobe metadata JSON (for timestamps)")
    parser.add_argument("--actors-csv", type=str, default="actors.csv")
    args = parser.parse_args(argv)

    fps = 25.0
    if args.metadata:
        _, _, _, fps = parse_video_metadata(json.load(open(args.metadata)))
    names = load_actor_names(args.actors_csv)

    for frame, name, count in find_twins(args.path.rstrip("/"), names):
        print(timestamp(frame, fps), frame, name, count)


if __name__ == "__main__":
    main()
