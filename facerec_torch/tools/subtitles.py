"""ASS subtitle rendering of face boxes + predicted actor names.

Port of ``facerec_tpu/tools/subtitles.py`` (host code).

Behavioural rebuild of reference facerec/make_subtitles.py: reads
the movie data dir (trajectories/clusters/predictions), an actors.csv
(id,name) and ffprobe-style metadata JSON for SAR/fps, and emits an
.ass file drawing each box with the top-predicted actor per trajectory.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import re
from typing import Dict, Tuple

from facerec_torch.contract.jsonio import read_json, read_jsonl

ASS_HEADER = """[Script Info]
Title:
Original Script:
Original Translation:
Original Editing:
Original Timing:
Original Script Checking:
ScriptType: v4.00+
Collisions: Normal
PlayResX: {width}
PlayResY: {height}
PlayDepth: 0
Timer: 100,0000
[V4+ Styles]
Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding
Style: objectbox,DejaVu Sans,80,&HFF000000,&H00B4FCFC,&H00000000,&H00000000,0,0,0,0,100,100,0.00,0.00,1,2.50,0.00,7,50,50,50,0
Style: objecttxt,DejaVu Sans,40,&H000000FF,&H00B4FCFC,&H00FF0000,&H00FF0000,0,0,0,0,100,100,0.00,0.00,1,2.50,0.00,7,50,50,50,0
Style: top-left,DejaVu Sans,25,&H00FFFFFF,&H00B4FCFC,&H00000000,&H00000000,0,0,0,0,100,100,0.00,0.00,1,2.50,0.00,7,50,50,50,0

[Events]
Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text"""


def parse_video_metadata(meta: dict) -> Tuple[int, int, float, float]:
    """(display_w, display_h, sar, fps) from ffprobe-style stream JSON
    (make_subtitles.py:42-69)."""
    for s in meta.get("streams", []):
        if s.get("codec_type") != "video":
            continue
        sw, sh = int(s["width"]), int(s["height"])
        a = s.get("sample_aspect_ratio")
        if a is None:
            sar = 1.0
        elif m := re.match(r"(\d+):(\d+)", str(a)):
            sar = int(m.group(1)) / int(m.group(2))
        else:
            sar = float(a)
        f = s["avg_frame_rate"]
        if m := re.match(r"(\d+)/(\d+)", str(f)):
            fps = int(m.group(1)) / int(m.group(2))
        else:
            fps = float(f)
        return int(sar * sw), sh, sar, fps
    raise ValueError("no video stream in metadata")


def timestamp(frame: int, fps: float) -> str:
    """h:m:s.cc timestamp (make_subtitles.py:106-112)."""
    s = frame / fps
    h = int(math.floor(s / 3600))
    s -= 3600 * h
    m = int(math.floor(s / 60))
    s -= 60 * m
    return "{}:{}:{:.2f}".format(h, m, s)


def load_actor_names(actors_csv: str) -> Dict[int, str]:
    out = {}
    with open(actors_csv) as f:
        for row in csv.DictReader(f):
            out[int(row["id"])] = row["name"]
    return out


def top_actor(pred: Dict[str, float]) -> int:
    """Highest-probability actor id from a prediction dict."""
    best = sorted((v, k) for k, v in pred.items())[-1][1]
    return int(best.split("_")[-1])


def write_subtitles(data_dir: str, out_path: str, actors_csv: str,
                    metadata: dict) -> int:
    dw, dh, sar, fps = parse_video_metadata(metadata)
    clusters = read_json(os.path.join(data_dir, "clusters.json"))["clusters"]
    preds = read_json(os.path.join(data_dir,
                                   "predictions.json"))["predictions"]
    names = load_actor_names(actors_csv)

    n_events = 0
    with open(out_path, "w") as fp:
        print(ASS_HEADER.format(width=dw, height=dh), file=fp)
        m = 1.0 / sar
        for i, traj in enumerate(read_jsonl(
                os.path.join(data_dir, "trajectories.jsonl"))):
            clu = str(clusters[i])
            pred = preds.get(clu, {})
            if not pred:
                continue
            actor_id = top_actor(pred)
            label = f"{names.get(actor_id, actor_id)}/{clu}"
            frame = traj["start"]
            for b in traj["bbs"]:
                s, e = timestamp(frame, fps), timestamp(frame + 1, fps)
                print(r"Dialogue: 1,{},{},objectbox,foo,000,000,000,,"
                      r"{{\pos(0,0)\p1\3c&H0000FF&}}m {} {} l {} {} {} {} "
                      r"{} {}{{\p0\r}}".format(
                          s, e, m * b[0], m * b[1], m * b[2], m * b[1],
                          m * b[2], m * b[3], m * b[0], m * b[3]), file=fp)
                print(r"Dialogue: 1,{},{},objecttxt,foo,000,000,000,,"
                      r"{{\pos({},{})\an5\1c&HFFFFFF&}}{}{{\r}}".format(
                          s, e, (b[0] + b[2]) / 2, b[1], label), file=fp)
                frame += 1
                n_events += 2
    return n_events


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="Generate ASS subtitles of face recognitions")
    parser.add_argument("--path", type=str, required=True,
                        help="movie data directory like /12345-data")
    parser.add_argument("--metadata", type=str, required=True,
                        help="ffprobe metadata JSON for the film")
    parser.add_argument("--actors-csv", type=str, default="actors.csv")
    parser.add_argument("--out", type=str, default=None,
                        help="output .ass (default: from metadata filename)")
    args = parser.parse_args(argv)

    meta = json.load(open(args.metadata))
    out = args.out
    if out is None:
        fname = meta["format"]["filename"].split("/")[-1]
        out = ".".join(fname.split(".")[:-1]) + ".ass"
    print(f"Writing subtitles in {out}")
    n = write_subtitles(args.path.rstrip("/"), out, args.actors_csv, meta)
    print(f"Wrote {n} events")


if __name__ == "__main__":
    main()
