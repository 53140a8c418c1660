"""Boxdata dumper for the external viewer.

Port of ``facerec_tpu/tools/boxdata.py`` (host code).

Behavioural rebuild of reference facerec/dump_boxdata.py: one
``**boxdata**`` line per frame of each trajectory, labeled
``<movie>_<cluster>``.
"""
from __future__ import annotations

import argparse
import os

from facerec_torch.contract.jsonio import read_json, read_jsonl


def dump_boxdata(data_dir: str, movie_label: str, out_fp) -> int:
    clusters = read_json(os.path.join(data_dir, "clusters.json"))["clusters"]
    n = 0
    for i, traj in enumerate(read_jsonl(
            os.path.join(data_dir, "trajectories.jsonl"))):
        name = f"{movie_label}_{clusters[i]}"
        frame = traj["start"]
        for b in traj["bbs"]:
            print(f"**boxdata** {movie_label} {frame} {frame + 1} "
                  f"retinaface facenet {b[0]} {b[1]} {b[2]} {b[3]} 1 face "
                  f"{name}", file=out_fp)
            frame += 1
            n += 1
    return n


def main(argv=None):
    import sys

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--path", type=str, required=True,
                        help="movie data directory like out/332020-data")
    args = parser.parse_args(argv)

    data_dir = args.path.rstrip("/")
    movie = os.path.basename(data_dir).split("-")[0]
    # zero-padded 7-digit label (dump_boxdata.py:12)
    label = "{:03d}".format(int(movie[:-4])) + movie[-4:] \
        if len(movie) > 4 else movie
    dump_boxdata(data_dir, label, sys.stdout)


if __name__ == "__main__":
    main()
