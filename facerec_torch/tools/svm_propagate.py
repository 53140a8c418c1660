"""Offline SVM label propagation over hand-labeled clusters.

Port of ``facerec_tpu/tools/svm_propagate.py``; the SVM trains on the
device (``--device``, the card unless ``cpu``).

Behavioural rebuild of reference facerec/classify.py: maps
hand-labeled cluster ids (``ts-clusters-1.tsv``: cluster → actor name,
'?'/'x' skipped) through a cluster→tag file (``clusters_labels.txt``:
``LABEL [<cluster>] <tag>``), trains a linear SVM on the labeled
feature vectors (``features.dat``: whitespace floats + tag), scores
everything and emits ``**boxdata**`` lines with the top-1 label and a
top1−top2 margin score.
"""
from __future__ import annotations

import argparse
import re
from typing import Dict

import numpy as np

from facerec_torch.ops.svm import decision_function, train_linear_svm


def read_cluster_actors(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"(\d+)\s+(.+)", line)
            if not m:
                raise ValueError(f"bad line in {path}: {line!r}")
            if m.group(2) in ("?", "x"):
                continue
            out[m.group(1)] = m.group(2)
    return out


def read_tag_labels(path: str, cluster_actor: Dict[str, str],
                    actor_index: Dict[str, int]) -> Dict[str, int]:
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"LABEL\s+\[(\d+)\]\s+(.+)", line)
            if not m:
                raise ValueError(f"bad line in {path}: {line!r}")
            if m.group(1) in cluster_actor:
                out[m.group(2)] = actor_index[cluster_actor[m.group(1)]]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--clusters-tsv", default="ts-clusters-1.tsv")
    parser.add_argument("--labels-txt", default="clusters_labels.txt")
    parser.add_argument("--features-dat", default="features.dat")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    args = parser.parse_args(argv)

    cluster_actor = read_cluster_actors(args.clusters_tsv)
    actors = sorted(set(cluster_actor.values()))
    actor_index = {a: i for i, a in enumerate(actors)}
    tag_label = read_tag_labels(args.labels_txt, cluster_actor, actor_index)

    x_train, y_train, x_all, tags = [], [], [], []
    with open(args.features_dat) as f:
        for line in f:
            parts = line.strip().split(" ")
            tag = parts.pop()
            vec = [float(z) for z in parts]
            if tag in tag_label:
                x_train.append(vec)
                y_train.append(tag_label[tag])
            x_all.append(vec)
            tags.append(tag)

    w, b, _ = train_linear_svm(np.array(x_train, np.float32),
                               np.array(y_train), device=args.device)
    dec = decision_function(np.array(x_all, np.float32), w, b,
                            device=args.device)
    dec = dec / 2 + 0.5

    for i, row in enumerate(dec):
        order = np.argsort(-row)
        z1 = order[0]
        score = row[z1] - (row[order[1]] if len(row) > 1 else 0.0)
        m = re.match(r".*(\d{6}):(\d+)_(\d+)_(\d+)_(\d+)_(\d+)", tags[i])
        if not m:
            raise ValueError(f"unparsable tag {tags[i]!r}")
        frame = int(m.group(2))
        print("**boxdata**", m.group(1), frame, frame + 1, "mtcnn",
              "facenet", m.group(3), m.group(4), m.group(5), m.group(6),
              score, "face", actors[z1])


if __name__ == "__main__":
    main()
