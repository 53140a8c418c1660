"""A cell's inputs: its configuration and traffic files, the painted
pool of frames, and the in-memory film that loops over the pool.

The traffic file gives faces a frame, the identities they are drawn
from, the range of shot lengths and of face widths and aspects.  Every
seed gets the same shots in its own order: the same lengths (evenly
spread over the range, their sum the pool's length), each with the same
face sizes (widths and aspects evenly spread over their ranges, a shot
taking every k-th of them by its length's rank), so a seed changes the
order of the work but not its amount; its backgrounds, identities,
positions and paths are its own.  Film
frame ``i`` is pool frame ``i mod len(pool)``, so the reader's blocks
are views of the pool and each pool seam is a hard cut.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import List

import numpy as np

from portbench import painter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# the movie name the contract files carry (its digits are the movie id)
FILM_NAME = "900001-Bench_Film.mp4"


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(workload: str):
    """(cell, config, traffic, limits) of a workload named in
    BENCHMARK.json."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    cell = cells[workload]
    return (cell, load_json("configs", cell["config"]),
            load_json("traffic", cell["traffic"]),
            load_json("limits", workload))


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def detector_weights(config: dict) -> str:
    """The detector checkpoint's path, after checking its digest."""
    det = config["detector"]
    path = os.path.join(REPO, det["weights"])
    got = sha256(path)
    if got != det["sha256"]:
        raise SystemExit(f"{det['weights']}: sha256 {got}, the "
                         f"configuration says {det['sha256']}")
    return path


def shot_lengths(n: int, lo: int, hi: int, mean: float) -> List[int]:
    """Shot lengths that fill ``n`` frames: about n / mean of them,
    evenly spread inside [lo, hi], rounded so that they sum to n."""
    k = max(1, round(n / mean))
    avg = n / k
    half = min((hi - lo) / 2, avg - lo, hi - avg)
    raw = avg + half * np.linspace(-1.0, 1.0, k) if k > 1 else np.array([n])
    lengths = np.floor(raw).astype(int)
    lengths[-1] += n - int(lengths.sum())
    return lengths.tolist()


def seed_of(seed: int, salt: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 63), salt])


def face_sizes(k: int, traffic: dict) -> List[List[List[float]]]:
    """Per shot of rank j (of k), its faces' [width, aspect]: shot j
    takes every k-th of the evenly spread widths and aspects."""
    n = k * traffic["faces"]
    widths = np.linspace(*traffic["face_width"], n)
    aspects = np.linspace(*traffic["face_aspect"], n)[::-1]
    return [[[float(widths[j + k * i]), float(aspects[j + k * i])]
             for i in range(traffic["faces"])] for j in range(k)]


def plan(config: dict, traffic: dict, seed: int):
    """(pool frames, cut positions inside the pool, each shot's face
    sizes in pool order, painter seed)."""
    n = config["pool_blocks"] * config["extract"]["block_frames"]
    lengths = shot_lengths(n, traffic["shot_min"], traffic["shot_max"],
                           traffic["shot_mean"])
    sizes = face_sizes(len(lengths), traffic)
    rng = np.random.default_rng(seed_of(seed, 1))
    order = rng.permutation(len(lengths)).tolist()
    cuts = np.cumsum([lengths[i] for i in order])[:-1].tolist()
    paint_seed = int(np.random.default_rng(seed_of(seed, 2)).integers(
        0, 1 << 62))
    return n, cuts, [sizes[i] for i in order], paint_seed


def paint_pool(config: dict, traffic: dict, seed: int):
    """(pool (P, H, W, 3) uint8, cuts)."""
    n, cuts, sizes, paint_seed = plan(config, traffic, seed)
    pool = painter.paint(n, config["display_width"],
                         config["display_height"], paint_seed, cuts,
                         traffic["faces"], traffic["identities"], sizes)
    return pool, cuts


class LoopedFrames:
    """(n_frames, H, W, 3) frames that loop over a pool: what the
    reader slices.  A slice inside one pass is a view of the pool."""

    def __init__(self, pool: np.ndarray, n_frames: int):
        self.pool = pool
        self.shape = (n_frames,) + pool.shape[1:]
        self.dtype = pool.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("LoopedFrames takes a slice")
        a, b, step = key.indices(len(self))
        if step != 1:
            raise ValueError("LoopedFrames slices take no step")
        p = len(self.pool)
        if b <= a:
            return self.pool[:0]
        if a // p == (b - 1) // p:
            return self.pool[a % p:a % p + (b - a)]
        return np.concatenate([self.pool[i % p][None] for i in range(a, b)])


class Film:
    """The in-memory film ``run_extract`` takes: ``path`` (its name),
    ``frames`` and ``fps``."""

    def __init__(self, pool: np.ndarray, n_frames: int, fps: float):
        self.path = FILM_NAME
        self.frames = LoopedFrames(pool, n_frames)
        self.fps = fps
