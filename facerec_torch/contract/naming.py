"""File / directory naming conventions of the data contract.

Filename-encoded frame ranges are the reference's "wire format" between
shards (cf. reference facerec/merge_shards.py:155-162); we keep
them so outputs merge interchangeably with reference shards.
"""
from __future__ import annotations

import dataclasses
import os


def movie_id_from_filename(path: str) -> int:
    """Parse the movie id from a film filename.

    MoMaF style ``<id>-Name.mp4`` takes the leading digit group; otherwise
    (USSEE style) all digit groups are concatenated
    (cf. reference facerec/extract.py:237-246).
    """
    base, _ = os.path.splitext(os.path.basename(path))
    parts = base.split("-")
    if parts[0].isdigit():
        return int(parts[0])
    digits = "".join(p for p in parts if p.isdigit())
    if not digits:
        raise ValueError(f"No digits in film name <{path}>")
    return int(digits)


def shard_file_name(kind: str, movie_id: int, beg: int, end: int) -> str:
    """Per-shard file name, e.g. ``trajectories_987654_1000-2000.jsonl``."""
    ext = "json" if kind == "scene_changes" else "jsonl"
    return f"{kind}_{movie_id}_{beg}-{end}.{ext}"


def parse_shard_file_name(name: str):
    """Inverse of :func:`shard_file_name`: returns (kind, movie_id, beg, end)
    or ``None`` when the name doesn't match."""
    stem, _ = os.path.splitext(name)
    parts = stem.split("_")
    if len(parts) != 3:
        return None
    kind, movie_str, rng = parts
    try:
        beg_s, end_s = rng.split("-")
        return kind, int(movie_str), int(beg_s), int(end_s)
    except ValueError:
        return None


def box_tag(movie_id: int, frame: int, box) -> str:
    """Tag identifying one face box: ``<movie>:<frame>:x1_y1_x2_y2``
    (cf. reference facerec/extract.py:183,308)."""
    return f"{movie_id}:{frame}:{box[0]}_{box[1]}_{box[2]}_{box[3]}"


@dataclasses.dataclass(frozen=True)
class MovieDirs:
    """Directory layout under ``<out_path>/<movie_id>-data/``
    (cf. reference facerec/extract.py:248-255)."""

    root: str

    @classmethod
    def create(cls, out_path: str, movie_id: int) -> "MovieDirs":
        d = cls(os.path.join(out_path, f"{movie_id}-data"))
        for sub in (d.features, d.trajectories, d.scene_changes, d.images):
            os.makedirs(sub, exist_ok=True)
        return d

    @property
    def features(self) -> str:
        return os.path.join(self.root, "features")

    @property
    def trajectories(self) -> str:
        return os.path.join(self.root, "trajectories")

    @property
    def scene_changes(self) -> str:
        return os.path.join(self.root, "scene_changes")

    @property
    def images(self) -> str:
        return os.path.join(self.root, "images")

    # Merged outputs live at the movie-dir root
    @property
    def merged_features(self) -> str:
        return os.path.join(self.root, "features.jsonl")

    @property
    def merged_trajectories(self) -> str:
        return os.path.join(self.root, "trajectories.jsonl")

    @property
    def merged_scene_changes(self) -> str:
        return os.path.join(self.root, "scene_changes.json")

    @property
    def clusters(self) -> str:
        return os.path.join(self.root, "clusters.json")

    @property
    def predictions(self) -> str:
        return os.path.join(self.root, "predictions.json")
