"""In-stage checkpoint/resume for long extract runs.

Port of ``facerec_tpu/runtime/checkpoint.py``.  Every N blocks the
device carries (scene + tracker state, pickled as numpy arrays), the
host carries (assembler, pending faces, pixel window, counters) and the
output files' byte offsets are written atomically; resume truncates the
shard files to the recorded offsets and continues with the next block,
so its output is byte-identical to an uninterrupted run.  Shard-level
completion markers make multi-shard runs idempotent.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch


def tensors_to_numpy(tree):
    """NamedTuples/tuples of tensors → the same structure of numpy
    arrays (host copies)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple):
        return type(tree)(*map(tensors_to_numpy, tree)) \
            if hasattr(tree, "_fields") \
            else tuple(map(tensors_to_numpy, tree))
    return tree


def numpy_to_tensors(tree, device: torch.device):
    """Inverse of :func:`tensors_to_numpy`, onto ``device``."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(numpy_to_tensors(t, device) for t in tree)) \
            if hasattr(tree, "_fields") \
            else tuple(numpy_to_tensors(t, device) for t in tree)
    return tree


def save_checkpoint(path: str, *, next_frame: int, scene_state,
                    tracker_state, assembler, pending, counters,
                    scene_changes, pixel_window, feat_offset: int,
                    traj_offset: int) -> None:
    payload = {
        "next_frame": next_frame,
        "scene_state": tensors_to_numpy(scene_state),
        "tracker_state": tensors_to_numpy(tracker_state),
        "assembler": assembler,
        "pending": pending,
        "counters": counters,
        "scene_changes": scene_changes,
        "pixel_window": pixel_window,
        "feat_offset": feat_offset,
        "traj_offset": traj_offset,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    """The checkpoint written by this program at ``path`` (None if
    absent or truncated).  Device state comes back as numpy arrays."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (EOFError, pickle.UnpicklingError, OSError):
        return None


def shard_done_marker(data_dir: str, kind: str, movie_id: int, beg: int,
                      end: int) -> str:
    return os.path.join(data_dir, f".{kind}_{movie_id}_{beg}-{end}.done")


def mark_shard_done(data_dir: str, kind: str, movie_id: int, beg: int,
                    end: int) -> None:
    with open(shard_done_marker(data_dir, kind, movie_id, beg, end),
              "w") as f:
        f.write("done\n")


def is_shard_done(data_dir: str, kind: str, movie_id: int, beg: int,
                  end: int) -> bool:
    return os.path.exists(
        shard_done_marker(data_dir, kind, movie_id, beg, end))
