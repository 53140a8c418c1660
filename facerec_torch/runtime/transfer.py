"""One device→host copy for many tensors.

Port of ``facerec_tpu/runtime/transfer.py``.  A tuple of tensors (nested
tuples and NamedTuples too) packs into one flat uint8 buffer on its
device, each leaf's bytes as they lie in memory (bools are one byte
each); :func:`tree_spec` records each leaf's shape and dtype, and
:func:`unpack_tree` slices a host copy of the buffer back into numpy
views.  A group of blocks' payloads and deferred embeddings thus comes
back in one copy.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch


def _flatten(tree) -> Tuple[list, Callable[[list], object]]:
    """(leaves, rebuild) of a tensor or a (Named)tuple of them."""
    if not isinstance(tree, tuple):
        return [tree], lambda leaves: leaves[0]
    parts = [_flatten(t) for t in tree]
    counts = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, off = [], 0
        for (_, sub), n in zip(parts, counts):
            out.append(sub(leaves[off:off + n]))
            off += n
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else tuple(out)

    return [x for p in parts for x in p[0]], rebuild


def pack_tree(tree) -> torch.Tensor:
    """Device side: the leaves' bytes concatenated into one (N,) uint8
    tensor on their device."""
    leaves, _ = _flatten(tree)
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    if not parts:
        return torch.zeros(0, dtype=torch.uint8)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def tree_spec(tree) -> Tuple[Callable[[list], object],
                             List[Tuple[tuple, np.dtype]]]:
    """(rebuild, [(shape, numpy dtype)]) of a tree's leaves."""
    leaves, rebuild = _flatten(tree)
    dtypes = [np.dtype(torch.empty(0, dtype=t.dtype).numpy().dtype)
              for t in leaves]
    return rebuild, [(tuple(t.shape), d) for t, d in zip(leaves, dtypes)]


def unpack_tree(buf: np.ndarray, rebuild, specs):
    """Host inverse of :func:`pack_tree`: numpy views into ``buf``."""
    out, off = [], 0
    buf = np.asarray(buf)
    for shape, dtype in specs:
        nb = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out.append(buf[off:off + nb].view(dtype).reshape(shape))
        off += nb
    if off != buf.size:
        raise ValueError(f"buffer holds {buf.size} bytes, spec {off}")
    return rebuild(out)
