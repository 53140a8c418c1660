"""The native writer of ``features*.jsonl`` lines (``csrc/featjson.cpp``).

A flush's embeddings are written in one call: the library formats every
value as ``json.dumps`` writes the float ``.tolist()`` makes of it, so
the lines are byte for byte those of
:func:`facerec_torch.contract.records.write_feature`.  The rest of each
line (frame, tag, box, keypoints, size) is still written by ``json``,
around an empty embeddings object that the library's text replaces.

The library is built with the host C++ compiler at first use
(:mod:`facerec_torch.ops._build`).  :class:`FeatureWriter` raises where
it must be native (on the card); elsewhere a machine that cannot build
it leaves the lines to ``json``.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from facerec_torch.contract.jsonio import dumps_compact

_EMPTY = '"embeddings":{}'
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def load_library() -> ctypes.CDLL:
    """The built library with its entry point's signature; raises
    ``RuntimeError`` or ``OSError`` where it cannot be built or
    loaded."""
    from facerec_torch.ops import _build

    lib = _build.load("featjson")
    lib.featjson_lines.argtypes = [_P, ctypes.c_int32, _I64, _I64, _P, _I64,
                                   _P, _P, _P, _P, _P, _I64, ctypes.c_int32]
    lib.featjson_lines.restype = _I64
    return lib


def line_parts(record: dict) -> tuple:
    """A feature record with empty ``embeddings`` as its line's text
    before and after the embeddings object."""
    line = dumps_compact(record)
    cut = line.index(_EMPTY) + len(_EMPTY) - 2
    return line[:cut], line[cut + 2:] + "\n"


def _offsets(parts: Sequence[str]) -> tuple:
    """(ASCII bytes of the joined parts, their n + 1 offsets)."""
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return "".join(parts).encode("ascii"), off


def format_lines(lib: ctypes.CDLL, values: np.ndarray, names: List[str],
                 dims: Sequence[int], heads: Sequence[str],
                 tails: Sequence[str], n_threads: int = 1) -> str:
    """The lines of ``values`` (rows, sum(dims)) float32 or float64, row
    i between ``heads[i]`` and ``tails[i]``: ``{"name":[v,...],...}``
    with each checkpoint's ``dims`` values in ``names`` order."""
    values = np.ascontiguousarray(values)
    rows, row_len = values.shape
    dims = np.asarray(dims, np.int64)
    if values.dtype not in (np.float32, np.float64):
        raise TypeError(f"values of dtype {values.dtype}")
    if len(names) != len(dims) or int(dims.sum()) != row_len \
            or len(heads) != rows or len(tails) != rows:
        raise ValueError(f"{rows} rows of {row_len} values for dims "
                         f"{dims.tolist()}, {len(names)} names, "
                         f"{len(heads)} heads, {len(tails)} tails")
    keys = [json.dumps(k) for k in names]
    seps = (["{" + keys[0] + ":["] + [f"],{k}:[" for k in keys[1:]]
            + ["]}"]) if keys else ["{}"]
    sep_bytes, sep_off = _offsets(seps)
    texts, text_off = _offsets([t for pair in zip(heads, tails)
                                for t in pair])
    cap = len(texts) + rows * (len(sep_bytes) + row_len * 25)
    out = np.empty(max(cap, 1), np.uint8)
    n = lib.featjson_lines(
        values.ctypes.data, int(values.dtype == np.float64), rows, row_len,
        dims.ctypes.data, len(dims), sep_bytes, sep_off.ctypes.data, texts,
        text_off.ctypes.data, out.ctypes.data, out.size, n_threads)
    if n < 0:
        raise RuntimeError(f"featjson: {out.size} bytes under the bound")
    return str(memoryview(out)[:n], "ascii")


class FeatureWriter:
    """Writes a flush's feature lines with the library.  ``required``:
    a library that does not build raises (the card's path); otherwise
    :meth:`lines` gives None, and the caller writes with ``json``."""

    def __init__(self, required: bool):
        try:
            self.lib: Optional[ctypes.CDLL] = load_library()
        except (RuntimeError, OSError):
            if required:
                raise
            self.lib = None
        # four threads format 190 faces in a third of one thread's time
        # on the card's host; eight gain little more
        self.n_threads = max(1, min(4, os.cpu_count() or 1))

    def lines(self, n: int, record: Callable[[int, dict], dict],
              embeddings: Dict[str, np.ndarray]) -> Optional[str]:
        """The ``n`` lines of ``record(i, {})`` (a feature record with
        empty embeddings) with row i of each ``embeddings`` array, as
        :func:`records.write_feature` writes ``record(i, {name:
        row.tolist(), ...})``; None without the library or the arrays,
        or where an array is not (n, dim) float32 or float64."""
        arrays = [np.asarray(v)[:n] for v in embeddings.values()]
        if self.lib is None or not arrays or not all(
                a.ndim == 2 and len(a) == n
                and a.dtype in (np.float32, np.float64) for a in arrays):
            return None
        values = np.concatenate(arrays, axis=1)
        parts = [line_parts(record(i, {})) for i in range(n)]
        return format_lines(self.lib, values, list(embeddings),
                            [a.shape[1] for a in arrays],
                            [h for h, _ in parts], [t for _, t in parts],
                            self.n_threads)
