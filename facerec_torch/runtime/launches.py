"""The launch counts of the port's CUDA kernels, read as one dict.

Each kernel wrapper counts its launches in its own module
(``ops/equalize.py``: one key per entry point; ``track/tracker.py``:
``tracker``; ``ops/align.py``: ``align_warp``).  ``chip_smoke.py``
zeroes them before it drives a path and reads them after; a mesh adds
its workers' counts to its own.
"""
from __future__ import annotations

from typing import Dict, Mapping

from facerec_torch.ops import align, equalize
from facerec_torch.track import tracker

_COUNTERS = (equalize.launches, tracker.launches, align.launches)


def snapshot() -> Dict[str, int]:
    """Every kernel's launches so far, by key."""
    return {k: v for counter in _COUNTERS for k, v in counter.items()}


def reset() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0


def add(counts: Mapping[str, int]) -> None:
    """Add another process's :func:`snapshot` to this one's counts."""
    for counter in _COUNTERS:
        for k in counter:
            counter[k] += counts.get(k, 0)
