"""Stage reports: counters + wall time merged into ``run_report.json``,
and the host spans and counters a stage records on its way.

Port of the ``StageReport`` part of ``facerec_tpu/runtime/metrics.py``.
Each report records the settings that change the port's numbers: its
device and the float32 precision modes.  (The JAX package's
``FACEREC_*`` A/B knobs do not exist in the port.)

:class:`Spans` is the one timing system of the extract loop
(``pipeline/extract.py:run_span``).  The extract report's ``counters``
hold its totals, summed over the spans of a ``--mesh`` run:

- ``<span>_seconds`` for every span.  The seven phases ``decode``,
  ``encode``, ``upload``, ``dispatch``, ``fetch``, ``consume`` and
  ``flush_dispatch`` are disjoint and nest nothing in one another; the
  rest are their children: ``dispatch_scene``, ``dispatch_detector``,
  ``dispatch_tracker``, ``dispatch_pack`` under ``dispatch``;
  ``consume_unpack``, ``consume_assemble``, ``consume_plan``,
  ``consume_write`` under ``consume``; ``flush_embed`` under
  ``flush_dispatch``; with a bank of networks (``EmbedderBank``
  built from embedders; a stand-in declares no spans or counters),
  ``embed_replay`` under ``flush_embed``: the host's part of the
  chunks' graph replays (the copy in, the launch, the copy out), whose
  host range holds the replayed kernels in a profile; with a bank
  that aligns its crops (ArcFace), ``flush_align`` under
  ``flush_embed``: the host's part of the
  alignment in the bank (the landmarks' stacking and padding, their
  copy to the device and the kernel's launch); and, under ``FACEREC_PHASE_LOG``
  only, ``fetch_compute_wait`` under ``fetch``.  A parent's self time
  is its seconds less its children's.
- counters: ``embed_crops`` and ``embed_slots`` (real crops and the
  padded batch slots embedded), ``embed_dispatches``, ``detections``
  (valid detections of the blocks consumed), ``fetch_bytes`` and
  ``fetch_groups`` (device→host bytes and grouped fetches),
  ``upload_bytes`` (host→device bytes of the block uploads),
  ``upload_pinned_blocks`` (of those blocks, the ones copied through
  the pinned staging ring on the copy stream: every block on a card,
  none on the CPU; ``pipeline/extract.py:_BlockUpload``),
  ``feature_records`` (lines written to the features file),
  ``feature_records_native`` (of them, those the native writer wrote,
  ``contract/featjson.py``) and ``feature_bytes`` (their bytes); with
  a bank of networks, ``embed_graph_replays`` (chunks of
  ``EMBED_BATCH`` slots replayed from the bank's CUDA graph) and
  ``embed_eager_chunks`` (chunks run eagerly: every chunk on the CPU, a
  shorter one on a card), so ``embed_graph_replays`` over their sum is
  the share the graph took; with a bank that aligns, also
  ``aligned_crops`` (real crops aligned) and
  ``align_degenerate`` (of them, those whose landmarks have no
  similarity, ``ops/align.py``).

``FACEREC_PHASE_LOG`` prints its ``[phase]`` lines from the spans.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterable, List, Optional

import torch
from torch._C._autograd import _profiler_enabled


def effective_knobs(device: torch.device) -> Dict[str, object]:
    return {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "torch": torch.__version__,
    }


class Spans:
    """Named host spans and counters of one stage run.

    :meth:`span` adds its duration on ``time.perf_counter`` to its
    name's total.  Spans nest: each name keeps the parent it was
    first opened under (another parent raises), so a parent's seconds
    cover its children's.  :meth:`count` adds to a counter.

    While the torch profiler runs, a span is also a host range named
    ``<stage>.<name>`` on the profiler's clock, beside the device's
    kernels and copies, with its ``ids`` (``frame0=`` of a block,
    ``group=`` of a fetch group; a span given none carries its
    parent's) as keyword inputs that ``record_shapes=True`` keeps.  The
    range is a function-scope record (what torch's compiled graphs
    open), not ``record_function``'s user annotation: the profiler gives
    a user annotation a device-side event spanning its kernels and the
    idle time between them, which a reader of device activity would
    count as busy.  With the profiler off a span costs the check
    (~0.15 µs), two clock reads and a few dict updates."""

    def __init__(self, stage: str, spans: Iterable[str] = (),
                 counters: Iterable[str] = ()):
        """``spans`` and ``counters`` are reported at 0 if never
        opened or counted."""
        self.stage = stage
        self.seconds: Dict[str, float] = dict.fromkeys(spans, 0.0)
        self.parent: Dict[str, Optional[str]] = {}
        self.last: Dict[str, float] = {}   # each name's latest duration
        self.counters: Dict[str, int] = dict.fromkeys(counters, 0)
        self._stack: List[tuple] = []      # (name, ids) of the open spans

    @contextlib.contextmanager
    def span(self, name: str, **ids: int):
        stack = self._stack
        parent = stack[-1][0] if stack else None
        if self.parent.setdefault(name, parent) != parent:
            raise ValueError(f"span {name!r} opened under {parent!r}, "
                             f"first under {self.parent[name]!r}")
        if not ids and stack:
            ids = stack[-1][1]
        stack.append((name, ids))
        rng = None
        if _profiler_enabled():
            rng = torch._C._profiler._RecordFunctionFast(
                f"{self.stage}.{name}", (), ids)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)
            stack.pop()
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.last[name] = dt

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def totals(self) -> Dict[str, float]:
        """``<span>_seconds`` for every span, then the counters: the
        keys the stage's report holds."""
        out: Dict[str, float] = {f"{name}_seconds": s
                                 for name, s in self.seconds.items()}
        out.update(self.counters)
        return out


class StageReport:
    """Counters + wall-clock for one stage run."""

    def __init__(self, stage: str, device: torch.device):
        self.stage = stage
        self.device = device
        self.counters: Dict[str, float] = {}
        self._start = time.time()

    def set(self, name: str, value) -> None:
        self.counters[name] = value

    def set_totals(self, totals: Dict[str, float]) -> None:
        """:meth:`Spans.totals`, the seconds to the millisecond."""
        for key, value in totals.items():
            self.set(key, round(value, 3) if isinstance(value, float)
                     else value)

    def finish(self) -> dict:
        return {
            "stage": self.stage,
            "wall_seconds": round(time.time() - self._start, 3),
            "counters": self.counters,
            "env_knobs": effective_knobs(self.device),
        }

    def write(self, data_dir: str) -> dict:
        """Merge this stage's summary into ``run_report.json``."""
        summary = self.finish()
        path = os.path.join(data_dir, "run_report.json")
        report = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    report = json.load(f)
            except (json.JSONDecodeError, OSError):
                report = {}
        report[self.stage] = summary
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, path)
        return summary
