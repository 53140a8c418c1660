"""Multi-device production extract: n temporal spans of a film at once,
one process per device.

Counterpart of ``facerec_tpu/parallel/extract_mesh.py``.  The reference
scales extraction by running array tasks that each own a contiguous
frame range plus a ``max_trajectory_age`` overlap (SURVEY.md §2.4).
Device i owns span i and carries its own scene and tracker state; no
collective is needed, the merge stage stitches the spans as it
stitches file shards.  Where the JAX package advances every span with
one ``shard_map`` dispatch per block, here each span runs the serial
loop (:func:`facerec_torch.pipeline.extract.run_span`) in a process of
its own: the tracker is host-bound, so spans in one Python thread would
take turns.  So a mesh run writes the shard files of a serial
``--n-shards n`` loop, byte for byte.

The parent plans the spans, skips the finished ones (``.done``),
builds the CUDA kernels once, starts the workers and writes the one
``extract_mesh_{n}`` report; each worker builds its detector and bank
on its own device and resumes its span's checkpoint.  An in-memory film
reaches the workers as a painted clip's arguments
(:func:`facerec_torch.video.synth.paint_frames`), never as pixels.
"""
from __future__ import annotations

import dataclasses
import io
import os
from typing import List, Optional, Sequence

import torch

from facerec_torch.config import ExtractConfig
from facerec_torch.contract import MovieDirs
from facerec_torch.contract.naming import movie_id_from_filename
from facerec_torch.ops import equalize as eqm
from facerec_torch.parallel.mesh import mesh_devices, run_ranks
from facerec_torch.pipeline.extract import (EmbedderBank, ExtractCounters,
                                            build_detector, build_embedders,
                                            check_wire_format, film_info,
                                            run_span)
from facerec_torch.runtime import checkpoint as ckpt
from facerec_torch.runtime.metrics import StageReport
from facerec_torch.video.synth import PaintedFrames


def plan_spans(n_frames: int, n: int, overlap: int) -> List[tuple]:
    """(beg, end, stop) of each of n spans: ceil(n_frames / n) frames,
    then the tracker overlap.  With fewer frames than spans need, the
    later spans are empty (beg == end), never inverted."""
    span_len = (n_frames + n - 1) // n
    spans = []
    for i in range(n):
        beg = min(span_len * i, n_frames)
        end = min(beg + span_len, n_frames)
        spans.append((beg, end, min(end + overlap, n_frames)))
    return spans


def _film_for_workers(file):
    """A film path as it is; an in-memory clip as its painted frames'
    arguments, without the truth."""
    if isinstance(file, (str, os.PathLike)):
        return os.fspath(file)
    if not isinstance(file.frames, PaintedFrames):
        raise ValueError(
            "an in-memory film reaches the span workers only as a painted "
            "clip (facerec_torch.video.synth.paint_frames): its pixels "
            "are not sent to other processes")
    return dataclasses.replace(file, truth={}, truth_ids={})


def _to_bytes(obj) -> Optional[bytes]:
    """``obj`` serialised with its tensors by value (torch.save), so a
    worker can load it onto its own device."""
    if obj is None:
        return None
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _span_worker(rank, device, film, cfg, dirs, movie_id, info, spans,
                 n, detector_bytes, embedder_bytes, detector_weights,
                 facenet_weights):
    """Span ``spans[rank]`` on ``device``: build (or load) the detector
    and bank there, run the serial loop; returns (counters, blocks,
    phase seconds, the scene kernels' launches)."""
    beg, end, stop = spans[rank]
    load = lambda b: torch.load(io.BytesIO(b), map_location=device,
                                weights_only=False)
    d_h, d_w = info.display_height, info.display_width
    detector = (load(detector_bytes) if detector_bytes is not None
                else build_detector(cfg, d_h, d_w, detector_weights, device))
    embedders = (load(embedder_bytes) if embedder_bytes is not None
                 else build_embedders(facenet_weights, device))
    run = run_span(film, info, cfg, dirs, movie_id, beg, end, stop, detector,
                   embedders, device, spans=n)
    return run.counters, run.blocks, run.phase, dict(eqm.launches)


def run_extract_mesh(
    file,
    cfg: ExtractConfig,
    out_path: str,
    mesh_size: Optional[int] = None,
    devices: Optional[Sequence] = None,
    detector=None,
    embedders: Optional[EmbedderBank] = None,
    aspect_csv: str = "aspect_ratios.csv",
    detector_weights: Optional[str] = None,
    facenet_weights: Optional[str] = None,
) -> List[ExtractCounters]:
    """Extract the whole film as n simultaneous spans, one process per
    device, and write the per-span shard files a serial ``--n-shards
    n`` loop writes; run the merge stage afterwards.

    ``devices`` lists one device per span (it may repeat one, and
    ``["cpu"] * n`` runs n CPU processes); else the first ``mesh_size``
    visible cards.  A given ``detector`` and ``embedders`` are sent to
    every worker by value and loaded onto its device (test stubs must
    be importable classes); else each worker builds them from the
    weight paths.  Returns the counters of the spans that ran ([] when
    every span was done already); a failed span fails the run, and the
    other spans keep their checkpoints and ``.done`` markers."""
    devs = mesh_devices(mesh_size, devices=devices)
    n = len(devs)
    check_wire_format(cfg)

    name, info = film_info(file, cfg, aspect_csv)
    movie_id = movie_id_from_filename(name)
    dirs = MovieDirs.create(out_path, movie_id)
    report = StageReport(f"extract_mesh_{n}", devs[0])

    spans = plan_spans(info.n_frames, n, cfg.max_trajectory_age)
    print(f"Movie file: {os.path.basename(name)}")
    print(f"Mesh extract: {n} spans × {spans[0][1] - spans[0][0]} frames "
          f"(block {cfg.block_frames}) on {[str(d) for d in devs]}")

    # finished spans are skipped by their .done marker; crashed ones
    # resume from their block-granular checkpoint in the worker
    active = []
    for i, (beg, end, _) in enumerate(spans):
        if beg >= end:
            continue
        if cfg.resume and ckpt.is_shard_done(dirs.root, "extract", movie_id,
                                             beg, end):
            print(f"Span {beg}-{end} already complete; skipping.")
            continue
        active.append(i)
    if not active:
        return []

    if any(devs[i].type == "cuda" for i in active):
        from facerec_torch.ops import _build

        _build.build_all()     # once, before n workers would race on it
    span_cfg = dataclasses.replace(cfg, n_shards=n)
    film = _film_for_workers(file)
    det_bytes, emb_bytes = _to_bytes(detector), _to_bytes(embedders)
    results = run_ranks(
        _span_worker, [devs[i] for i in active], group=False,
        args=(film, span_cfg, dirs, movie_id, info,
              [spans[i] for i in active], n, det_bytes, emb_bytes,
              detector_weights, facenet_weights))

    counters = [r[0] for r in results]
    for _, _, _, launches in results:
        for k, v in launches.items():
            eqm.launches[k] += v
    total = ExtractCounters(**{
        f.name: sum(getattr(c, f.name) for c in counters)
        for f in dataclasses.fields(ExtractCounters)})
    for key, value in dataclasses.asdict(total).items():
        report.set(key, value)
    report.set("spans", n)
    report.set("steps", sum(r[1] for r in results))
    # each span's loop wall time: the spans run at once, so the slowest
    # bounds the run
    report.set("span_loop_seconds",
               [round(sum(r[2].values()), 3) for r in results])
    for key in results[0][2]:
        report.set(f"{key}_seconds",
                   round(sum(r[2][key] for r in results), 3))
    report.write(dirs.root)
    print(f"Saved {total.saved_boxes} boxes from "
          f"{total.saved_frames} different frames")
    print(f"and {total.saved_trajectories} trajectories "
          f"across {n} spans.")
    if total.overflow:
        print(f"WARNING: {total.overflow} detections dropped at "
              f"track-capacity limit.")
    return counters
