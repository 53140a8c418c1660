"""Pipeline orchestrator.

Port of ``facerec_tpu/pipeline/orchestrate.py``: a declarative stage
list (download → extract → merge → cluster → classify) executed in
order with per-stage timing and abort-on-failure, on one device, or
with ``--mesh N`` extract on N devices, one process each
(:mod:`facerec_torch.parallel.extract_mesh`).  The film is a path, or
an in-memory clip (:func:`facerec_torch.video.synth.make_frames`, or
:func:`~facerec_torch.video.synth.paint_frames` for a mesh) for a host
that cannot decode video; the download stage is skipped for an
in-memory clip.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, List, Optional

from facerec_torch.config import PipelineConfig
from facerec_torch.contract.naming import movie_id_from_filename
from facerec_torch.pipeline import classify as classify_mod
from facerec_torch.pipeline.cluster import run_cluster
from facerec_torch.pipeline.extract import (EmbedderBank, add_embedder_args,
                                            run_extract)
from facerec_torch.pipeline.merge import run_merge
from facerec_torch.runtime.device import resolve_device
from facerec_torch.runtime.metrics import StageReport

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class Stage:
    name: str
    run: Callable[[], object]
    skip: bool = False


def build_stages(film, out_path: str, cfg: PipelineConfig,
                 actors_dir: Optional[str] = None,
                 skip: List[str] = (),
                 shard_procs: int = 0,
                 mesh: int = 0,
                 detector_weights: Optional[str] = None,
                 facenet_weights: Optional[str] = None,
                 device=None,
                 detector: Optional[Callable] = None,
                 embedders: Optional[EmbedderBank] = None,
                 embedder: str = "facenet",
                 arcface_weights: Optional[str] = None) -> List[Stage]:
    """The stage list for one film on ``device`` (the card unless
    ``"cpu"`` is asked for).  ``detector`` and ``embedders`` replace the
    ones built from the weights (they must live on ``device``; a mesh
    sends them to its workers).  ``embedder`` names the bank's family
    (``config.EMBEDDERS``): cluster and classify read its embedding.  ``mesh`` > 1 runs extract on the first
    ``mesh`` cards, or in ``mesh`` CPU processes with ``device="cpu"``;
    too few cards raise here."""
    mesh_devs = None
    if mesh > 1:
        from facerec_torch.parallel.mesh import mesh_devices

        mesh_devs = mesh_devices(mesh, device if device is not None
                                 else "cuda")
    in_memory = not isinstance(film, (str, os.PathLike))
    if in_memory and shard_procs > 1:
        raise ValueError("--shard-procs needs a film file: an in-memory "
                         "clip cannot be handed to a subprocess")
    dev = resolve_device(device)
    cfg = cfg.for_embedder(embedder)
    filmfile = film.path if in_memory else film
    movie_id = movie_id_from_filename(filmfile)
    data_dir = os.path.join(out_path, f"{movie_id}-data")

    def download():
        # shells out to the download script; skipped when the film is
        # on disk or in memory
        if os.path.exists(filmfile):
            print(f"{filmfile} already exists")
            return None
        script = os.path.join(REPO, "scripts", "download.sh")
        res = subprocess.run(["bash", script, filmfile])
        if res.returncode != 0:
            raise RuntimeError(f"download failed ({res.returncode})")
        return None

    def extract():
        if shard_procs > 1:
            # one subprocess per shard, run in turn; each shard is
            # resumable, so a crashed run re-runs only missing shards
            weight_args = []
            if detector_weights is not None:
                weight_args += ["--detector-weights", detector_weights]
            if facenet_weights is not None:
                weight_args += ["--facenet-weights", facenet_weights]
            weight_args += ["--embedder", embedder]
            if arcface_weights is not None:
                weight_args += ["--arcface-weights", arcface_weights]
            for i in range(shard_procs):
                cmd = [sys.executable, "-m", "facerec_torch.pipeline.extract",
                       "--device", str(dev),
                       "--n-shards", str(shard_procs), "--shard-i", str(i),
                       "--out-path", out_path, *weight_args, filmfile]
                print(f"[extract shard {i + 1}/{shard_procs}] "
                      + " ".join(cmd), flush=True)
                res = subprocess.run(cmd)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"extract shard {i} failed ({res.returncode})")
            return None
        if mesh_devs is not None:
            from facerec_torch.parallel.extract_mesh import run_extract_mesh

            return run_extract_mesh(film, cfg.extract, out_path,
                                    devices=mesh_devs, detector=detector,
                                    embedders=embedders,
                                    detector_weights=detector_weights,
                                    facenet_weights=facenet_weights,
                                    embedder=embedder,
                                    arcface_weights=arcface_weights)
        return run_extract(film, cfg.extract, out_path, detector=detector,
                           embedders=embedders,
                           detector_weights=detector_weights,
                           facenet_weights=facenet_weights, device=dev,
                           embedder=embedder,
                           arcface_weights=arcface_weights)

    def merge():
        return run_merge(data_dir, movie_id, cfg.merge)

    def cluster():
        return run_cluster(data_dir, cfg.cluster, dev)

    def classify():
        zipf = os.path.join(actors_dir or ".", "actor-images.zip")
        embeddings, _ = classify_mod.read_actor_embeddings(
            zipf, cfg.classify.emb_name)
        x, y = classify_mod.build_training_set(embeddings,
                                               cfg.classify.min_samples)
        return classify_mod.run_classify(data_dir, x, y, cfg.classify, dev)

    stages = [
        Stage("download", download,
              skip=in_memory or os.path.exists(filmfile)),
        Stage("extract", extract),
        Stage("merge", merge),
        Stage("cluster", cluster),
        Stage("classify", classify, skip=actors_dir is None),
    ]
    for s in stages:
        if s.name in skip:
            s.skip = True
    return stages


def run_pipeline(stages: List[Stage], verbose: bool = False,
                 data_dir: Optional[str] = None, device=None) -> bool:
    """Run stages in order; abort on the first failure.  With
    ``data_dir`` the per-stage wall times land in the movie's
    ``run_report.json`` beside each stage's own counters."""
    report = (StageReport("pipeline", resolve_device(device))
              if data_dir is not None else None)
    ok = True
    for i, stage in enumerate(stages):
        if stage.skip:
            print(f"Skipping stage <{stage.name}>")
            continue
        start = time.time()
        print(f"Starting stage #{i} <{stage.name}>")
        try:
            stage.run()
        except Exception:
            # the stage boundary: report the traceback and abort
            print(f"Stage #{i} <{stage.name}> failed in "
                  f"{time.time() - start:.1f}s, aborting.")
            traceback.print_exc()
            ok = False
        if report is not None:
            report.set(f"{stage.name}_seconds",
                       round(time.time() - start, 3))
            if not ok:
                report.set("failed_stage", stage.name)
        if not ok:
            break
        print(f"Stage #{i} <{stage.name}> succeeded in "
              f"{time.time() - start:.1f}s")
    if report is not None and os.path.isdir(data_dir):
        report.write(data_dir)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--filmfile", type=str, required=True,
                        help="film path like 125261-name.mp4")
    parser.add_argument("--out-path", type=str, default=".")
    parser.add_argument("--actors-dir", type=str, default=None,
                        help="directory with actor-images.zip (enables "
                             "the classify stage)")
    parser.add_argument("--skip", type=str, default="",
                        help="comma-separated stage names to skip")
    parser.add_argument("--shard-procs", type=int, default=0,
                        help="run extract as N sequential per-shard "
                             "subprocesses (shards are resumable)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="run extract as N simultaneous shard spans, "
                             "one process per device (see extract --mesh)")
    parser.add_argument("--facenet-weights", type=str, default=None,
                        help="directory with the four FaceNet "
                             "checkpoints (see extract --help)")
    parser.add_argument("--detector-weights", type=str, default=None,
                        help="single-file Flax .npz detector checkpoint")
    add_embedder_args(parser)
    parser.add_argument("--fetch-every-blocks", type=int, default=None,
                        help="extract transfer batching (see extract "
                             "--help)")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help="parallel native decode workers for "
                             "extract")
    parser.add_argument("--wire-format", type=str, default=None,
                        choices=["rgb", "rgb-delta", "yuv420-delta"],
                        help="extract host→device pixel format (see "
                             "extract --help)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    pcfg = PipelineConfig()
    overrides = {k: v for k, v in (
        ("fetch_every_blocks", args.fetch_every_blocks),
        ("decode_workers", args.decode_workers),
        ("wire_format", args.wire_format)) if v is not None}
    if overrides:
        pcfg = dataclasses.replace(pcfg, extract=dataclasses.replace(
            pcfg.extract, **overrides))

    stages = build_stages(args.filmfile, args.out_path, pcfg,
                          actors_dir=args.actors_dir,
                          skip=args.skip.split(",") if args.skip else (),
                          shard_procs=args.shard_procs,
                          mesh=args.mesh,
                          detector_weights=args.detector_weights,
                          facenet_weights=args.facenet_weights,
                          device=args.device, embedder=args.embedder,
                          arcface_weights=args.arcface_weights)
    movie_id = movie_id_from_filename(args.filmfile)
    ok = run_pipeline(stages, verbose=args.verbose,
                      data_dir=os.path.join(args.out_path,
                                            f"{movie_id}-data"),
                      device=args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
