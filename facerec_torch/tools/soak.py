"""Film-scale soak: the reference's nominal workload, end to end.

Port of ``facerec_tpu/tools/soak.py``.  The reference processes
~180k-frame films (reference facerec/extract.py:209,266 — 2 h at 25
fps) in shards with an 8 GB/CPU memory budget.  Nothing short proves a
single-process loop survives that scale: pixel-window and host-RSS
growth across thousands of fetch groups, checkpoint cadence, JPEG
writer backpressure, features-file size.  This soak runs a low-res
scripted-detector film through the real extract loop (checkpoints on,
the delta-I420 wire, grouped fetches) while sampling host RSS and the
checkpoint's ``next_frame``, then asserts:

  - every frame processed (final counters match the film length);
  - host RSS stays under the budget (default: the reference's 8 GB);
  - checkpoint progress is monotone non-decreasing;
  - output files exist and are non-trivial.

Run (``--device cpu`` on a host without a card)::

  python -m facerec_torch.tools.soak --out DIR --frames 100000

The film is an mp4 written with OpenCV (cached beside its pickled
truth; synthesis holds the whole clip in memory), or with
``--in-memory`` a clip painted block by block as the reader reads it
(:func:`facerec_torch.video.synth.paint_frames`): a host without a video
codec runs that way, with ``--no-images``, and then no film is held in
memory.  The report keeps the RSS at every checkpoint sample beside the
high-water and the RSS before the run, so growth can be told from fixed
cost.  The scripted detector replays ground truth and the default
embedder is a cheap deferred-fetch stub: the soak measures the loop and
its memory, not model FLOPs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from facerec_torch.config import FACENET_DIMS, FACENET_MODELS
from facerec_torch.pipeline.extract import EmbedderBank
from facerec_torch.runtime.transfer import pack_tree


def _vm_rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


class StubBank(EmbedderBank):
    """Deferred-fetch pooled-pixel projection bank: each crop's 5×5
    pooled pixels through a fixed random projection per checkpoint (the
    four checkpoints' output dims: realistic fetch sizes without
    FaceNet's cost), unit-normalised, left on the device as one uint8
    buffer."""

    def __init__(self, seed: int = 0, device=None):
        rng = np.random.default_rng(seed)
        self.names = list(FACENET_MODELS)
        self.dims = [FACENET_DIMS[n] for n in self.names]
        self.total_dim = sum(self.dims)
        self.supports_deferred = True
        proj = np.concatenate([rng.normal(size=(75, d)) / 8.0
                               for d in self.dims], axis=1)
        self.proj = torch.from_numpy(proj.astype(np.float32))
        if device is not None:
            self.proj = self.proj.to(device)

    def dispatch_packed(self, crops: torch.Tensor) -> torch.Tensor:
        x = crops.float()
        n = x.shape[0]
        flat = x.reshape(n, 5, 32, 5, 32, 3).mean(dim=(2, 4)).reshape(
            n, -1) / 255.0
        e = flat @ self.proj.to(x.device)
        outs = [p / torch.linalg.vector_norm(
                    p, dim=1, keepdim=True).clamp_min(1e-9)
                for p in torch.split(e, self.dims, dim=1)]
        return pack_tree(torch.cat(outs, dim=1))


class _Monitor:
    """Background sampler: host RSS high-water mark, the checkpoint's
    next_frame series (monotone progress proof) and the RSS when each
    new checkpoint was seen."""

    def __init__(self, ckpt_path: str, interval: float = 1.0):
        self.ckpt_path = ckpt_path
        self.interval = interval
        self.max_rss = 0
        self.start_rss = 0
        self.ckpt_frames: list = []
        self.ckpt_rss: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        from facerec_torch.runtime import checkpoint as ckpt

        while not self._stop.is_set():
            self.max_rss = max(self.max_rss, _vm_rss_bytes())
            state = ckpt.load_checkpoint(self.ckpt_path)
            if state is not None:
                f = int(state["next_frame"])
                if not self.ckpt_frames or f != self.ckpt_frames[-1]:
                    self.ckpt_frames.append(f)
                    self.ckpt_rss.append(_vm_rss_bytes())
            self._stop.wait(self.interval)

    def __enter__(self):
        self.start_rss = _vm_rss_bytes()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.max_rss = max(self.max_rss, _vm_rss_bytes())


def synth_film(out: str, n_frames: int, width: int, height: int,
               in_memory: bool = False):
    """The soak's film: cuts every 400 frames, seed 3.  In memory
    (painted block by block as it is read), or an mp4 in ``out`` cached
    beside its pickled truth (reused when both exist)."""
    from facerec_torch.video.synth import make_clip, paint_frames

    name = f"125261-Soak{n_frames}.mp4"
    kw = dict(n_frames=n_frames, width=width, height=height,
              cuts=tuple(range(400, n_frames, 400)), seed=3)
    if in_memory:
        return paint_frames(path=name, **kw)
    import pickle

    from facerec_torch.tools.detector_eval import load_truth_pickle

    film = os.path.join(out, name)
    truth_path = film + ".truth.pkl"
    if not (os.path.exists(film) and os.path.exists(truth_path)):
        print(f"synthesizing {n_frames}-frame {width}x{height} film...",
              flush=True)
        t0 = time.perf_counter()
        clip = make_clip(film + ".tmp.mp4", **kw)
        os.replace(film + ".tmp.mp4", film)
        with open(truth_path, "wb") as f:
            pickle.dump(dataclasses.replace(clip, path=film, frames=None), f)
        print(f"  synthesized in {time.perf_counter() - t0:.0f}s",
              flush=True)
    return load_truth_pickle(truth_path)


def run_soak(out: str, n_frames: int = 100_000, width: int = 256,
             height: int = 192, block_frames: int = 128,
             checkpoint_every: int = 16, fetch_every: int = 8,
             save_every: int = 5, wire_format: str = "yuv420-delta",
             save_images: bool = True, rss_budget_gb: float = 8.0,
             decode_workers: int = 2, embedders=None, film=None,
             in_memory: bool = False, device=None,
             monitor_interval: float = 1.0) -> dict:
    """Synthesize (cached) + run + assert; returns the soak report.

    ``film`` may be a path with a ``<film>.truth.pkl`` beside it, or an
    in-memory clip; None synthesizes one (:func:`synth_film`).
    ``device`` is the card unless ``"cpu"`` is asked for."""
    from facerec_torch.config import ExtractConfig
    from facerec_torch.contract.naming import movie_id_from_filename
    from facerec_torch.pipeline.extract import run_extract
    from facerec_torch.runtime.device import resolve_device
    from facerec_torch.tools.detector_eval import load_truth_pickle
    from facerec_torch.video.synth import ScriptedDetector

    device = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    if isinstance(film, (str, os.PathLike)):
        source = os.fspath(film)
        clip = load_truth_pickle(source + ".truth.pkl")
    else:
        clip = film or synth_film(out, n_frames, width, height, in_memory)
        source = clip if clip.frames is not None else clip.path
    n_frames, width, height = clip.n_frames, clip.width, clip.height

    movie_id = movie_id_from_filename(
        source if isinstance(source, str) else clip.path)
    cfg = ExtractConfig(
        block_frames=block_frames, save_every=save_every,
        checkpoint_every_blocks=checkpoint_every,
        fetch_every_blocks=fetch_every, wire_format=wire_format,
        save_images=save_images, decode_workers=decode_workers,
        resume=False)
    if embedders is None:
        embedders = StubBank(device=device)
    detector = ScriptedDetector(clip, max_detections=8)

    data_dir = os.path.join(out, f"{movie_id}-data")
    ckpt_path = os.path.join(data_dir,
                             f".extract_{movie_id}_0-{n_frames}.ckpt")
    t0 = time.perf_counter()
    with _Monitor(ckpt_path, monitor_interval) as mon:
        counters = run_extract(source, cfg, out, detector=detector,
                               embedders=embedders, device=device)
    wall = time.perf_counter() - t0

    feat_dir = os.path.join(data_dir, "features")
    (feat_name,) = os.listdir(feat_dir)
    feat_bytes = os.path.getsize(os.path.join(feat_dir, feat_name))
    n_images = (len(os.listdir(os.path.join(data_dir, "images")))
                if save_images else 0)
    with open(os.path.join(data_dir, "run_report.json")) as f:
        extract_report = json.load(f)[f"extract_0-{n_frames}"]["counters"]

    report = {
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime()),
        "platform": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "host_cpus": os.cpu_count(),
        "n_frames": n_frames,
        "resolution": f"{width}x{height}",
        "film": "in memory" if clip.frames is not None else "mp4",
        "wire_format": extract_report["wire_format"],
        "encode_path": extract_report["encode_path"],
        "wall_seconds": round(wall, 1),
        "frames_per_sec": round(counters.frames_processed / wall, 1),
        "frames_processed": counters.frames_processed,
        "saved_boxes": counters.saved_boxes,
        "saved_trajectories": counters.saved_trajectories,
        "overflow": counters.overflow,
        "max_rss_gb": round(mon.max_rss / (1 << 30), 3),
        "start_rss_gb": round(mon.start_rss / (1 << 30), 3),
        "rss_budget_gb": rss_budget_gb,
        "ckpt_samples": len(mon.ckpt_frames),
        "ckpt_first_last": (mon.ckpt_frames[:1] + mon.ckpt_frames[-1:]
                            if mon.ckpt_frames else []),
        # [next_frame, RSS in GB] at each checkpoint sample
        "ckpt_rss_gb": [[f, round(r / (1 << 30), 3)] for f, r in
                        zip(mon.ckpt_frames, mon.ckpt_rss)],
        "features_bytes": feat_bytes,
        "n_face_images": n_images,
        "phase_seconds": {k: v for k, v in extract_report.items()
                          if k.endswith("_seconds")},
    }

    failures = []
    if counters.frames_processed != n_frames:
        failures.append(f"processed {counters.frames_processed} != "
                        f"{n_frames}")
    if mon.max_rss > rss_budget_gb * (1 << 30):
        failures.append(f"RSS {report['max_rss_gb']} GB over the "
                        f"{rss_budget_gb} GB budget")
    if mon.ckpt_frames != sorted(mon.ckpt_frames):
        failures.append(f"checkpoint progress not monotone: "
                        f"{mon.ckpt_frames}")
    if counters.saved_boxes == 0 or feat_bytes == 0:
        failures.append("no features written")
    if counters.saved_trajectories == 0:
        failures.append("no trajectories written")
    report["failures"] = failures
    report["pass"] = not failures

    with open(os.path.join(out, "soak_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    os.environ.setdefault("FACEREC_ALLOW_RANDOM", "1")
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--frames", type=int, default=100_000)
    parser.add_argument("--width", type=int, default=256)
    parser.add_argument("--height", type=int, default=192)
    parser.add_argument("--block-frames", type=int, default=128)
    parser.add_argument("--checkpoint-every", type=int, default=16)
    parser.add_argument("--fetch-every", type=int, default=8)
    parser.add_argument("--wire-format", default="yuv420-delta")
    parser.add_argument("--no-images", action="store_true")
    parser.add_argument("--in-memory", action="store_true",
                        help="paint the film in memory (no mp4 codec "
                             "needed)")
    parser.add_argument("--rss-budget-gb", type=float, default=8.0)
    parser.add_argument("--decode-workers", type=int, default=2)
    parser.add_argument("--embedders", choices=("stub", "real"),
                        default="stub",
                        help="real = the full 4-FaceNet bank")
    args = parser.parse_args(argv)

    from facerec_torch.runtime.device import resolve_device

    device = resolve_device(args.device)
    embedders = None
    if args.embedders == "real":
        embedders = EmbedderBank.create_default(device)
    report = run_soak(
        args.out, n_frames=args.frames, width=args.width,
        height=args.height, block_frames=args.block_frames,
        checkpoint_every=args.checkpoint_every,
        fetch_every=args.fetch_every, wire_format=args.wire_format,
        save_images=not args.no_images,
        rss_budget_gb=args.rss_budget_gb,
        decode_workers=args.decode_workers, embedders=embedders,
        in_memory=args.in_memory, device=device)
    print(json.dumps(report, indent=2))
    print(f"SOAK: {'PASS' if report['pass'] else 'FAIL'}", flush=True)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
