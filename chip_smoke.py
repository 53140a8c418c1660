"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``facerec_torch/csrc``, holds each
against its plain PyTorch version on the card, drives the extract
stage end to end at full model width (detector w96 with the committed
probe weights, four full FaceNets, 128-frame blocks) on an in-memory
synthetic film, and compares a card run with a CPU run of the same
path.  Any failed check raises, so the script exits non-zero; it also
exits non-zero without a card.  It prints JSON lines; the one before
the last lists the kernels, the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from facerec_torch.config import FACENET_DIMS, ExtractConfig
from facerec_torch.models.detector import DetectorHarness, fit_input_size
from facerec_torch.ops import _build
from facerec_torch.ops import equalize as eqm
from facerec_torch.ops import scene as scene_ops
from facerec_torch.pipeline.extract import EmbedderBank, run_extract
from facerec_torch.runtime.device import resolve_device
from facerec_torch.track import TrackerConfig, init_tracker, run_block
from facerec_torch.video.synth import ScriptedDetector, make_frames

REPO = os.path.dirname(os.path.abspath(__file__))
PROBE = os.path.join(REPO, "tests", "data", "probe_detector_w96.npz")
EQ_SOURCE = "facerec_torch/csrc/equalize.cu"
EQ_TPU = "facerec_tpu/ops/pallas/equalize.py"
MAIN_BLOCK = (128, 384, 768)        # the main path's plane: 576x768 cropped
MAIN_FRAMES = (128, 576, 768)       # the main path's block of RGB frames
# further frames for the RGB entry point, (B, H, W) and whether to crop:
# 1080p, 4K, 6 padding rows, and ragged widths (3W % 16 != 0) with 7
# and 6 padding rows
RGB_SHAPES = [((8, 1080, 1920), True), ((2, 2160, 3840), True),
              ((2, 90, 192), False), ((3, 41, 130), False),
              ((2, 90, 200), False)]

# Device-memory rate by card, bytes/s (NVIDIA data sheets); the bound of
# a memory-bound kernel is its bytes over this rate.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
MEM_RATE_DEFAULT = 3.35e12          # H100 SXM


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return MEM_RATE_DEFAULT


def time_ms(fn, reps: int = 10, trials: int = 5, warmup: int = 3) -> float:
    """Device ms of one ``fn()``: CUDA events around ``reps`` calls back
    to back, so that the host's work for one call overlaps the card's
    work for the one before; the median over ``trials`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def device_profile(fn):
    """(device activities, their summed device ms) of one ``fn()`` under
    torch.profiler: kernels, copies and memsets on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3


def make_plane(shape, real_rows, seed, dev):
    """Luminance of random uint8 RGB, with 1/16 of the pixels replaced by
    exact integers and values at and past the top bin, rows padded with
    -1 from ``real_rows`` on."""
    b, r, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rgb = torch.randint(0, 256, (b, real_rows, w, 3), generator=g,
                        device=dev, dtype=torch.uint8)
    y = scene_ops.luminance(rgb)
    pick = torch.rand(y.shape, generator=g, device=dev) < 1 / 16
    ints = torch.randint(0, 258, y.shape, generator=g, device=dev).float()
    y = torch.where(pick, ints, y)
    y[:, 0, :4] = torch.tensor([0.0, 255.0, 255.5, 300.0], device=dev)
    out = torch.full(shape, -1.0, device=dev)
    out[:, :real_rows] = y
    return out.contiguous()


def phase_kernels(dev, rate):
    """Phase 2: each kernel against its plain version, bit for bit."""
    shapes = [(MAIN_BLOCK, 384), ((8, 960, 1920), 960),
              ((2, 1920, 3840), 1920), ((3, 48, 130), 41)]
    rows = []
    for i, (shape, real) in enumerate(shapes):
        y = make_plane(shape, real, seed=i, dev=dev)
        hist = eqm.hist256(y)
        eq, cum = eqm.cum_lookup(y, hist)
        hist_p = eqm.hist256_plain(y)
        eq_p, cum_p = eqm.cum_lookup_plain(y, hist_p)
        torch.cuda.synchronize()
        if not (torch.equal(hist, hist_p) and torch.equal(eq, eq_p)
                and torch.equal(cum, cum_p)):
            raise AssertionError(f"equalize kernels differ from the plain "
                                 f"version at {shape}")
        hist_err = float((hist - hist_p).abs().max())
        eq_err = max(float((eq - eq_p).abs().max()),
                     float((cum - cum_p).abs().max()))
        b, r, w = shape
        plane = b * r * w * 4
        idx = (eqm._bins(y) + torch.arange(b, device=dev)[:, None]
               * (eqm.BINS + 1)).reshape(-1)
        row = {
            "shape": list(shape), "real_rows": real, "equal": True,
            "hist256_max_abs_err": hist_err,
            "cum_lookup_max_abs_err": eq_err,
            "hist256_ms": time_ms(lambda: eqm.hist256(y)),
            "hist256_plain_ms": time_ms(lambda: eqm.hist256_plain(y)),
            "hist256_bound_ms": (plane + b * 1024) / rate * 1e3,
            "hist256_library_ms": time_ms(lambda: torch.bincount(
                idx, minlength=b * (eqm.BINS + 1))),
            "cum_lookup_ms": time_ms(lambda: eqm.cum_lookup(y, hist)),
            "cum_lookup_plain_ms": time_ms(
                lambda: eqm.cum_lookup_plain(y, hist)),
            "cum_lookup_bound_ms": (2 * plane + 2 * b * 1024) / rate * 1e3,
        }
        emit({"phase": "kernels", **row})
        rows.append(row)
    return rows


def skewed_planes(dev, shape=MAIN_BLOCK, seed=7):
    """Planes whose histograms are not flat, as films have them: a
    black frame (all bin 0), a white flash (all bin 255) and a dark
    scene (values in [0, 8))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "bin0": torch.zeros(shape, device=dev),
        "bin255": torch.full(shape, 255.0, device=dev),
        "dark": torch.rand(shape, generator=g, device=dev) * 8.0,
    }


def phase_skewed(dev, rate):
    """Phase 2, skewed planes at the main block: each kernel equal to
    its plain version and timed, to hold against the uniform plane."""
    rows = []
    for kind, y in skewed_planes(dev).items():
        hist = eqm.hist256(y)
        eq, cum = eqm.cum_lookup(y, hist)
        hist_p = eqm.hist256_plain(y)
        eq_p, cum_p = eqm.cum_lookup_plain(y, hist_p)
        torch.cuda.synchronize()
        if not (torch.equal(hist, hist_p) and torch.equal(eq, eq_p)
                and torch.equal(cum, cum_p)):
            raise AssertionError(f"equalize kernels differ from the plain "
                                 f"version on the {kind} plane")
        plane = y.numel() * 4
        row = {"plane": kind, "shape": list(y.shape), "equal": True,
               "hist256_ms": time_ms(lambda: eqm.hist256(y)),
               "hist256_bound_ms": (plane + y.shape[0] * 1024) / rate * 1e3,
               "cum_lookup_ms": time_ms(lambda: eqm.cum_lookup(y, hist)),
               "cum_lookup_bound_ms":
                   (2 * plane + 2 * y.shape[0] * 1024) / rate * 1e3}
        emit({"phase": "kernels_skewed", **row})
        rows.append(row)
    return rows


def make_rgb(kind, shape, dev, seed=11):
    """(B, H, W, 3) uint8 frames: noise, black, white, or a dark scene
    (every channel in [0, 8))."""
    size = (*shape, 3)
    if kind == "black":
        return torch.zeros(size, dtype=torch.uint8, device=dev)
    if kind == "white":
        return torch.full(size, 255, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 8 if kind == "dark" else 256, size, generator=g,
                         device=dev, dtype=torch.uint8)


def all_triples(dev):
    """One (1, 4096, 4096, 3) frame holding every uint8 RGB triple."""
    i = torch.arange(1 << 24, device=dev, dtype=torch.int32)
    rgb = torch.stack([i >> 16, (i >> 8) & 255, i & 255], dim=-1)
    return rgb.to(torch.uint8).reshape(1, 4096, 4096, 3)


def check_rgb(frames, lo, hi, gray, what):
    """Both entry points of hist256 and cum_lookup against the plain
    versions on the same frames, bit for bit; ``y`` against
    luminance()."""
    y, hist = eqm.hist256_rgb(frames, lo, hi, gray)
    y_p, hist_p = eqm.hist256_rgb_plain(frames, lo, hi, gray)
    hist_f = eqm.hist256(y_p)
    eq, cum = eqm.cum_lookup(y, hist)
    eq_p, cum_p = eqm.cum_lookup_plain(y_p, hist_p)
    torch.cuda.synchronize()
    pairs = {"y": (y, y_p), "hist": (hist, hist_p),
             "hist (plane entry)": (hist_f, hist_p), "eq": (eq, eq_p),
             "cum": (cum, cum_p)}
    bad = [k for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"{bad} differ from the plain version on "
                             f"{what}")


def phase_rgb(dev, rate):
    """Phase 2, the RGB entry point: the main path's frames (noise,
    black, white, dark, grayscale) timed, then 1080p, 4K, a ragged
    width, grayscale, and every RGB triple checked."""
    b, h, w = MAIN_FRAMES
    lo, hi = scene_ops.crop_bounds(h, w, True)
    r = eqm.packed_rows(hi - lo)
    bound = (3 * b * (hi - lo) * w + 4 * b * r * w + 1024 * b) / rate * 1e3
    rows = []
    for kind, gray in (("noisy", False), ("black", False), ("white", False),
                       ("dark", False), ("noisy", True)):
        frames = make_rgb(kind, MAIN_FRAMES, dev)
        check_rgb(frames, lo, hi, gray, f"{kind} frames")
        row = {"frames": kind, "grayscale": gray, "shape": list(frames.shape),
               "crop": [lo, hi], "equal": True,
               "hist256_rgb_ms": time_ms(
                   lambda: eqm.hist256_rgb(frames, lo, hi, gray)),
               "hist256_rgb_plain_ms": time_ms(
                   lambda: eqm.hist256_rgb_plain(frames, lo, hi, gray)),
               "hist256_rgb_bound_ms": bound}
        if not gray:
            y, hist = eqm.hist256_rgb(frames, lo, hi)
            row["cum_lookup_ms"] = time_ms(lambda: eqm.cum_lookup(y, hist))
        emit({"phase": "kernels_rgb", **row})
        rows.append(row)
        del frames
    for shape, crop in RGB_SHAPES:
        frames = make_rgb("noisy", shape, dev)
        c_lo, c_hi = scene_ops.crop_bounds(shape[1], shape[2], crop)
        for gray in (False, True):
            check_rgb(frames, c_lo, c_hi, gray, f"{shape} gray={gray}")
        emit({"phase": "kernels_rgb", "shape": list(frames.shape),
              "crop": [c_lo, c_hi], "equal": True})
    frames = all_triples(dev)
    n = frames.shape[1]
    check_rgb(frames, 0, n, False, "all 2^24 RGB triples")
    if not torch.equal(eqm.hist256_rgb(frames, 0, n)[0],
                       eqm.luminance(frames)):
        raise AssertionError("y differs from luminance() on the RGB triples")
    emit({"phase": "kernels_rgb", "frames": "all 2^24 RGB triples",
          "shape": list(frames.shape), "y_equal_luminance": True})
    return rows


def check_features(path, dims):
    n = 0
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            emb = rec["embeddings"]
            if {k: len(v) for k, v in emb.items()} != dims:
                raise AssertionError(f"embedding dims {emb.keys()} wrong")
            for k, v in emb.items():
                norm = float(np.linalg.norm(np.asarray(v, np.float64)))
                if abs(norm - 1.0) > 1e-4:
                    raise AssertionError(f"{k} norm {norm}")
            n += 1
    return n


def phase_main_path(dev, out_root, h=576, w=768, n_frames=256,
                    cuts=(85, 170)):
    """Phase 3: the extract stage at full width on the card (a 576×768
    film, two 128-frame blocks)."""
    film = make_frames(n_frames, width=w, height=h, seed=0, cuts=cuts,
                       n_faces=2, identities=3, path="777-Smoke_Film.mp4")
    cfg = ExtractConfig(face_threshold=0.9, save_images=False, resume=False)
    detector = DetectorHarness.from_npz(
        PROBE, device=dev, input_size=fit_input_size(h, w, long_side=w),
        max_detections=cfg.max_detections,
        score_threshold=cfg.face_threshold, min_face_size=cfg.min_face_size)
    embedders = EmbedderBank.create_default(dev)
    torch.cuda.synchronize()

    for k in eqm.launches:
        eqm.launches[k] = 0
    t0 = time.perf_counter()
    counters = run_extract(film, cfg, out_root, detector=detector,
                           embedders=embedders, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(eqm.launches)

    n_blocks = -(-n_frames // cfg.block_frames)
    data = os.path.join(out_root, "777-data")
    rng = f"0-{n_frames}"
    with open(os.path.join(data, "scene_changes",
                           f"scene_changes_777_{rng}.json")) as f:
        found = json.load(f)["frame_indices"]
    if found != list(cuts):
        raise AssertionError(f"scene changes {found} != cuts {list(cuts)}")
    with open(os.path.join(data, "trajectories",
                           f"trajectories_777_{rng}.jsonl")) as f:
        n_traj = sum(1 for _ in f)
    if n_traj == 0 or counters.saved_trajectories == 0:
        raise AssertionError("no trajectories on the main path")
    n_feat = check_features(
        os.path.join(data, "features", f"features_777_{rng}.jsonl"),
        dict(FACENET_DIMS))
    if n_feat == 0:
        raise AssertionError("no feature records on the main path")
    if launches != {"hist256": n_blocks, "cum_lookup": n_blocks}:
        raise AssertionError(f"kernel launches {launches}, "
                             f"expected {n_blocks} each")
    with open(os.path.join(data, "run_report.json")) as f:
        report = json.load(f)[f"extract_{rng}"]

    # wall time per 128-frame block of each stage, synchronised around
    # each (this measurement only; the pipeline never synchronises)
    frames = torch.from_numpy(film.frames[:cfg.block_frames]).to(dev)
    tcfg = TrackerConfig(max_tracks=cfg.max_tracks,
                         max_detections=cfg.max_detections,
                         max_age=cfg.max_trajectory_age,
                         min_hits=cfg.min_trajectory,
                         iou_threshold=cfg.iou_threshold)
    per_block = max(1, counters.saved_boxes // n_blocks)
    n_crops = max(16, 1 << (per_block - 1).bit_length())   # pow-2 bucket
    boxes = np.tile(np.array([[300., 200., 344., 252.]], np.float32),
                    (n_crops, 1))
    fidx = np.arange(n_crops) % cfg.block_frames

    def wall_ms(fn):
        """Median of 3 synchronised wall times after one warm-up."""
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    with torch.inference_mode():
        state0 = scene_ops.initial_state(h, w, device=dev)
        stages = {
            "scene": lambda: scene_ops.detect_block(frames, state0),
            "detector": lambda: detector(frames),
        }
        flags, _ = stages["scene"]()
        det = stages["detector"]()
        stages["tracker"] = lambda: run_block(
            tcfg, init_tracker(tcfg, dev), det.boxes, det.valid, flags, 0)
        stages["crop_embed"] = lambda: embedders.dispatch_crop_embed(
            frames, fidx, boxes)
        block_ms, block_device = {}, {}
        for key, fn in stages.items():
            block_ms[key] = wall_ms(fn)
            n_dev, dev_ms = device_profile(fn)
            block_device[key] = {
                "device_activities": n_dev, "device_ms": dev_ms,
                "busy_share": dev_ms / block_ms[key]}
    block_ms["crop_embed_crops"] = n_crops
    result = {
        "phase": "main_path", "frames": n_frames, "blocks": n_blocks,
        "frame_size": [h, w], "wall_seconds": wall,
        "frames_per_second": n_frames / wall,
        "scene_changes": found, "trajectories": n_traj,
        "feature_records": n_feat, "launches": launches,
        "run_report_counters": report["counters"],
        "block_ms": block_ms, "block_device": block_device,
    }
    emit(result)
    return result


class StubBank(EmbedderBank):
    """Deterministic stand-in for the FaceNet bank: pooled crop pixels
    through a fixed random projection (the CPU tests' stub)."""

    def __init__(self):
        rng = np.random.default_rng(0)
        self.proj = {n: rng.normal(size=(75, 16)).astype(np.float32)
                     for n in ("m1", "m2")}

    def __call__(self, crops):
        x = crops.cpu().numpy().astype(np.float32)
        n = x.shape[0]
        flat = x.reshape(n, 5, 32, 5, 32, 3).mean(
            axis=(2, 4)).reshape(n, -1) / 255.0
        out = {}
        for name, p in self.proj.items():
            e = flat @ p
            e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)
            out[name] = e
        return out


def phase_card_vs_cpu(dev, out_root):
    """Phase 4: the same path on the card and on the CPU."""
    film = make_frames(64, width=384, height=288, seed=1, cuts=(30,),
                       path="778-Card_Cpu.mp4")
    cfg = ExtractConfig(block_frames=32, save_images=False, resume=False)
    outs = {}
    for d in (dev, torch.device("cpu")):
        root = os.path.join(out_root, d.type)
        run_extract(film, cfg, root, detector=ScriptedDetector(film),
                    embedders=StubBank(), device=d)
        outs[d.type] = os.path.join(root, "778-data")

    def read(kind):
        sub = os.path.join(outs["cuda"], kind)
        names = sorted(os.listdir(sub))
        return [(n, open(os.path.join(sub, n), "rb").read(),
                 open(os.path.join(outs["cpu"], kind, n), "rb").read())
                for n in names]

    for kind in ("trajectories", "scene_changes"):
        for name, a, b in read(kind):
            if a != b:
                raise AssertionError(f"{kind}/{name} differs card vs CPU")
    max_err, n = 0.0, 0
    for name, a, b in read("features"):
        la, lb = a.decode().splitlines(), b.decode().splitlines()
        if len(la) != len(lb):
            raise AssertionError(f"features/{name}: record counts differ")
        for ra, rb in zip(la, lb):
            ra, rb = json.loads(ra), json.loads(rb)
            ea, eb = ra.pop("embeddings"), rb.pop("embeddings")
            if ra != rb or list(ea) != list(eb):
                raise AssertionError(f"features/{name}: records differ")
            for k in ea:
                max_err = max(max_err, float(np.max(np.abs(
                    np.asarray(ea[k]) - np.asarray(eb[k])))))
            n += 1
    if n == 0 or max_err > 1e-5:
        raise AssertionError(f"features: {n} records, max err {max_err}")
    result = {"phase": "card_vs_cpu", "feature_records": n,
              "embedding_max_abs_err": max_err,
              "trajectories_identical": True,
              "scene_changes_identical": True}
    emit(result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    rate = mem_rate(name)
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "built": sorted(built),
          "build_seconds": time.perf_counter() - t0,
          "mem_rate_bytes_per_s": rate})

    rows = phase_kernels(dev, rate)
    phase_skewed(dev, rate)
    rgb = phase_rgb(dev, rate)[0]        # noisy frames at the main input
    with tempfile.TemporaryDirectory() as tmp:
        main_path = phase_main_path(dev, os.path.join(tmp, "main"))
        phase_card_vs_cpu(dev, os.path.join(tmp, "cmp"))

    main_row = rows[0]          # the main path's (128, 384, 768) block
    kernels = []
    for kname, replaces, also in (
            ("hist256", f"{EQ_TPU}:200", f"{EQ_TPU}:177"),
            ("cum_lookup", f"{EQ_TPU}:219", f"{EQ_TPU}:177")):
        kernels.append({
            "name": kname, "route": "cuda", "source": EQ_SOURCE,
            "replaces": replaces, "also_replaces": also,
            "launches": main_path["launches"][kname],
            "max_abs_err": max(r[f"{kname}_max_abs_err"] for r in rows),
            "ms": main_row[f"{kname}_ms"],
            "plain_ms": main_row[f"{kname}_plain_ms"],
            "bound_ms": main_row[f"{kname}_bound_ms"], "bound_by": "bytes",
            "library_ms": main_row.get(f"{kname}_library_ms"),
            "shape": main_row["shape"]})
    kernels[0].update({       # hist256's RGB entry point, the main path's
        "rgb_ms": rgb["hist256_rgb_ms"],
        "rgb_plain_ms": rgb["hist256_rgb_plain_ms"],
        "rgb_bound_ms": rgb["hist256_rgb_bound_ms"],
        "rgb_shape": rgb["shape"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
