"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``facerec_torch/csrc``, holds each
against its plain PyTorch version on the card, drives the extract
stage end to end at full model width (detector w96 with the committed
probe weights, four full FaceNets, 128-frame blocks) on an in-memory
synthetic film, then the whole orchestrated pipeline (extract → merge →
cluster → classify) on the same film, the multi-device paths on the
one card (``multi_device``: the mesh extract as two processes sharing
it, ``--mesh 1``, the sharded block step and the data-parallel training
steps over gloo and NCCL process groups, ``dryrun_multichip(2)``),
replays the probe-quality gates of ``tests/test_probe_quality.py``,
trains both models (one step card vs CPU, step times, then the
selfcheck at the JAX package's pinned probe budget with its gates),
times cluster and classify at the size a film gives them, and compares
a card run with a CPU run of the pipeline.  It also runs extract on
every wire format and fetch grouping (``wire``: byte-identical files,
the per-block wire costs), the QA and parity tools (``tools``), and a
10,000-frame soak (``soak``).  Any failed check raises, so the script
exits non-zero; it also exits non-zero without a card.  It prints JSON
lines; the one before the last lists the kernels, the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

from facerec_torch.config import (ACTOR_ID_PREFIX, EMB_NAME, FACENET_DIMS,
                                  ClassifyConfig, ClusterConfig,
                                  ExtractConfig, MergeConfig, PipelineConfig)
from facerec_torch.models.detector import DetectorHarness, fit_input_size
from facerec_torch.ops import _build
from facerec_torch.ops import equalize as eqm
from facerec_torch.ops import scene as scene_ops
from facerec_torch.pipeline.extract import EmbedderBank, run_extract
from facerec_torch.runtime.device import resolve_device
from facerec_torch.track import TrackerConfig, init_tracker, run_block
from facerec_torch.video.synth import (ScriptedDetector, make_frames,
                                       paint_frames)

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
    """(device activities, their summed device ms, wall ms) of one
    ``fn()`` under torch.profiler: kernels, copies and memsets on the
    card.  A window that comes back without device activities is
    measured once more: on an H100 with torch 2.11, a window that
    followed one of ~10^4 activities or more sometimes came back
    empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            break
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3, wall


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
    return max(float((a.double() - b.double()).abs().max())
               for a, b in (pairs["y"], pairs["hist"]))


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
        err = check_rgb(frames, lo, hi, gray, f"{kind} frames")
        row = {"frames": kind, "grayscale": gray, "shape": list(frames.shape),
               "crop": [lo, hi], "equal": True, "hist256_rgb_max_abs_err": err,
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


def smoke_film(n_frames=256, h=576, w=768, cuts=(85, 170)):
    """The in-memory film of phases 3 and 4, `wire` and `multi_device`:
    576×768, two 128-frame blocks, two cuts, 2 faces from 3 identities,
    painted block by block as it is read."""
    return paint_frames(n_frames, width=w, height=h, seed=0, cuts=cuts,
                        n_faces=2, identities=3, path="777-Smoke_Film.mp4")


def probe_detector(dev, height, width, cfg):
    """The committed probe detector (w96) at a film's native size, as
    extract's ``build_detector`` makes it from ``--detector-weights``."""
    return DetectorHarness.from_npz(
        PROBE, device=dev,
        input_size=fit_input_size(height, width,
                                  long_side=max(height, width)),
        max_detections=cfg.max_detections,
        score_threshold=cfg.face_threshold, min_face_size=cfg.min_face_size)


def full_width_models(dev, film, cfg):
    """The probe detector at the film's native size and the four full
    FaceNets, random from seeds 0..3."""
    return (probe_detector(dev, film.height, film.width, cfg),
            EmbedderBank.create_default(dev))


def reset_launches() -> None:
    for k in eqm.launches:
        eqm.launches[k] = 0


def path_launches(n_blocks: int) -> dict:
    """The launches a path over ``n_blocks`` frame blocks must count:
    the scene leg takes hist256's RGB entry, then cum_lookup, once per
    block; the plane entry never runs there."""
    return {"hist256": 0, "hist256_rgb": n_blocks, "cum_lookup": n_blocks}


def wall_ms(fn, runs: int = 3, device=None) -> float:
    """Median of ``runs`` synchronised wall times after one warm-up (on
    ``device``'s clock: the card's unless the CPU is given)."""
    sync = (lambda: None) if torch.device(device or "cuda").type == "cpu" \
        else torch.cuda.synchronize
    times = []
    for i in range(runs + 1):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def phase_main_path(dev, out_root, film):
    """Phase 3: the extract stage at full width on the card (a 576×768
    film, two 128-frame blocks)."""
    h, w, n_frames = film.height, film.width, film.n_frames
    cuts = film.scene_cuts
    cfg = ExtractConfig(face_threshold=0.9, save_images=False, resume=False)
    detector, embedders = full_width_models(dev, film, cfg)
    torch.cuda.synchronize()

    reset_launches()
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
    if launches != path_launches(n_blocks):
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{path_launches(n_blocks)}")
    with open(os.path.join(data, "run_report.json")) as f:
        report = json.load(f)[f"extract_{rng}"]

    # wall time per 128-frame block of each stage, synchronised around
    # each (this measurement only; the pipeline never synchronises)
    frames = torch.from_numpy(
        film.frames[:min(cfg.block_frames, n_frames)]).to(dev)
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
            n_dev, dev_ms, _ = device_profile(fn)
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
    result["features_path"] = os.path.join(data, "features",
                                           f"features_777_{rng}.jsonl")
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


def compare_card_cpu(roots):
    """Trajectories and scene changes of a card run and a CPU run
    identical, feature records identical but for the embeddings (within
    1e-5); returns (records, max embedding error)."""
    def read(kind):
        sub = os.path.join(roots["card"], kind)
        return [(n, open(os.path.join(sub, n), "rb").read(),
                 open(os.path.join(roots["cpu"], kind, n), "rb").read())
                for n in sorted(os.listdir(sub))]

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
    return n, max_err


def phase_card_vs_cpu(dev, out_root):
    """Phase 4: extract → merge → cluster → classify on the card and on
    the CPU; every file identical, the embeddings within 1e-5.  Extract
    also on the yuv420-delta wire, card against CPU alike."""
    film = make_frames(64, width=384, height=288, seed=1, cuts=(30,),
                       path="778-Card_Cpu.mp4")
    cfg = ExtractConfig(block_frames=32, save_images=False, resume=False)
    # imported here, as in the phases below, so that
    # scripts/equalize_ab.sh can load this file over an older package
    from facerec_torch.pipeline import classify as classify_mod
    from facerec_torch.pipeline import merge as merge_mod
    from facerec_torch.pipeline.cluster import run_cluster

    runs = {"card": dev, "cpu": torch.device("cpu")}
    outs, wire_errs = {}, {}
    for wire in ("rgb", "yuv420-delta"):
        roots = {}
        for label, d in runs.items():
            root = os.path.join(out_root, wire, label)
            run_extract(film, dataclasses.replace(cfg, wire_format=wire),
                        root, detector=ScriptedDetector(film),
                        embedders=StubBank(), device=d)
            roots[label] = os.path.join(root, "778-data")
        wire_errs[wire] = compare_card_cpu(roots)
        if wire == "rgb":
            outs = roots
    n, max_err = wire_errs["rgb"]

    # merge → cluster → classify on each device, one actor zip for both
    zpath = os.path.join(out_root, "actor-images.zip")
    for label, d in runs.items():
        data = outs[label]
        merge_mod.run_merge(data, 778, MergeConfig(min_face_size=20))
        if label == "card":
            write_actor_zip(zpath, os.path.join(data, "features.jsonl"), "m1")
        run_cluster(data, ClusterConfig(size=2, min_size=1, max_size=4,
                                        emb_name="m1"), d)
        emb, _ = classify_mod.read_actor_embeddings(zpath, "m1")
        ccfg = ClassifyConfig(k=3, emb_name="m1", min_samples=3)
        x, y = classify_mod.build_training_set(emb, ccfg.min_samples)
        classify_mod.run_classify(data, x, y, ccfg, d)
    for fname in ("trajectories.jsonl", "scene_changes.json",
                  "clusters.json", "predictions.json"):
        a, b = (open(os.path.join(outs[k], fname), "rb").read()
                for k in ("card", "cpu"))
        if a != b:
            raise AssertionError(f"{fname} differs card vs CPU")
    clusters = json.load(open(os.path.join(outs["card"], "clusters.json")))
    preds = json.load(open(os.path.join(outs["card"], "predictions.json")))
    if not preds["predictions"]:
        raise AssertionError("card_vs_cpu: no predictions")
    result = {"phase": "card_vs_cpu", "feature_records": n,
              "embedding_max_abs_err": max_err,
              "yuv420_delta": {"feature_records": wire_errs["yuv420-delta"][0],
                               "embedding_max_abs_err":
                                   wire_errs["yuv420-delta"][1],
                               "trajectories_identical": True,
                               "scene_changes_identical": True},
              "trajectories_identical": True,
              "scene_changes_identical": True,
              "merged_trajectories_identical": True,
              "clusters_identical": True, "predictions_identical": True,
              "clusters": len(set(clusters["clusters"])),
              "predictions": sum(len(v) for v in
                                 preds["predictions"].values())}
    emit(result)
    return result


def write_actor_zip(path, features_path, emb_name, n_actors=3, per=3):
    """A synthetic ``actor-images.zip``: ``n_actors`` actors placed near
    the run's own embeddings (the recipe of
    ``tests/test_extract_e2e.py:test_full_pipeline``)."""
    with open(features_path) as f:
        feats = [json.loads(line) for line in f]
    if not feats:
        raise AssertionError(f"no feature records in {features_path}")
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(path, "w") as z:
        for a in range(n_actors):
            base = np.array(feats[min(a, len(feats) - 1)]
                            ["embeddings"][emb_name])
            for i in range(per):
                vec = (base + rng.normal(size=base.size) * 0.01).tolist()
                z.writestr(f"a{a}_{i}.json", json.dumps({
                    "box": [0, 0, 1, 1], "embeddings": {emb_name: vec},
                    "actorID": str(500 + a), "actorname": f"A{a}"}))


def phase_pipeline(dev, out_root, film, features_path):
    """The orchestrated pipeline (extract → merge → cluster → classify)
    on the card at full width, on phase 3's film; the actor zip holds 3
    actors placed near phase 3's own EMB_NAME embeddings of that film."""
    from facerec_torch.pipeline.orchestrate import build_stages, run_pipeline

    ecfg = ExtractConfig(face_threshold=0.9, save_images=False, resume=False)
    pcfg = PipelineConfig(extract=ecfg, merge=MergeConfig(min_face_size=20))
    detector, embedders = full_width_models(dev, film, ecfg)
    actors_dir = os.path.join(out_root, "actors")
    os.makedirs(actors_dir)
    write_actor_zip(os.path.join(actors_dir, "actor-images.zip"),
                    features_path, EMB_NAME)
    stages = build_stages(film, out_root, pcfg, actors_dir=actors_dir,
                          device=dev, detector=detector, embedders=embedders)
    data = os.path.join(out_root, "777-data")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    ok = run_pipeline(stages, data_dir=data, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(eqm.launches)
    if not ok:
        raise AssertionError("the orchestrated pipeline failed (traceback "
                             "above)")

    n_blocks = -(-film.n_frames // ecfg.block_frames)
    for fname in ("trajectories.jsonl", "features.jsonl",
                  "scene_changes.json", "clusters.json", "predictions.json"):
        if not os.path.isfile(os.path.join(data, fname)):
            raise AssertionError(f"pipeline wrote no {fname}")
    with open(os.path.join(data, "scene_changes.json")) as f:
        cuts = json.load(f)["frame_indices"]
    if cuts != film.scene_cuts:
        raise AssertionError(f"scene changes {cuts} != {film.scene_cuts}")
    with open(os.path.join(data, "trajectories.jsonl")) as f:
        n_traj = sum(1 for _ in f)
    with open(os.path.join(data, "clusters.json")) as f:
        clusters = json.load(f)["clusters"]
    if n_traj == 0 or len(clusters) != n_traj:
        raise AssertionError(f"{len(clusters)} cluster labels for {n_traj} "
                             f"merged trajectories")
    with open(os.path.join(data, "predictions.json")) as f:
        preds = json.load(f)["predictions"]
    keys = [k for v in preds.values() for k in v]
    pattern = re.compile(re.escape(ACTOR_ID_PREFIX) + r"\d+$")
    if not keys or not all(pattern.match(k) for k in keys):
        raise AssertionError(f"predictions keyed {keys[:5]}")
    if launches != path_launches(n_blocks):
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{path_launches(n_blocks)}")
    with open(os.path.join(data, "run_report.json")) as f:
        report = json.load(f)
    result = {
        "phase": "pipeline", "frames": film.n_frames, "blocks": n_blocks,
        "wall_seconds": wall, "frames_per_second": film.n_frames / wall,
        "stage_seconds": report["pipeline"]["counters"],
        "stage_wall_seconds": {k: v["wall_seconds"]
                               for k, v in report.items()},
        "scene_changes": cuts, "merged_trajectories": n_traj,
        "clusters": len(set(clusters)), "predictions": len(keys),
        "launches": launches,
        "counters": {k: report[k]["counters"]
                     for k in ("merge", "cluster", "classify")},
    }
    emit(result)
    return result


def phase_probe_quality(dev, out_root):
    """The replay of tests/test_probe_quality.py on the card at its
    pinned budget (384×288, 180 frames, cuts at 60 and 120, detector
    input 384²), on the painted frames (no mp4 decode on this host)."""
    from facerec_torch.pipeline import merge as merge_mod
    from facerec_torch.tools.selfcheck import score_detections

    film = make_frames(180, width=384, height=288, seed=0, cuts=(60, 120),
                       n_faces=2, identities=3, path="777-Probe_Film.mp4")
    harness = DetectorHarness.from_npz(
        PROBE, device=dev, input_size=(384, 384), max_detections=16,
        score_threshold=0.9, min_face_size=20)
    run_extract(film, ExtractConfig(face_threshold=0.9, resume=False,
                                    save_images=False),
                out_root, detector=harness, embedders=StubBank(), device=dev)
    merge_mod.main(["--path", os.path.join(out_root, "*-data"),
                    "--min-face-size", "20"])
    data = os.path.join(out_root, "777-data")
    det = score_detections(data, film.truth)
    with open(os.path.join(data, "scene_changes.json")) as f:
        cuts = json.load(f)["frame_indices"]
    result = {"phase": "probe_quality", **det, "scene_changes": cuts,
              "truth_cuts": film.scene_cuts,
              "gates": {"precision": 0.9, "recall": 0.8}}
    emit(result)
    if det["precision"] < 0.9 or det["recall"] < 0.8:
        raise AssertionError(f"probe gates missed: {det}")
    if cuts != film.scene_cuts:
        raise AssertionError(f"probe cuts {cuts} != {film.scene_cuts}")
    return result


# card vs CPU, one training step (phase `train`)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-3        # max |Δg| over the leaf's max |g|
STEP_GRAD_L2 = 1e-6         # ‖Δg‖ over ‖g‖, all leaves as one vector
# The batch statistics, unwound from each BatchNorm's running ones as
# (ra₁ − m·ra₀)/(1 − m), max |Δ| over max(1, the leaf's max |stat|).  In
# float32 the unwinding alone costs up to 1/(1 − m) = 200 half-ulps of
# ra₁ ≈ 1 on each device (≈ 1.2e-5 apart; an H100 against the CPU read
# 1.2e-5 to 1.9e-5); a batch statistic off by 1e-2 reads 1e-2.
STEP_STATS_REL = {"float32": 1e-4, "float64": 1e-9}
# A leaf's max |g| is floored at this share of the model's largest |g|:
# FaceNet's last Block8 bias has a gradient that vanishes exactly (the
# train-mode bottleneck BN subtracts the batch mean of its shift), so
# both devices hold only rounding there.
STEP_GRAD_FLOOR = 1e-4
# Adam's first step is lr·g/(|g| + ε) ≈ lr·sign(g): updated parameters
# are compared where |g| ≥ 1e-2 of the leaf's max |g|.
STEP_UPDATE_G_SHARE = 1e-2
STEP_UPDATE_ATOL = 1e-6
# the JAX package's pinned probe budget (docs/DESIGN.md "Pinned CI quality
# budget") and the gates of tests/test_probe_quality.py and selfcheck
SELFCHECK_ARGS = ["--film-width", "384", "--film-height", "288",
                  "--detector-size", "384", "--identities", "3",
                  "--film-frames", "180"]
SELFCHECK_GATES = {"min_precision": 0.9, "min_recall": 0.8,
                   "min_purity": 0.8, "min_accuracy": 0.9}


def seeded_detector(width=96):
    from facerec_torch.models.detector import FaceDetector
    from facerec_torch.models.layers import init_weights

    model = FaceDetector(backbone_width=width)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def train_cases(size=384, batch=16, n_ids=4, per_id=4, width=96, seed=0):
    """name → (trainer factory on a device and an optional process
    group, one batch): the detector from ``synth_batch`` at ``size``²
    and the 128-d FaceNet on ``n_ids`` × ``per_id`` identity crops, both
    from seeded weights."""
    from facerec_torch.train import DetectorTrainer
    from facerec_torch.train.facenet_train import FaceNetTrainer
    from facerec_torch.video.synth import identity_crops, synth_batch

    rng = np.random.default_rng(seed)
    det = synth_batch(rng, batch, size, size, face_size=(28.0, 44.0))
    crops = np.concatenate([identity_crops(rng, a, per_id)
                            for a in range(n_ids)])
    labels = np.repeat(np.arange(n_ids, dtype=np.int32), per_id)
    return {
        "detector": (lambda d, group=None: DetectorTrainer(
            seeded_detector(width), (size, size), learning_rate=1e-3,
            device=d, group=group), det),
        "facenet": (lambda d, group=None: FaceNetTrainer(
            128, learning_rate=3e-4, seed=0, device=d, group=group),
            (crops, labels)),
    }


def step_state(make_trainer, batch, dev, dtype=torch.float32, tf32=False):
    """One step from the seeded initial state on ``dev``: (loss, grads,
    updated parameters, batch statistics), tensors as float64 on the
    host.  The batch statistics are unwound from each BatchNorm's
    running ones at its own momentum.  ``tf32`` lets cuDNN and cuBLAS
    round to TF32 for this step, the fault the float32 limits guard."""
    from facerec_torch.models.layers import BatchNorm
    from facerec_torch.runtime.device import use_full_float32

    trainer = make_trainer(dev)
    trainer.model.to(dtype)
    # a copy: on the CPU in float64 ``to`` would return the buffer itself
    host = lambda t: t.detach().to("cpu", torch.float64, copy=True)
    bns = {k: m for k, m in trainer.model.named_modules()
           if isinstance(m, BatchNorm)}
    ra0 = {(k, s): host(getattr(m, s)) for k, m in bns.items()
           for s in ("mean", "var")}
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        loss = float(trainer.step(*batch))
    finally:
        use_full_float32()
    named = list(trainer.model.named_parameters())
    stats = {f"{k}.{s}": (host(getattr(bns[k], s)) - bns[k].momentum * r)
             / (1 - bns[k].momentum) for (k, s), r in ra0.items()}
    return (loss, {k: host(p.grad) for k, p in named},
            {k: host(p) for k, p in named}, stats)


def compare_steps(got, want):
    """``got``'s step against ``want``'s: the loss's relative error; the
    worst leaf's max |Δg| over its max |g| (floored at STEP_GRAD_FLOOR
    of the largest |g|) and ‖Δg‖ / ‖g‖ over all leaves; the batch
    statistics' max |Δ| over max(1, the leaf's max |stat|); the updated
    parameters' max |Δ| where |g| ≥ STEP_UPDATE_G_SHARE of the leaf's
    max |g|."""
    loss, grads, params, stats = got
    w_loss, w_grads, w_params, w_stats = want
    top = max(float(g.abs().max()) for g in w_grads.values())
    rel, upd, n_upd, d2, g2 = {}, 0.0, 0, 0.0, 0.0
    for k, w in w_grads.items():
        scale = float(w.abs().max())
        diff = grads[k] - w
        rel[k] = float(diff.abs().max()) / max(scale, STEP_GRAD_FLOOR * top)
        d2 += float((diff * diff).sum())
        g2 += float((w * w).sum())
        big = w.abs() >= STEP_UPDATE_G_SHARE * scale
        if scale >= STEP_GRAD_FLOOR * top and big.any():
            upd = max(upd, float((params[k] - w_params[k])[big].abs().max()))
            n_upd += int(big.sum())
    worst = max(rel, key=rel.get)
    bstat = {k: float((stats[k] - s).abs().max())
             / max(1.0, float(s.abs().max())) for k, s in w_stats.items()}
    worst_stat = max(bstat, key=bstat.get)
    return {"loss": loss, "loss_rel_err": abs(loss - w_loss) / abs(w_loss),
            "grad_rel_err": rel[worst], "grad_worst_leaf": worst,
            "grad_l2_rel_err": (d2 / g2) ** 0.5, "leaves": len(rel),
            "batch_stats_err": bstat[worst_stat],
            "batch_stats_worst": worst_stat,
            "update_max_abs_err": upd, "updates_compared": n_upd}


# Float32 gradients at full width are bound by rounding on any one
# device: a float32 step on the CPU moves a leaf by up to 1.8e-2 of its
# max |g| (detector) and 1.0e-1 (FaceNet) from its float64 step, where
# pre-activations lie within rounding of a ReLU's kink, and moves the
# whole gradient by 8.8e-4 and 1.9e-3 of ‖g‖ (PERF.md §6).  So the card's float32
# gradients are held to the CPU's float64 ones within a factor of the
# CPU's own float32 spread (never below the float64 limits): 2× for
# the worst leaf, 5× for ‖Δg‖/‖g‖, where cuDNN's float32 algorithms
# round up to 2.5× more than the CPU's (FaceNet on an H100).  The
# float32 loss and batch statistics are held card vs CPU as in float64;
# float32 updates, where sign flips move Adam's first step by 2·lr, are
# reported.  A card step with TF32 on is the control: it must miss a
# float32 limit (on an H100 it read 7× and 17× the ‖Δg‖/‖g‖ limit,
# detector and FaceNet, while the detector's loss moved by 1.1e-7).
F32_SPREAD = {"grad_rel_err": (2.0, STEP_GRAD_REL),
              "grad_l2_rel_err": (5.0, STEP_GRAD_L2)}


def step_parity_row(name, make, batch, dev):
    """Card vs CPU, one step of one trainer in float32 and in float64,
    the card's float32 step (and the TF32 control) against the CPU's
    float64 one, and the CPU's float32 step against its float64 one
    (the rounding spread); returns (row, failed checks)."""
    cpu = torch.device("cpu")
    f32, f64 = torch.float32, torch.float64
    steps = {(where, dt): step_state(make, batch, d, dt)
             for dt in (f32, f64) for where, d in (("card", dev),
                                                   ("cpu", cpu))}
    steps["card_tf32", f32] = step_state(make, batch, dev, f32, tf32=True)
    ref = steps["cpu", f64]
    row = {"float32": compare_steps(steps["card", f32], steps["cpu", f32]),
           "float64": compare_steps(steps["card", f64], ref),
           "card_float32_vs_float64": compare_steps(steps["card", f32], ref),
           "cpu_float32_vs_float64": compare_steps(steps["cpu", f32], ref),
           "tf32_control_vs_float64": compare_steps(steps["card_tf32", f32],
                                                    ref)}
    spread = row["cpu_float32_vs_float64"]
    f32_limits = {k: max(factor * spread[k], floor)
                  for k, (factor, floor) in F32_SPREAD.items()}
    row["float32_limits"] = f32_limits
    held = [("float64", "loss_rel_err", STEP_LOSS_RTOL),
            ("float64", "batch_stats_err", STEP_STATS_REL["float64"]),
            ("float64", "grad_rel_err", STEP_GRAD_REL),
            ("float64", "grad_l2_rel_err", STEP_GRAD_L2),
            ("float64", "update_max_abs_err", STEP_UPDATE_ATOL),
            ("float32", "loss_rel_err", STEP_LOSS_RTOL),
            ("float32", "batch_stats_err", STEP_STATS_REL["float32"])]
    held += [("card_float32_vs_float64", k, v) for k, v in f32_limits.items()]
    failed = [f"{name} {r} {k} {row[r][k]} > {v}" for r, k, v in held
              if not row[r][k] <= v]
    if row["float64"]["updates_compared"] == 0:
        failed.append(f"{name}: no update compared")
    control = row["tf32_control_vs_float64"]
    row["tf32_control_caught"] = any(
        not control[k] <= v for k, v in f32_limits.items())
    if not row["tf32_control_caught"]:
        failed.append(f"{name}: a TF32 step passed the float32 limits")
    return row, failed


def step_parity(dev):
    """Card vs CPU, one step of each trainer at full width from one
    initial state on one batch."""
    out, failed = {}, []
    for name, (make, batch) in train_cases().items():
        out[name], bad = step_parity_row(name, make, batch, dev)
        failed += bad
    if failed:
        emit({"phase": "train", "step_parity": out})
        raise AssertionError(f"train steps: card and CPU differ: {failed}")
    return out


def train_timing(dev, batch=16):
    """ms per step (wall, device, busy share) of each trainer on a
    prepared batch, images per second and the peak of device memory;
    the detector also at the selfcheck's default 512² input.  Then the
    host's painting of one batch, and the detector's training loop as
    the selfcheck runs it (paint, then step) over 10 steps."""
    from facerec_torch.tools import selfcheck

    cases = train_cases()
    cases["detector_512"] = train_cases(size=512)["detector"]
    out = {}
    for name, (make, data) in cases.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = make(dev)
        row = timed(lambda: trainer.step(*data))
        row["images_per_second"] = len(data[0]) / row["wall_ms"] * 1e3
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        out[name] = row
        del trainer

    rng = np.random.default_rng(1)
    size, film_hw, faces = (384, 384), (288, 384), (28.0, 44.0)
    out["host_paint_ms"] = {
        "deploy_style_batch": 1e3 * float(np.median([_seconds(
            lambda: selfcheck.deploy_style_batch(rng, batch, size, film_hw,
                                                 faces)) for _ in range(5)])),
        "embedder_batch": 1e3 * float(np.median([_seconds(
            lambda: selfcheck.embedder_batch(rng, 3)) for _ in range(5)]))}
    make, _ = train_cases()["detector"]
    trainer = make(dev)
    content = selfcheck._content_hw(size, film_hw, batch)

    def loop(steps=10):
        for _ in range(steps):
            trainer.step(*selfcheck.deploy_style_batch(
                rng, batch, size, film_hw, faces), content_hw=content)
    out["detector_loop_10_steps"] = timed(loop)
    return out


def _seconds(fn):
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def phase_train(dev, out_root):
    """The trainers on the card at full width (detector w96, the full
    128-d FaceNet, float32 with TF32 off): card vs CPU on one step, the
    steps' times, then the JAX package's selfcheck at its pinned probe
    budget — 200 detector and 150 embedder steps from scratch,
    recalibration, extract → merge → cluster → classify on the card —
    held to the selfcheck's gates."""
    from facerec_torch.tools import selfcheck

    parity = step_parity(dev)
    timing = train_timing(dev)
    args = selfcheck.parse_args(["--out", out_root, "--device", "cuda",
                                 *SELFCHECK_ARGS])
    reset_launches()
    t0 = time.perf_counter()
    report = selfcheck.run(args)
    wall = time.perf_counter() - t0
    launches = dict(eqm.launches)
    failures = selfcheck.check_gates(report, **SELFCHECK_GATES)
    blocks = -(-args.film_frames // ExtractConfig().block_frames)
    result = {
        "phase": "train", "step_parity": parity, "timing": timing,
        "selfcheck": {k: v for k, v in report.items() if k != "predictions"},
        "selfcheck_seconds": wall, "gates": SELFCHECK_GATES,
        "gate_failures": failures, "launches": launches}
    emit(result)
    if failures:
        raise AssertionError(f"selfcheck gates missed: {failures}")
    if launches != path_launches(blocks):
        raise AssertionError(f"selfcheck kernel launches {launches}, "
                             f"expected {path_launches(blocks)}")
    return result


def identity_vectors(n, n_ids, rng, dim=128, spread=0.5):
    """``n`` unit vectors around ``n_ids`` seeded identities."""
    centers = rng.normal(size=(n_ids, dim))
    x = centers[rng.integers(0, n_ids, n)] + rng.normal(size=(n, dim)) * spread
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def timed(fn):
    """Wall ms (median of 3 after a warm-up); device activities, device
    ms and wall ms of one profiled run; the busy share, device ms over
    the median wall (the profiled run's own wall is no yardstick:
    torch.profiler adds host time to every launch)."""
    ms = wall_ms(fn)
    n_dev, dev_ms, prof_ms = device_profile(fn)
    return {"wall_ms": ms, "device_activities": n_dev, "device_ms": dev_ms,
            "profiled_wall_ms": prof_ms, "busy_share": dev_ms / ms}


def phase_downstream_scale(dev, sizes=(1000, 2000), n_queries=40_000,
                           n_actors=40):
    """Cluster and classify at the size a film gives them: N trajectory
    means from 60 identities, and a 100-minute film's face queries
    against 40 actors × 20 rows.  The card's distances are held to a
    float64 CPU computation (1e-3); its merge sequence and neighbours to
    the CPU loop and stable sort run on the card's own matrix."""
    from facerec_torch.ops import knn, linkage
    from facerec_torch.pipeline import classify as classify_mod
    from facerec_torch.pipeline.cluster import cluster_trajectories

    # the KNN first and the largest profile last: short windows right
    # after a profile of ~10^5 device activities came back empty
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(n_actors, 128))
    embeddings = []
    for a in range(n_actors):
        for _ in range(int(rng.integers(3, 15))):
            v = centers[a] + rng.normal(size=128) * 0.5
            embeddings.append((9000 + a, (v / np.linalg.norm(v)).tolist()))
    tx, ty = classify_mod.build_training_set(embeddings, 20)
    q = identity_vectors(n_queries, n_actors, rng)
    k = ClassifyConfig().k
    qd, txd = torch.from_numpy(q).to(dev), torch.from_numpy(tx).to(dev)
    d2 = knn.squared_distances(qd, txd)
    q64, t64 = q.astype(np.float64), tx.astype(np.float64)
    ref = (np.sum(q64 * q64, -1)[:, None] - 2 * q64 @ t64.T
           + np.sum(t64 * t64, -1)[None])
    err = float(np.max(np.abs(d2.cpu().numpy() - ref)))
    if err > 1e-3:
        raise AssertionError(f"KNN distances: max err {err}")
    nbr = knn.nearest(d2, k).cpu()
    if not torch.equal(nbr, knn.nearest(d2.cpu(), k)):
        raise AssertionError("KNN neighbours differ from the CPU stable "
                             "sort on the card's matrix")
    srt = torch.sort(d2, dim=1).values
    out = {"phase": "downstream_scale", "knn": {
        "queries": n_queries, "train_rows": len(tx), "classes": n_actors,
        "k": k, "dim": 128, "distance_max_abs_err": err,
        "neighbours_identical": True,
        "ties_at_kth": int((srt[:, k - 1] == srt[:, k]).sum()),
        "knn_predict_proba":
            timed(lambda: knn.knn_predict_proba(tx, ty, q, k, dev)),
        "distances": timed(lambda: knn.squared_distances(qd, txd)),
        "selection": timed(lambda: knn.nearest(d2, k)),
    }, "linkage": []}

    rng = np.random.default_rng(0)
    for n in sizes:
        x = identity_vectors(n, 60, rng)
        x64 = x.astype(np.float64)
        sq = np.sum(x64 * x64, -1)
        ref = np.sqrt(np.maximum(sq[:, None] - 2 * x64 @ x64.T + sq[None],
                                 0.0))
        xd = torch.from_numpy(x).to(dev)
        dist = linkage.pairwise_distances(xd)
        # off the diagonal; on it (never read by the merge loop) the
        # sqrt magnifies the rounding of |x|² − 2x·x + |x|² ≈ 0
        diff = np.abs(dist.cpu().numpy() - ref)
        diag = float(np.max(np.diag(diff)))
        np.fill_diagonal(diff, 0.0)
        err = float(np.max(diff))
        if err > 1e-3:
            raise AssertionError(f"distances at N={n}: max err {err}")
        merges = linkage.complete_linkage_merges(dist).cpu()
        t = time.perf_counter()
        cpu_merges = linkage.complete_linkage_merges(dist.cpu())
        cpu_s = time.perf_counter() - t
        if not torch.equal(merges, cpu_merges):
            raise AssertionError(f"merge sequence at N={n} differs from "
                                 f"the CPU loop on the card's matrix")
        row = {"n": n, "dim": x.shape[1], "distance_max_abs_err": err,
               "diagonal_max_abs_err": diag,
               "merges_identical": True, "cpu_loop_seconds": cpu_s}
        row["distances"] = timed(lambda: linkage.pairwise_distances(xd))
        row["merge_loop"] = timed(
            lambda: linkage.complete_linkage_merges(dist))
        row["merge_loop"]["activities_per_step"] = (
            row["merge_loop"]["device_activities"] / (n - 1))
        row["cluster_trajectories"] = timed(
            lambda: cluster_trajectories(x, 18, 12, 24, dev))
        out["linkage"].append(row)
    emit(out)
    return out


# the wire phase's runs: (name, wire format, fetch group)
WIRE_RUNS = [("rgb_g1", "rgb", 1), ("rgb_g4", "rgb", 4),
             ("rgb-delta_g4", "rgb-delta", 4),
             ("yuv420-delta_g1", "yuv420-delta", 1),
             ("yuv420-delta_g4", "yuv420-delta", 4)]


def read_outputs(root, movie, subs=("trajectories", "scene_changes",
                                    "features")):
    data = os.path.join(root, f"{movie}-data")
    return {sub: {n: open(os.path.join(data, sub, n), "rb").read()
                  for n in sorted(os.listdir(os.path.join(data, sub)))}
            for sub in subs}


def face_pairs(features):
    """(frame, box) of every feature record of a run."""
    (data,) = features.values()
    return [(r["frame"], r["box"])
            for r in map(json.loads, data.decode().splitlines())]


def host_ms(fn, runs: int = 3) -> float:
    """Median wall ms of a host function after one warm-up."""
    fn()
    return 1e3 * float(np.median([_seconds(fn) for _ in range(runs)]))


def wire_costs(dev, film, block_frames=128):
    """Per 128-frame block of each wire: the bytes that cross the link,
    the host encode (the reader's RGB → I420 for yuv420-delta, then the
    delta), the upload (pageable host memory) and the device decode."""
    from facerec_torch.ops import yuv

    h = film.height
    frames = np.ascontiguousarray(film.frames[:block_frames])
    i420 = yuv.rgb_to_i420(frames)
    out = {}
    for wire in ("rgb", "rgb-delta", "yuv420-delta"):
        src = i420 if wire == "yuv420-delta" else frames
        up = yuv.encode_delta(src) if wire != "rgb" else src
        row = {"bytes_per_block": int(up.nbytes),
               "encode_path": yuv.encode_path() if wire != "rgb" else None,
               "host_encode_ms": (host_ms(lambda: yuv.encode_delta(src))
                                  if wire != "rgb" else 0.0),
               "upload_ms": wall_ms(lambda: torch.from_numpy(up).to(dev))}
        if wire == "yuv420-delta":
            row["host_rgb_to_i420_ms"] = host_ms(
                lambda: yuv.rgb_to_i420(frames))
        dev_up = torch.from_numpy(up).to(dev)
        if wire == "rgb-delta":
            row["decode_device_ms"] = time_ms(
                lambda: yuv.delta_decode(dev_up), reps=3, trials=3)
        elif wire == "yuv420-delta":
            row["decode_device_ms"] = time_ms(
                lambda: yuv.delta_i420_to_rgb(dev_up, h), reps=3, trials=3)
            want = yuv.delta_i420_to_rgb(torch.from_numpy(up[:8]), h)
            got = yuv.delta_i420_to_rgb(dev_up[:8], h).cpu()
            if not torch.equal(got, want):
                raise AssertionError("delta_i420_to_rgb: card != CPU")
        else:
            row["decode_device_ms"] = 0.0
        out[wire] = row
    return out


def phase_wire(dev, out_root, film, card):
    """The wires and fetch groups at full width on phase 3's film (the
    probe detector, four FaceNets, 128-frame blocks): rgb g1/g4,
    rgb-delta g4, yuv420-delta g1/g4.  rgb g4 and rgb-delta g4 must
    equal rgb g1 byte for byte, yuv420-delta g4 its g1, with cuts
    exact; with a scripted detector yuv420-delta's trajectories and cuts
    equal rgb's and its features cover the same faces."""
    from facerec_torch.tools.embedding_eval import evaluate_embedding_parity
    from facerec_torch.tools.soak import StubBank as DeferredStub

    n_blocks = -(-film.n_frames // ExtractConfig.block_frames)
    detector, embedders = full_width_models(
        dev, film, ExtractConfig(face_threshold=0.9))
    runs, outs = {}, {}
    for name, wire, group in WIRE_RUNS:
        cfg = ExtractConfig(face_threshold=0.9, save_images=False,
                            resume=False, wire_format=wire,
                            fetch_every_blocks=group)
        root = os.path.join(out_root, name)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        run_extract(film, cfg, root, detector=detector, embedders=embedders,
                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(eqm.launches)
        if launches != path_launches(n_blocks):
            raise AssertionError(f"wire {name}: kernel launches {launches}")
        with open(os.path.join(root, "777-data", "run_report.json")) as f:
            rep = json.load(f)[f"extract_0-{film.n_frames}"]["counters"]
        outs[name] = read_outputs(root, 777)
        runs[name] = {
            "wire_format": rep["wire_format"], "fetch_group":
                rep["fetch_group"], "encode_path": rep["encode_path"],
            "wall_seconds": wall, "frames_per_second": film.n_frames / wall,
            "launches": launches,
            "per_block_ms": {k[:-len("_seconds")]: 1e3 * v / rep["blocks"]
                             for k, v in rep.items()
                             if k.endswith("_seconds")},
            "feature_records": len(face_pairs(outs[name]["features"]))}
    held = {"rgb_g4": "rgb_g1", "rgb-delta_g4": "rgb_g1",
            "yuv420-delta_g4": "yuv420-delta_g1"}
    for got, want in held.items():
        for sub, files in outs[want].items():
            if outs[got][sub] != files:
                raise AssertionError(f"wire {got} {sub} differ from {want}")
    (sc,) = outs["yuv420-delta_g1"]["scene_changes"].values()
    if json.loads(sc)["frame_indices"] != list(film.scene_cuts):
        raise AssertionError(f"yuv420-delta cuts {sc}")
    if not face_pairs(outs["rgb_g1"]["features"]):
        raise AssertionError("wire: no feature records")
    parity = evaluate_embedding_parity(
        *(os.path.join(out_root, k, "777-data", "features",
                       f"features_777_0-{film.n_frames}.jsonl")
          for k in ("rgb_g1", "yuv420-delta_g1")), max_p95=1.0)
    emb = {k: {"n": v.get("n"), "p95_cos_dist": v.get("p95_cos_dist"),
               "max_cos_dist": v.get("max_cos_dist")}
           for k, v in parity["checkpoints"].items()}

    scripted = {}
    for wire in ("rgb", "yuv420-delta"):
        root = os.path.join(out_root, f"scripted_{wire}")
        run_extract(film, ExtractConfig(save_images=False, resume=False,
                                        wire_format=wire), root,
                    detector=ScriptedDetector(film),
                    embedders=DeferredStub(device=dev), device=dev)
        scripted[wire] = read_outputs(root, 777)
    for sub in ("trajectories", "scene_changes"):
        if scripted["rgb"][sub] != scripted["yuv420-delta"][sub]:
            raise AssertionError(f"scripted yuv420-delta {sub} != rgb")
    pairs = [face_pairs(scripted[w]["features"])
             for w in ("rgb", "yuv420-delta")]
    if not pairs[0] or pairs[0] != pairs[1]:
        raise AssertionError("scripted yuv420-delta features cover other "
                             "faces than rgb")
    result = {"phase": "wire", "card": card, "frames": film.n_frames,
              "blocks": n_blocks, "runs": runs,
              "identical": {f"{a}=={b}": True for a, b in held.items()},
              "yuv420_delta_cuts": film.scene_cuts,
              "embedding_eval_rgb_vs_yuv420_delta": {
                  "match_rate": parity["match_rate"],
                  "n_matched": parity["n_matched"], "checkpoints": emb},
              "scripted_yuv420_delta_equals_rgb": True,
              "scripted_face_pairs": len(pairs[0]),
              "per_block": wire_costs(dev, film)}
    emit(result)
    return result


BOX_ATOL = 1e-4     # tracker boxes (tests/test_torch_tracker_block.py)
DP_TOL = 1e-6        # data-parallel float64 step vs the global batch's
INT_EMIT = ("emit", "detected", "uid", "first_frame", "det_slot", "overflow")


def multi_rank(rank, device, film, n, train_kw):
    """One rank of the `multi_device` phase's process groups: this
    rank's share of the sharded step on the film's first block, then one
    float64 data-parallel step of each trainer on its shard of
    ``train_cases(**train_kw)``' batch, then the float32 ms per step.
    Host values only (a result is pickled to the parent)."""
    import torch.distributed as dist

    from facerec_torch.parallel.extract_sharded import sharded_extract_step

    cfg = ExtractConfig(face_threshold=0.9)
    block = min(cfg.block_frames, film.n_frames)
    local = block // n
    frames = torch.from_numpy(film.frames[rank * local:(rank + 1) * local])
    detector = probe_detector(device, film.height, film.width, cfg)
    tcfg = tracker_config(cfg)
    reset_launches()
    with torch.inference_mode():
        out = sharded_extract_step(detector, tcfg, frames.to(device))
    launches = dict(eqm.launches)
    host = lambda t: t.cpu().numpy()
    sharded = {"flags": host(out.flags), "valid": host(out.detections.valid),
               "boxes": host(out.detections.boxes),
               "box": host(out.emit.box), "launches": launches,
               **{k: host(getattr(out.emit, k)) for k in INT_EMIT}}
    dp, f32_ms = {}, {}
    world = dist.group.WORLD
    for name, (make, batch) in train_cases(**train_kw).items():
        shard = len(batch[0]) // n
        mine = [a[rank * shard:(rank + 1) * shard] for a in batch]
        got = step_state(lambda d: make(d, world), mine, device,
                         torch.float64)
        dp[name] = tuple(to_numpy(x) for x in got)
        trainer = make(device, world)
        f32_ms[name] = wall_ms(lambda: trainer.step(*mine), device=device)
        dp[name] += (trainer.replicas_identical(),)
    return {"sharded": sharded, "dp": dp, "f32_ms_per_step": f32_ms}


def to_numpy(x):
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else x


def tracker_config(cfg):
    return TrackerConfig(max_tracks=cfg.max_tracks,
                         max_detections=cfg.max_detections,
                         max_age=cfg.max_trajectory_age,
                         min_hits=cfg.min_trajectory,
                         iou_threshold=cfg.iou_threshold)


def check_sharded(ranks, flags, dets, dev, tcfg):
    """The ranks' sharded step against the serial block step on the
    card: flags exact, each rank's detections equal to the detector's on
    the same frames (the same batch shape: cuDNN picks its algorithms by
    shape), the tracker's integer emissions exact and its boxes within
    BOX_ATOL, uids in each rank's namespace."""
    from facerec_torch.parallel.extract_sharded import UID_STRIDE

    n = len(ranks)
    local = len(flags) // n
    got = np.concatenate([r["flags"] for r in ranks])
    if not np.array_equal(got, flags.cpu().numpy()):
        raise AssertionError(f"sharded n={n}: flags differ from serial")
    emit_err = 0.0
    with torch.inference_mode():
        for rank, (r, det) in enumerate(zip(ranks, dets)):
            if not (np.array_equal(r["valid"], det.valid.cpu().numpy())
                    and np.array_equal(r["boxes"], det.boxes.cpu().numpy())):
                raise AssertionError(f"sharded n={n} rank {rank}: "
                                     f"detections differ")
            sl = slice(rank * local, (rank + 1) * local)
            state = init_tracker(tcfg, dev)._replace(next_uid=torch.tensor(
                rank * UID_STRIDE, dtype=torch.int32, device=dev))
            _, want = run_block(tcfg, state, det.boxes, det.valid,
                                flags[sl], rank * local)
            for k in INT_EMIT:
                if not np.array_equal(r[k], getattr(want, k).cpu().numpy()):
                    raise AssertionError(f"sharded n={n} rank {rank}: {k}")
            emit_err = max(emit_err, float(np.abs(
                r["box"] - want.box.cpu().numpy()).max()))
            uids = r["uid"][r["emit"]]
            if (uids // UID_STRIDE != rank).any():
                raise AssertionError(f"sharded n={n}: uids {uids}")
    if emit_err > BOX_ATOL:
        raise AssertionError(f"sharded n={n}: tracker boxes {emit_err}")
    return {"ranks": n, "flags": int(got.sum()),
            "detections": int(sum(r["valid"].sum() for r in ranks)),
            "detections_equal": True, "tracker_box_max_abs_err": emit_err,
            "emitted": int(sum(r["emit"].sum() for r in ranks)),
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in eqm.launches}}


def check_dp(ranks, want):
    """The ranks' float64 data-parallel steps against one process's
    step on the global batch: loss, gradients, batch statistics and
    updates within DP_TOL; the ranks' replicas identical."""
    out = {}
    for name, ref in want.items():
        rows = [compare_steps(
            tuple(torch.from_numpy(v) if isinstance(v, np.ndarray) else
                  ({k: torch.from_numpy(a) for k, a in v.items()}
                   if isinstance(v, dict) else v)
                  for v in r["dp"][name][:4]), ref) for r in ranks]
        worst = {k: max(row[k] for row in rows) for k in (
            "loss_rel_err", "grad_rel_err", "grad_l2_rel_err",
            "batch_stats_err", "update_max_abs_err")}
        bad = {k: v for k, v in worst.items() if not v <= DP_TOL}
        if bad or not all(r["dp"][name][4] for r in ranks):
            raise AssertionError(f"data-parallel {name} n={len(ranks)}: "
                                 f"{bad}, replicas identical "
                                 f"{[r['dp'][name][4] for r in ranks]}")
        out[name] = {**worst, "replicas_identical": True,
                     "updates_compared": rows[0]["updates_compared"],
                     "f32_ms_per_step_per_rank": [
                         r["f32_ms_per_step"][name] for r in ranks]}
    return out


def phase_multi_device(dev, out_root, film, main_root, main_path, card,
                       groups=((2, "gloo"), (1, "nccl")), train_kw=None):
    """Multi-device paths on the one card: the mesh extract as 2 spans
    in 2 processes on it (files byte-identical to the serial
    ``--n-shards 2`` loop on the card, merged equal to phase 3's, cuts
    exact, 2 kernel launches per block per span), ``--mesh 1``, the
    sharded step at n = 2 (gloo, both ranks on the card) and n = 1
    (NCCL) against the serial block step, the data-parallel float64
    steps of both trainers at n = 2 (gloo) and n = 1 (NCCL) against one
    process on the global batch, and ``dryrun_multichip(2)``.
    ``train_kw`` sizes the training batches (``train_cases``)."""
    from facerec_torch.parallel.dryrun import dryrun_multichip
    from facerec_torch.parallel.extract_mesh import (plan_spans,
                                                     run_extract_mesh)
    from facerec_torch.parallel.mesh import mesh_devices, run_ranks
    from facerec_torch.pipeline.merge import run_merge

    cfg = ExtractConfig(face_threshold=0.9, save_images=False, resume=False)
    n_frames = film.n_frames
    train_kw = train_kw or {}
    # the worker processes share the card: hand them the memory that
    # this process's allocator still caches from the earlier phases
    torch.cuda.empty_cache()
    blocks = lambda n: -(-n // cfg.block_frames)
    span_blocks = [blocks(stop - beg) for beg, _, stop in
                   plan_spans(n_frames, 2, cfg.max_trajectory_age)]
    result = {"phase": "multi_device", "card": card}

    # the serial --n-shards 2 loop on the card, then the mesh
    detector, embedders = full_width_models(dev, film, cfg)
    serial = os.path.join(out_root, "serial")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2):
        run_extract(film, dataclasses.replace(cfg, n_shards=2, shard_i=i),
                    serial, detector=detector, embedders=embedders,
                    device=dev)
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    del detector, embedders
    torch.cuda.empty_cache()
    with open(os.path.join(serial, "777-data", "run_report.json")) as f:
        rep = json.load(f)
    serial_loop = sum(v for r in rep.values()
                      for k, v in r["counters"].items()
                      if k.endswith("_seconds"))

    mesh = os.path.join(out_root, "mesh")
    reset_launches()
    t0 = time.perf_counter()
    counters = run_extract_mesh(film, cfg, mesh, devices=[dev, dev],
                                detector_weights=PROBE)
    mesh_wall = time.perf_counter() - t0
    launches = dict(eqm.launches)
    with open(os.path.join(mesh, "777-data", "run_report.json")) as f:
        rep = json.load(f)["extract_mesh_2"]["counters"]
    if len(counters) != 2 or rep["steps"] != sum(span_blocks):
        raise AssertionError(f"mesh: {len(counters)} spans, "
                             f"{rep['steps']} block steps, not 2 and "
                             f"{span_blocks}")
    if launches != path_launches(sum(span_blocks)):
        raise AssertionError(f"mesh kernel launches {launches}")
    if read_outputs(mesh, 777) != read_outputs(serial, 777):
        raise AssertionError("mesh shard files differ from the serial "
                             "--n-shards 2 loop's")
    merged = {}
    for label, root in (("mesh", mesh), ("main", main_root)):
        data = os.path.join(root, "777-data")
        run_merge(data, 777, MergeConfig(min_face_size=20))
        with open(os.path.join(data, "trajectories.jsonl")) as f:
            trajs = sorted(map(json.loads, f),
                           key=lambda t: (t["start"], t["len"]))
        with open(os.path.join(data, "scene_changes.json")) as f:
            merged[label] = (trajs, json.load(f)["frame_indices"])
    (got, cuts), (want, main_cuts) = merged["mesh"], merged["main"]
    if cuts != film.scene_cuts or main_cuts != cuts:
        raise AssertionError(f"merged cuts {cuts} / {main_cuts}")
    if [(t["start"], t["len"]) for t in got] != [
            (t["start"], t["len"]) for t in want]:
        raise AssertionError("merged mesh trajectories differ from phase 3's")
    bbs_err = max(float(np.abs(np.asarray(a["bbs"]) - np.asarray(b["bbs"]))
                        .max()) for a, b in zip(got, want))
    if bbs_err > 2:     # Kalman re-initialisation at the stitched span
        raise AssertionError(f"merged mesh boxes {bbs_err} px off")
    result["mesh"] = {
        "spans": 2, "devices": [str(dev)] * 2, "span_blocks": span_blocks,
        "launches": launches, "wall_seconds": mesh_wall,
        "frames_per_second": n_frames / mesh_wall,
        "span_loop_seconds": rep["span_loop_seconds"],
        "loop_frames_per_second": n_frames / max(rep["span_loop_seconds"]),
        "serial_n_shards_2_wall_seconds": serial_wall,
        "serial_n_shards_2_frames_per_second": n_frames / serial_wall,
        "serial_n_shards_2_loop_frames_per_second": n_frames / serial_loop,
        "unsharded_frames_per_second": main_path["frames_per_second"],
        "files_identical_to_serial": True, "merged_trajectories": len(got),
        "merged_bbs_max_abs_err_px": bbs_err, "cuts": cuts}

    # --mesh 1: the CLI's device-count rule, one span on the first card
    try:
        mesh_devices(2, "cuda")
        raise AssertionError("--mesh 2 ran on one card")
    except RuntimeError as e:
        if "needs 2 devices" not in str(e):
            raise
    one = os.path.join(out_root, "mesh1")
    reset_launches()
    run_extract_mesh(film, cfg, one, mesh_size=1, detector_weights=PROBE)
    mesh1_launches = dict(eqm.launches)
    if read_outputs(one, 777) != read_outputs(main_root, 777):
        raise AssertionError("--mesh 1 files differ from phase 3's")
    if mesh1_launches != path_launches(blocks(n_frames)):
        raise AssertionError(f"--mesh 1 launches {mesh1_launches}")
    result["mesh_1"] = {"files_identical_to_main_path": True,
                        "launches": mesh1_launches}

    # the sharded step and the data-parallel steps: 2 ranks sharing the
    # card over gloo, then 1 rank over NCCL
    tcfg = tracker_config(cfg)
    frames = torch.from_numpy(
        film.frames[:min(cfg.block_frames, n_frames)]).to(dev)
    det_model = probe_detector(dev, film.height, film.width, cfg)
    block = len(frames)
    with torch.inference_mode():
        flags, _ = scene_ops.detect_block(
            frames, scene_ops.initial_state(film.height, film.width,
                                            device=dev))
        # the detector on each rank's frames, per mesh size; and how far
        # the batch shape alone moves the boxes (cuDNN's algorithms)
        dets = {n: [det_model(part) for part in frames.split(block // n)]
                for n, _ in groups}
        whole = det_model(frames)
        halves = [det_model(part) for part in frames.split(block // 2)]
    diff = (whole.boxes - torch.cat([d.boxes for d in halves])).abs()
    spread = float(diff[whole.valid].max()) if whole.valid.any() else 0.0
    result["detector_batch_shape_box_spread_px"] = spread
    del frames, det_model, whole, halves
    want = {name: step_state(make, batch, dev, torch.float64)
            for name, (make, batch) in train_cases(**train_kw).items()}
    torch.cuda.empty_cache()
    light = dataclasses.replace(film, truth={}, truth_ids={})
    for n, backend in groups:
        ranks = run_ranks(multi_rank, [dev] * n,
                          args=(light, n, train_kw), backend=backend)
        sharded = check_sharded([r["sharded"] for r in ranks], flags,
                                dets[n], dev, tcfg)
        # one hist256_rgb and one cum_lookup per rank
        if sharded["launches"] != path_launches(n):
            raise AssertionError(f"sharded n={n} launches "
                                 f"{sharded['launches']}")
        result[f"sharded_n{n}_{backend}"] = sharded
        result[f"data_parallel_n{n}_{backend}"] = check_dp(ranks, want)

    t0 = time.perf_counter()
    dry = dryrun_multichip(2, devices=[dev, dev], backend="gloo")
    result["dryrun_multichip_2"] = {**dry, "seconds":
                                    time.perf_counter() - t0}
    emit(result)
    return result


def soak_child(out_root: str, n_frames: int) -> None:
    """The soak in a process of its own (started by :func:`phase_soak`,
    so that its RSS is the soak's and not the earlier phases'): set up
    the painted film (painted block by block as the loop reads it), run
    it, write the report with the scene kernels' launches to
    ``<out_root>/soak_child.json``."""
    from facerec_torch.tools.soak import run_soak, synth_film

    _build.build_all()
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    film = synth_film(out_root, n_frames, 256, 192, in_memory=True)
    paint = time.perf_counter() - t0
    reset_launches()
    report = run_soak(out_root, block_frames=128, checkpoint_every=16,
                      fetch_every=8, wire_format="yuv420-delta",
                      save_images=False, film=film, device=dev)
    report.update(launches=dict(eqm.launches), paint_setup_seconds=paint)
    with open(os.path.join(out_root, "soak_child.json"), "w") as f:
        json.dump(report, f)


def phase_soak(dev, out_root, card, n_frames=10_000):
    """The soak on the card, in a fresh process: a 256×192 film of
    ``n_frames`` painted in memory (the card's host has no codec),
    yuv420-delta, blocks of 128, fetch 8, checkpoint 16, the stub bank
    and the scripted detector, no images; its gates."""
    os.makedirs(out_root, exist_ok=True)
    code = f"import chip_smoke as c; c.soak_child({out_root!r}, {n_frames})"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"soak process failed:\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_root, "soak_child.json")) as f:
        report = json.load(f)
    result = {"phase": "soak", "card": card, **report}
    emit(result)
    if not report["pass"]:
        raise AssertionError(f"soak gates: {report['failures']}")
    if report["ckpt_samples"] < 2:
        raise AssertionError("soak: fewer than 2 checkpoint samples")
    if report["launches"] != path_launches(-(-n_frames // 128)):
        raise AssertionError(f"soak kernel launches {report['launches']}")
    return result


def phase_tools(dev, out_root, pipeline_data, probe, card):
    """The QA and parity tools on the card's host: detector_eval on the
    probe_quality film, the SVM card vs CPU, and subtitles, twins and
    boxdata on the pipeline phase's data dir."""
    import contextlib
    import hashlib
    import io

    from facerec_torch.ops.svm import decision_function, train_linear_svm
    from facerec_torch.tools import boxdata, subtitles, twins
    from facerec_torch.tools.detector_eval import (evaluate_detections,
                                                   harness_predictions)

    film = make_frames(180, width=384, height=288, seed=0, cuts=(60, 120),
                       n_faces=2, identities=3, path="777-Probe_Film.mp4")
    harness = DetectorHarness.from_npz(
        PROBE, device=dev, input_size=(384, 384), max_detections=16,
        score_threshold=0.9, min_face_size=20)
    t0 = time.perf_counter()
    preds = harness_predictions(harness, enumerate(film.frames))
    det_s = time.perf_counter() - t0
    truth = {f: [b.tolist() for b, _ in v] for f, v in film.truth.items()}
    det = evaluate_detections(preds, truth)

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(3, 8)) * 4
    x = np.concatenate([centers[i] + rng.normal(size=(30, 8)) * 0.3
                        for i in range(3)]).astype(np.float32)
    y = np.repeat([5, 9, 2], 30)
    fits = {d: train_linear_svm(x, y, device=d) for d in (dev, "cpu")}
    (w, b, cls), (w_c, b_c, cls_c) = fits[dev], fits["cpu"]
    labels = [cls[decision_function(x, ww, bb, device=d).argmax(1)]
              for (ww, bb, d) in ((w, b, dev), (w_c, b_c, "cpu"))]
    svm = {"w_max_abs_err": float(np.abs(w - w_c).max()),
           "b_max_abs_err": float(np.abs(b - b_c).max()),
           "labels_equal": bool(np.array_equal(*labels)),
           "accuracy": float((labels[0] == y).mean()),
           "card_ms": 1e3 * _seconds(lambda: train_linear_svm(x, y,
                                                              device=dev))}
    if (not np.array_equal(cls, cls_c) or not svm["labels_equal"]
            or svm["w_max_abs_err"] > 1e-6 or svm["b_max_abs_err"] > 1e-6):
        raise AssertionError(f"SVM card vs CPU: {svm}")

    # the ffprobe-style metadata and actors.csv the QA tools read
    os.makedirs(out_root, exist_ok=True)
    meta = os.path.join(out_root, "metadata.json")
    with open(meta, "w") as f:
        json.dump({"format": {"filename": "777-Smoke_Film.mp4"},
                   "streams": [{"codec_type": "video", "width": 768,
                                "height": 576, "sample_aspect_ratio": "1:1",
                                "avg_frame_rate": "25/1"}]}, f)
    actors = os.path.join(out_root, "actors.csv")
    with open(actors, "w") as f:
        f.write("id,name\n" + "".join(f"{500 + a},A{a}\n"
                                       for a in range(3)))
    ass = os.path.join(out_root, "film.ass")
    outputs = {}
    for name, fn in (
            ("subtitles", lambda: subtitles.main(
                ["--path", pipeline_data, "--metadata", meta,
                 "--actors-csv", actors, "--out", ass])),
            ("twins", lambda: twins.main(
                ["--path", pipeline_data, "--metadata", meta,
                 "--actors-csv", actors])),
            ("boxdata", lambda: boxdata.main(["--path", pipeline_data]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        text = (open(ass).read() if name == "subtitles" else buf.getvalue())
        outputs[name] = {"lines": len(text.splitlines()),
                         "sha256": hashlib.sha256(text.encode()).hexdigest()}
        if name != "twins" and not text.strip():
            raise AssertionError(f"{name} wrote nothing")
    result = {"phase": "tools", "card": card,
              "detector_eval": {k: det[k] for k in (
                  "n_pred", "n_truth", "precision", "recall",
                  "mean_matched_iou")},
              "detector_eval_seconds": det_s,
              "probe_quality": {k: probe.get(k) for k in (
                  "precision", "recall")},
              "svm_card_vs_cpu": svm, "qa_outputs": outputs}
    emit(result)
    # a sanity floor: raw per-frame detections, not the tracked and
    # merged faces that probe_quality scores
    if det["recall"] < 0.3 or det["precision"] < 0.5:
        raise AssertionError(f"detector_eval on the probe film: {det}")
    return result


def multi_launches(multi, kname):
    """A kernel's launches on the `multi_device` paths."""
    return {"mesh_launches": multi["mesh"]["launches"][kname],
            "mesh_1_launches": multi["mesh_1"]["launches"][kname],
            "sharded_launches": {
                k[len("sharded_"):]: v["launches"][kname]
                for k, v in multi.items() if k.startswith("sharded_")}}


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

    seconds = {}

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed_phase("kernels", phase_kernels, dev, rate)
    timed_phase("kernels_skewed", phase_skewed, dev, rate)
    rgb_rows = timed_phase("kernels_rgb", phase_rgb, dev, rate)
    with tempfile.TemporaryDirectory() as tmp:
        film = smoke_film()
        main_path = timed_phase("main_path", phase_main_path, dev,
                                os.path.join(tmp, "main"), film)
        wire = timed_phase("wire", phase_wire, dev,
                           os.path.join(tmp, "wire"), film, card)
        pipeline = timed_phase("pipeline", phase_pipeline, dev,
                               os.path.join(tmp, "pipeline"), film,
                               main_path["features_path"])
        multi = timed_phase("multi_device", phase_multi_device, dev,
                            os.path.join(tmp, "multi"), film,
                            os.path.join(tmp, "main"), main_path, card)
        del film
        probe = timed_phase("probe_quality", phase_probe_quality, dev,
                            os.path.join(tmp, "probe"))
        timed_phase("tools", phase_tools, dev, os.path.join(tmp, "tools"),
                    os.path.join(tmp, "pipeline", "777-data"), probe, card)
        train = timed_phase("train", phase_train, dev,
                            os.path.join(tmp, "train"))
        timed_phase("downstream_scale", phase_downstream_scale, dev)
        soak = timed_phase("soak", phase_soak, dev,
                           os.path.join(tmp, "soak"), card)
        timed_phase("card_vs_cpu", phase_card_vs_cpu, dev,
                    os.path.join(tmp, "cmp"))
    emit({"phase": "seconds", "card": card, **seconds,
          "total": time.perf_counter() - t0})

    main_row = rows[0]          # the main path's (128, 384, 768) block
    kernels = []
    # hist256's plane entry counts 0 on every path (path_launches)
    for kname, replaces, also in (
            ("hist256", f"{EQ_TPU}:200", f"{EQ_TPU}:177"),
            ("cum_lookup", f"{EQ_TPU}:219", f"{EQ_TPU}:177")):
        kernels.append({
            "name": kname, "route": "cuda", "source": EQ_SOURCE,
            "replaces": replaces, "also_replaces": also,
            "launches": main_path["launches"][kname],
            "pipeline_launches": pipeline["launches"][kname],
            "selfcheck_launches": train["launches"][kname],
            "wire_launches": {k: r["launches"][kname]
                              for k, r in wire["runs"].items()},
            "soak_launches": soak["launches"][kname],
            **multi_launches(multi, kname),
            "max_abs_err": max(r[f"{kname}_max_abs_err"] for r in rows),
            "ms": main_row[f"{kname}_ms"],
            "plain_ms": main_row[f"{kname}_plain_ms"],
            "bound_ms": main_row[f"{kname}_bound_ms"], "bound_by": "bytes",
            "library_ms": main_row.get(f"{kname}_library_ms"),
            "shape": main_row["shape"]})
    rgb = rgb_rows[0]           # noisy frames at the main input
    # the paths take hist256's RGB entry, counted under its own key
    kernels.insert(1, {
        "name": "hist256_rgb", "route": "cuda", "source": EQ_SOURCE,
        "replaces": f"{EQ_TPU}:200", "also_replaces": f"{EQ_TPU}:177",
        "launches": main_path["launches"]["hist256_rgb"],
        "pipeline_launches": pipeline["launches"]["hist256_rgb"],
        "selfcheck_launches": train["launches"]["hist256_rgb"],
        "wire_launches": {k: r["launches"]["hist256_rgb"]
                          for k, r in wire["runs"].items()},
        "soak_launches": soak["launches"]["hist256_rgb"],
        **multi_launches(multi, "hist256_rgb"),
        "max_abs_err": max(r["hist256_rgb_max_abs_err"] for r in rgb_rows),
        "ms": rgb["hist256_rgb_ms"], "plain_ms": rgb["hist256_rgb_plain_ms"],
        "bound_ms": rgb["hist256_rgb_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": rgb["shape"]})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
