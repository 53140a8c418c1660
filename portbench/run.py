"""The benchmark of the PyTorch/CUDA port: steady extract throughput of
``facerec_torch`` on an in-memory film.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up paints the cell's pool of frames from the seed, makes the
embedders' weights on the card, loads the detector checkpoint, runs the
crop+embed bank once on a full batch, and runs the extract stage once on
a short film: every shape the window uses, and one steady fetch group
whose rate sizes the window's film.  The window is one ``run_extract``
call over a film that loops over the pool, whole passes of it, sized to
last about ``--seconds``.  After it, the outputs are judged against the
plain reference (:mod:`portbench.compare`).  What the harness knows of
the embedders comes from the configuration's embedder family
(:mod:`portbench.embedders`).

``--trace 0`` prints the end-to-end metrics, ``--trace 1`` the
per-layer ones: the extract loop's from the window's own report, the
device's from a second, profiled extract after the window, read by the
readers in ``portbench/layer_metrics/``.  ``--control-blocks N`` runs
the control instead of the program: the reference on TF32 against the
reference in float32 over a film of N blocks, held to the cell's
limits.  The last line of standard output is the result's JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "facerec_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))
# the warm-up film: fetch groups and one block more.  Its rate is taken
# between the detector's calls on the first blocks of the last two
# groups: a steady cycle, which dispatches a group, consumes the one
# before and writes the embeddings of the one before that
WARM_GROUPS = 3
# the profiled extract: a group before, these groups profiled, a group after
PROFILED_GROUPS = 2
# the embedder families' files, <family>.py, and the family of a
# configuration that names none
FAMILIES = os.path.join(HERE, "embedders")
DEFAULT_FAMILY = "facenet"


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T0 = time.time()


def log(*args) -> None:
    """A line on standard error, stamped with the seconds since the
    harness was loaded."""
    print(f"[{time.time() - T0:8.2f}]", *args, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def card_line(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = "nvidia-smi unavailable"
    return line


def read_program(root: str, n_frames: int, kept, names):
    """The program's outputs from its contract files, as the
    reference's :class:`Outputs`."""
    import numpy as np

    from portbench.film import FILM_NAME
    from portbench.reference.detect import FrameDets
    from portbench.reference.pipeline import Outputs

    movie = FILM_NAME.split("-")[0]
    data = os.path.join(root, f"{movie}-data")
    tag = f"{movie}_0-{n_frames}"
    with open(os.path.join(data, "scene_changes",
                           f"scene_changes_{tag}.json")) as f:
        cuts = json.load(f)["frame_indices"]

    def lines(path: str):
        """The file's lines; none where the program wrote no file."""
        if os.path.exists(path):
            with open(path, "rb") as f:
                yield from f

    trajectories = []
    for line in lines(os.path.join(data, "trajectories",
                                   f"trajectories_{tag}.jsonl")):
        t = json.loads(line)
        trajectories.append({k: t[k] for k in
                             ("start", "len", "bbs", "detected")})
    feats = os.path.join(data, "features", f"features_{tag}.jsonl")
    faces, offsets = [], []
    at = 0
    for line in lines(feats):
        frame = int(line[len(b'{"frame":'):line.index(b",")])
        tail = json.loads(b"{" + line[line.rindex(b',"box":') + 1:])
        kp = [v for xy in tail["keypoints"].values() for v in xy]
        faces.append({"frame": frame, "box": tail["box"],
                      "keypoints": kp})
        offsets.append(at)
        at += len(line)

    def embed(idx):
        out = {name: [] for name in names}
        with open(feats, "rb") as f:
            for i in idx:
                f.seek(offsets[i])
                emb = json.loads(f.readline())["embeddings"]
                for name in names:
                    out[name].append(emb[name])
        return {k: np.asarray(v, np.float64) for k, v in out.items()}

    dets = []
    for det in kept:
        b, s, l, v = (x.cpu().numpy() for x in (det.boxes, det.scores,
                                                det.landmarks, det.valid))
        dets.extend(FrameDets(b[i][v[i]], s[i][v[i]], l[i][v[i]])
                    for i in range(len(v)))
    out = Outputs(cuts, dets, trajectories, faces)
    out.embed = embed
    with open(os.path.join(data, "run_report.json")) as f:
        report = json.load(f)[f"extract_0-{n_frames}"]["counters"]
    return out, report


def passes_for(rate: float, seconds: float, pool_frames: int) -> int:
    """Whole passes over the pool (so that every film holds the same
    shots) that last about ``seconds`` at ``rate`` frames/s."""
    return max(1, round(rate * seconds / pool_frames))


def load_file(path: str, name: str):
    """The module of a Python file, loaded by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def embedder_family(config: dict):
    """The module of the configuration's embedder family."""
    name = config.get("embedder_family", DEFAULT_FAMILY)
    return load_file(os.path.join(FAMILIES, f"{name}.py"),
                     "portbench_family_" + name)


def layer_metrics(names, ctx):
    out = {}
    for name, unit in names:
        mod = load_file(os.path.join(HERE, "layer_metrics", f"{name}.py"),
                        "portbench_metric_" + name.replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def held(numbers: dict, limits: dict):
    """(every number within its limit, {name: {value, limit}})."""
    from portbench import compare

    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in compare.NAMES}
    return all(v["value"] <= v["limit"] for v in checks.values()), checks


def run_cell(loaded, seed: int, seconds: float, trace: bool, device,
             t_start: float, control_blocks: int = 0) -> dict:
    """One run of a cell (``loaded``: :func:`portbench.film.load_cell`'s
    cell, configuration, traffic and limits) on ``device``."""
    import torch

    from portbench import compare, film
    from portbench.reference.nets import detector_state_from_npz
    from portbench.reference.pipeline import Reference

    cell, config, traffic, limits = loaded
    family = embedder_family(config)
    det_path = film.detector_weights(config)
    block = config["extract"]["block_frames"]
    dev_info = card(device)
    log(f"device: {dev_info['kind']}")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    pool, cuts = film.paint_pool(config, traffic, seed)
    log(f"pool: {pool.shape}, cuts {cuts}")
    states = family.states(config, seed, device)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if control_blocks:
            n = control_blocks * block
            ref = lambda tf32: Reference(
                pool, config, detector_state_from_npz(det_path),
                family.reference(states, device), device, tf32=tf32).run(n)
            got, want = ref(True), ref(False)
            correct, checks = held(compare.compare(got, want, seed,
                                                   notes=[]), limits)
            log(f"card: {card_line(device)}")
            return {"control": True, "frames": n, "correct": correct,
                    "checks": checks}
        return _program_run(cell, config, family, pool, states, det_path,
                            device, seed, seconds, trace, t_start, tmp,
                            dev_info, limits, sync)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _program_run(cell, config, family, pool, states, det_path, device, seed,
                 seconds, trace, t_start, tmp, dev_info, limits, sync):
    import torch

    from facerec_torch.config import ExtractConfig
    from facerec_torch.pipeline.extract import (build_detector,
                                                fetch_group_size,
                                                run_extract)
    from facerec_torch.runtime import launches

    from portbench import compare, counts, film, probe
    from portbench.reference.nets import detector_state_from_npz
    from portbench.reference.pipeline import Reference

    ext = config["extract"]
    block = ext["block_frames"]
    h, w = pool.shape[1:3]
    fps = float(config["fps"])
    cfg = ExtractConfig(resume=False, **ext)
    p = probe.Probe(sync)
    detector = probe.Detector(build_detector(cfg, h, w, det_path, device), p)
    bank = family.program_bank(states, device, p)
    names = list(states)

    def extract(n_blocks: int, out: str):
        return run_extract(film.Film(pool, n_blocks * block, fps), cfg, out,
                           detector=detector, embedders=bank, device=device)

    if device.type == "cuda":
        # the bank's first full batch, so that the fetch groups timed
        # below load none of its kernels
        with torch.inference_mode():
            stack = torch.from_numpy(pool[:block]).to(device)
            family.warm(bank, stack, block, h, w)
            del stack
        sync()
        log("bank warm")
    pool_blocks = len(pool) // block
    group = fetch_group_size(cfg, pool_blocks * block, h, w)
    n_warm = WARM_GROUPS * group + 1
    p.reset()
    t = time.perf_counter()
    extract(n_warm, os.path.join(tmp, "warm"))
    sync()
    a, b = (WARM_GROUPS - 1) * group, WARM_GROUPS * group
    rate = ((b - a) * block / (p.stamps[b] - p.stamps[a]) if a > 0 else
            n_warm * block / (time.perf_counter() - t))
    shutil.rmtree(os.path.join(tmp, "warm"))
    log(f"warm-up: {n_warm} blocks, steady rate {rate:.2f} frames/s")

    n_blocks = pool_blocks * passes_for(rate, seconds, len(pool))
    n_frames = n_blocks * block
    p.reset(keep=pool_blocks)
    out = os.path.join(tmp, "window")
    gc.collect()
    launches.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    counters = extract(n_blocks, out)
    sync()
    window = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"card: {card_line(device)}")
    log(f"counters {dataclasses.asdict(counters)}; launches "
        f"{launches.snapshot()}")
    log(f"blocks {n_blocks}, frames {n_frames}, window {window:.3f} s; "
        f"saved faces a block {counters.saved_boxes / n_blocks:.2f}; "
        f"overflow {counters.overflow}")
    got, report = read_program(out, n_frames, p.kept, names)
    log("phases, s: " + ", ".join(
        f"{k[:-8]} {v}" for k, v in report.items()
        if k.endswith("_seconds")))
    n_det = sum(len(d.boxes) for d in got.pool_dets)
    log(f"detections a frame {n_det / max(1, len(got.pool_dets)):.3f}")

    summary = None
    if trace:
        # the device's readings come from an extract of their own, so
        # that the profiler's host cost stays out of the window's report
        n_prof = (PROFILED_GROUPS + 2) * group
        p.reset(start=group, blocks=PROFILED_GROUPS * group)
        extract(n_prof, os.path.join(tmp, "profiled"))
        sync()
        shutil.rmtree(os.path.join(tmp, "profiled"))
        if p.window_s is not None:
            from portbench import trace as trace_mod

            summary = trace_mod.summarize(p.prof, p.window_s)
    p.prof = None
    del detector, bank
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = Reference(pool, config, detector_state_from_npz(det_path),
                    family.reference(states, device), device)
    want = ref.run(n_frames)
    notes = []
    numbers = compare.compare(got, want, seed, notes=notes)
    for note in notes:
        log(f"differs: {note}")
    correct, checks = held(numbers, limits)

    if not trace:
        metrics = {
            "extract_fps": {"value": n_frames / window, "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        det_flops = counts.detector_flops(h, w)
        ctx = {"report": report, "trace": summary, "window": p.in_window,
               "block_frames": block, "device_kind": dev_info["kind"],
               "detector_flops_per_frame": det_flops,
               "embed_flops_per_crop": family.flops_per_crop(states),
               "scene_bytes_per_block": counts.scene_bytes(block, h, w),
               "peaks": film.load_json(".", "peaks")}
        wanted = [(m["name"], m["unit"]) for m in film.benchmark()["per_layer"]
                  if cell["name"] in m.get("workloads", [cell["name"]])]
        metrics = layer_metrics(wanted, ctx) if summary else {}
    device_out = dict(dev_info, memory_peak_bytes=int(peak))
    result = {"correct": correct, "attempted": n_frames,
              "failed": n_frames - counters.frames_processed,
              "metrics": metrics, "device": device_out}
    if trace and summary:
        device_out["busy_s"] = summary["busy_s"]
        device_out["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        log(f"traced window: {p.in_window}; ranges {summary['ranges']}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control-blocks", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import film

    log("torch imported")
    loaded = film.load_cell(args.workload)
    cell = loaded[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(loaded, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start,
                      args.control_blocks)
    found = forbidden_modules()
    if found:
        log(f"sys.modules holds {found}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k}: {v}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
