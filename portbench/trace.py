"""Reading the profiler's window: device activity, kernel time by name,
the device time under the harness's ranges, and the breakdown the
result line carries."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.probe import RANGES


def _union(iv: np.ndarray) -> Tuple[float, np.ndarray]:
    """(total length, merged intervals) of (n, 2) intervals."""
    if not len(iv):
        return 0.0, iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    m = np.asarray(merged)
    return float((m[:, 1] - m[:, 0]).sum()), m


def summarize(prof, window_s: float) -> Dict:
    """Seconds throughout."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.events():
        if e.device_type == cuda:
            if e.name not in RANGES:        # not a range's device shadow
                dev.append(e)
        else:
            cpu.append(e)
    kernels: Dict[str, float] = {}
    iv = np.array([[e.time_range.start, e.time_range.end] for e in dev],
                  np.float64).reshape(-1, 2)
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e6
    busy_us, merged = _union(iv)
    ranges = {name: {"calls": 0, "device_s": 0.0} for name in RANGES}
    for e in cpu:
        if e.name in ranges:
            ranges[e.name]["calls"] += 1
            ranges[e.name]["device_s"] += e.device_time_total / 1e6
    return {"window_s": window_s, "busy_s": busy_us / 1e6,
            "kernels": kernels, "ranges": ranges,
            "breakdown": breakdown(kernels, merged, cpu, window_s)}


def breakdown(kernels: Dict[str, float], merged: np.ndarray, cpu,
              window_s: float) -> Dict[str, List]:
    """The ten device operations that took most time, and the ten
    longest idle gaps, each named by the innermost host event under way
    at its middle."""
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if len(merged):
        t0 = min([merged[0, 0]] + [e.time_range.start for e in cpu])
        t1 = t0 + window_s * 1e6
        edges = np.concatenate([[t0], merged.reshape(-1), [t1]]).reshape(
            -1, 2)
        length = edges[:, 1] - edges[:, 0]
        starts = np.array([e.time_range.start for e in cpu], np.float64)
        ends = np.array([e.time_range.end for e in cpu], np.float64)
        for k in np.argsort(-length)[:10]:
            if length[k] <= 0:
                break
            mid = (edges[k, 0] + edges[k, 1]) / 2
            under = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = ("host: no torch op" if not len(under) else
                    cpu[int(under[np.argmin(ends[under]
                                            - starts[under])])].name)
            gaps.append([name, float(length[k]) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}
