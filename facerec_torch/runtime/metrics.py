"""Stage reports: counters + wall time merged into ``run_report.json``.

Port of the ``StageReport`` part of ``facerec_tpu/runtime/metrics.py``.
Each report records the settings that change the port's numbers: its
device and the float32 precision modes.  (The JAX package's
``FACEREC_*`` A/B knobs do not exist in the port.)
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import torch


def effective_knobs(device: torch.device) -> Dict[str, object]:
    return {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "torch": torch.__version__,
    }


class StageReport:
    """Counters + wall-clock for one stage run."""

    def __init__(self, stage: str, device: torch.device):
        self.stage = stage
        self.device = device
        self.counters: Dict[str, float] = {}
        self._start = time.time()

    def set(self, name: str, value) -> None:
        self.counters[name] = value

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
