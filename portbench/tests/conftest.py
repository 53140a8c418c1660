"""Shared set-up of the benchmark's tests: a tiny cell on the CPU."""
import copy
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture
def tiny_cell():
    """pal576-dialogue's files at 128x96, 16-frame blocks, a pool of two
    blocks and short shots: the same code paths at a size the CPU
    holds."""
    from portbench import film

    cell, config, traffic, limits = film.load_cell("pal576-dialogue")
    config = copy.deepcopy(config)
    config.update(display_width=128, display_height=96, pool_blocks=2)
    config["extract"].update(block_frames=16, fetch_every_blocks=2)
    traffic = dict(traffic, shot_min=10, shot_max=20, shot_mean=15)
    return cell, config, traffic, limits


@pytest.fixture
def run_tiny(tiny_cell, monkeypatch):
    """A whole run of the tiny cell on the CPU → its result dict."""
    import time

    import torch

    from portbench import run

    monkeypatch.setattr(run, "WARM_GROUPS", 0)     # a warm-up of one block
    # two passes over the pool, whatever the CPU's rate: a seam inside
    monkeypatch.setattr(run, "passes_for", lambda *args: 2)

    def go(seed=12345678901, trace=False, seconds=1.0):
        return run.run_cell(tiny_cell, seed, seconds, trace,
                            torch.device("cpu"), time.time())
    return go
