"""Capturing a forward as one CUDA graph.

A replay launches the kernels the capture recorded, on the shapes and
the memory it recorded, so it computes the same bytes as the eager
forward at one host launch.  :func:`warm_up` runs the forward before a
capture; :func:`capture` warms it up and records it."""
from __future__ import annotations

from typing import Callable, Tuple, TypeVar

import torch

T = TypeVar("T")


def launch_settings() -> tuple:
    """The settings that choose a forward's kernels as it launches:
    TF32 for cuDNN and for matrix products.  A graph keeps the kernels
    of its capture, so it serves only calls made under the settings it
    was captured under."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def warm_up(run: Callable[[], object], device: torch.device,
            warmup: int = 2) -> None:
    """Run ``run`` ``warmup`` times on a side stream (kernel builds,
    cuDNN and cuBLAS handles, uploads made once), then once more with
    synchronising calls made errors: a host read would break a
    capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            run()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def capture(run: Callable[[], T], device: torch.device,
            warmup: int = 2) -> Tuple[torch.cuda.CUDAGraph, T]:
    """(graph, its static outputs): ``run`` warmed up, then recorded
    once.  ``run`` reads only tensors that outlive the graph; a replay
    overwrites the outputs."""
    warm_up(run, device, warmup)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    return graph, out
