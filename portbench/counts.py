"""Frozen operation and byte counts of the work a cell asks for.

FLOPs are two per multiply-accumulate of every convolution and dense
layer of the reference architectures at the cell's shapes (the
elementwise work is left out), counted from shapes on the meta device.
They count the work the film needs, so padded crop slots and work done
twice count as waste.  Scene bytes are the scene kernels' least
traffic: the uint8 frames' cropped rows read once, the luminance and
equalised planes (float32, rows padded to a multiple of 8) written once.
"""
from __future__ import annotations

import torch

from portbench.reference import scene
from portbench.reference.detect import fit_input
from portbench.reference.nets import Conv, FaceDetector, FaceNet


def _flops(model: torch.nn.Module, x_shape) -> int:
    total = [0]

    def conv(m, inputs, out):
        total[0] += 2 * out.numel() * m.weight[0].numel()

    def dense(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = []
    for m in model.modules():
        if isinstance(m, Conv):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, torch.nn.Linear):
            hooks.append(m.register_forward_hook(dense))
    with torch.no_grad():
        model(torch.empty(x_shape, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def detector_flops(height: int, width: int, backbone_width: int = 96) -> int:
    """FLOPs of one frame through the detector at the film's native
    size (its input rounded up to a multiple of 32)."""
    ih, iw = fit_input(height, width)
    with torch.device("meta"):
        model = FaceDetector(backbone_width=backbone_width)
    return _flops(model, (1, 3, ih, iw))


def facenet_flops(dim: int) -> int:
    """FLOPs of one 160x160 crop through one FaceNet."""
    with torch.device("meta"):
        model = FaceNet(dim)
    return _flops(model, (1, 3, 160, 160))


def scene_bytes(frames: int, height: int, width: int) -> int:
    """Least bytes the scene kernels move for a block of frames."""
    lo, hi = scene.crop_rows(height, width)
    rows = -(-(hi - lo) // 8) * 8
    return frames * ((hi - lo) * width * 3 + 2 * rows * width * 4)
