"""Shared building blocks of the port's networks (NCHW inside).

Port of ``facerec_tpu/models/layers.py``.  Flax ``"SAME"`` padding is
reproduced exactly with an explicit ``F.pad``: on a stride-2 conv over
an even size it pads 0 before and 1 after, which a symmetric
``nn.Conv2d(padding=...)`` cannot express.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

KernelSize = Union[int, Tuple[int, int]]


def _pair(k: KernelSize) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution with Flax padding semantics (``"SAME"`` or
    ``"VALID"``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: KernelSize = 3,
                 stride: int = 1, padding: str = "SAME", bias: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.kernel = _pair(kernel)
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (t, b) = same_pads(x.shape[2], self.kernel[0], self.stride)
            (l, r) = same_pads(x.shape[3], self.kernel[1], self.stride)
            if t or b or l or r:
                x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class BatchNorm(nn.Module):
    """Batch norm without scale over axis 1, Flax's ``nn.BatchNorm``
    (``use_scale=False``): ``(x - mean) * rsqrt(var + eps) + bias``.

    In eval mode ``mean``/``var`` are the running statistics.  In train
    mode they are the batch's over every axis but 1, with Flax's fast
    variance ``max(E[x²] − E[x]², 0)`` (the gradient flows through both
    moments), and the running statistics move by Flax's rule
    ``ra = m·ra + (1 − m)·batch`` with the biased variance — not
    ``nn.BatchNorm2d``'s, whose momentum is the complement and whose
    running variance is unbiased.

    With a process ``group`` (:func:`set_batch_norm_group`) each rank
    holds an equal shard of the batch, and the train-mode moments are
    the global batch's: the sums of x and x² are all-reduced, with
    their gradient."""

    group = None

    def __init__(self, features: int, eps: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            if self.group is None:
                mean, sq = x.mean(dim=dims), (x * x).mean(dim=dims)
            else:
                mean, sq = _global_moments(x, dims, self.group)
            # torch.maximum splits the gradient at a tie, as jnp.maximum
            var = torch.maximum(sq - mean * mean, torch.zeros_like(mean))
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)


def _global_moments(x: torch.Tensor, dims, group):
    """E[x] and E[x²] over every axis but 1 of the batch whose equal
    shards the ranks of ``group`` hold."""
    import torch.distributed as dist

    from facerec_torch.parallel.mesh import all_reduce

    c = x.shape[1]
    count = x.numel() // c * dist.get_world_size(group)
    sums = all_reduce(torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims)]),
                      group)
    return sums[:c] / count, sums[c:] / count


def set_batch_norm_group(module: nn.Module, group) -> None:
    """Make every :class:`BatchNorm` in ``module`` take its train-mode
    statistics over the ranks of ``group`` (None: this rank's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class ConvBN(nn.Module):
    """Conv (no bias) → BatchNorm (eps 1e-3, momentum 0.995, no scale)
    → optional ReLU.  Submodule names ``conv``/``bn`` stand for Flax's
    ``Conv_0``/``BatchNorm_0``."""

    def __init__(self, in_ch: int, features: int, kernel: KernelSize = 3,
                 stride: int = 1, padding: str = "SAME", act: bool = True):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel, stride, padding,
                         bias=False)
        self.bn = BatchNorm(features, eps=1e-3, momentum=0.995)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation from ``generator``: every conv and dense
    weight normal with variance 1/fan_in (LeCun), biases 0, batch-norm
    statistics at identity.  Deterministic for a given seed."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator)
                        / fan_in ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)

