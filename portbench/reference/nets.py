"""The two networks of the extract stage, in plain PyTorch (NCHW).

A frozen, independent copy of the published architectures that the
program runs: the single-stage face detector (a 12x12 stride-4 stem,
residual stages at strides 8/16/32, an FPN, SSH context modules and a
1x1 anchor head per level) and the davidsandberg Inception-ResNet-v1
FaceNet (512- or 128-d bottleneck).  Batch norm is in inference form
only: ``(x - mean) * rsqrt(var + 1e-3) + bias`` (Flax's BatchNorm
without scale).  Padding is XLA's ``SAME``: on a stride-2 conv over an
even size it pads 0 before and 1 after.

Submodule names follow the Flax parameter trees (``Conv_0`` as
``conv``, ``BatchNorm_0`` as ``bn``), so one state dict loads here and
in the program alike.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Kernel = Union[int, Tuple[int, int]]
EPS = 1e-3


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: Kernel = 3, s: int = 1,
                 padding: str = "SAME", bias: bool = True):
        super().__init__()
        self.k = (k, k) if isinstance(k, int) else tuple(k)
        self.s, self.padding = s, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        if self.padding == "SAME":
            t, b = _same(x.shape[2], self.k[0], self.s)
            l, r = _same(x.shape[3], self.k[1], self.s)
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, self.bias, self.s)


class BatchNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - self.mean.view(shape))
                * torch.rsqrt(self.var + EPS).view(shape)
                + self.bias.view(shape))


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: Kernel = 3, s: int = 1,
                 padding: str = "SAME", act: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, padding, bias=False)
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


# --- the face detector ---------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, s: int = 1):
        super().__init__()
        self.conv1 = ConvBN(cin, cout, 3, s)
        self.conv2 = ConvBN(cout, cout, 3, 1, act=False)
        self.proj = (ConvBN(cin, cout, 1, s, act=False)
                     if s != 1 or cin != cout else None)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return F.relu((x if self.proj is None else self.proj(x)) + y)


class SSH(nn.Module):
    def __init__(self, cin: int, f: int):
        super().__init__()
        self.conv3 = ConvBN(cin, f // 2, 3, act=False)
        self.conv5a = ConvBN(cin, f // 4, 3)
        self.conv5 = ConvBN(f // 4, f // 4, 3, act=False)
        self.conv7a = ConvBN(f // 4, f // 4, 3)
        self.conv7 = ConvBN(f // 4, f // 4, 3, act=False)

    def forward(self, x):
        a = self.conv5a(x)
        return F.relu(torch.cat([self.conv3(x), self.conv5(a),
                                 self.conv7(self.conv7a(a))], dim=1))


def _up2(t):
    return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FaceDetector(nn.Module):
    """Raw per-level head outputs, each (B, A_level, 15): score, 4 box
    offsets, 10 landmark offsets per anchor."""

    def __init__(self, backbone_width: int = 96, fpn: int = 64,
                 anchors: int = 2):
        super().__init__()
        w = backbone_width
        self.anchors = anchors
        self.stem = ConvBN(3, w, 12, 4)
        self.c3_1, self.c3_2 = ResBlock(w, w, 2), ResBlock(w, w)
        self.c4_1, self.c4_2 = ResBlock(w, 2 * w, 2), ResBlock(2 * w, 2 * w)
        self.c5_1, self.c5_2 = ResBlock(2 * w, 4 * w, 2), \
            ResBlock(4 * w, 4 * w)
        self.lat5 = ConvBN(4 * w, fpn, 1, act=False)
        self.lat4 = ConvBN(2 * w, fpn, 1, act=False)
        self.lat3 = ConvBN(w, fpn, 1, act=False)
        self.smooth4 = ConvBN(fpn, fpn, 3)
        self.smooth3 = ConvBN(fpn, fpn, 3)
        for i in range(3):
            self.add_module(f"ssh{i}", SSH(fpn, fpn))
            self.add_module(f"head{i}", Conv(fpn, 15 * anchors, 1))

    def forward(self, x) -> List[torch.Tensor]:
        c3 = self.c3_2(self.c3_1(self.stem(x)))
        c4 = self.c4_2(self.c4_1(c3))
        c5 = self.c5_2(self.c5_1(c4))
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _up2(p5)
        p3 = self.lat3(c3) + _up2(p4)
        outs = []
        for i, p in enumerate((self.smooth3(p3), self.smooth4(p4), p5)):
            h = getattr(self, f"head{i}")(getattr(self, f"ssh{i}")(p))
            b, _, hh, ww = h.shape
            outs.append(h.permute(0, 2, 3, 1).reshape(
                b, hh * ww * self.anchors, 15))
        return outs


# --- Inception-ResNet-v1 -------------------------------------------------

class Block35(nn.Module):
    def __init__(self):
        super().__init__()
        self.Branch_0_Conv2d_1x1 = ConvBN(256, 32, 1)
        self.Branch_1_Conv2d_0a_1x1 = ConvBN(256, 32, 1)
        self.Branch_1_Conv2d_0b_3x3 = ConvBN(32, 32, 3)
        self.Branch_2_Conv2d_0a_1x1 = ConvBN(256, 32, 1)
        self.Branch_2_Conv2d_0b_3x3 = ConvBN(32, 32, 3)
        self.Branch_2_Conv2d_0c_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_1x1 = Conv(96, 256, 1)

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1x1(x)
        b1 = self.Branch_1_Conv2d_0b_3x3(self.Branch_1_Conv2d_0a_1x1(x))
        b2 = self.Branch_2_Conv2d_0c_3x3(self.Branch_2_Conv2d_0b_3x3(
            self.Branch_2_Conv2d_0a_1x1(x)))
        return F.relu(x + 0.17 * self.Conv2d_1x1(torch.cat([b0, b1, b2], 1)))


class Block17(nn.Module):
    def __init__(self):
        super().__init__()
        self.Branch_0_Conv2d_1x1 = ConvBN(896, 128, 1)
        self.Branch_1_Conv2d_0a_1x1 = ConvBN(896, 128, 1)
        self.Branch_1_Conv2d_0b_1x7 = ConvBN(128, 128, (1, 7))
        self.Branch_1_Conv2d_0c_7x1 = ConvBN(128, 128, (7, 1))
        self.Conv2d_1x1 = Conv(256, 896, 1)

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1x1(x)
        b1 = self.Branch_1_Conv2d_0c_7x1(self.Branch_1_Conv2d_0b_1x7(
            self.Branch_1_Conv2d_0a_1x1(x)))
        return F.relu(x + 0.10 * self.Conv2d_1x1(torch.cat([b0, b1], 1)))


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, act: bool = True):
        super().__init__()
        self.scale, self.act = scale, act
        self.Branch_0_Conv2d_1x1 = ConvBN(1792, 192, 1)
        self.Branch_1_Conv2d_0a_1x1 = ConvBN(1792, 192, 1)
        self.Branch_1_Conv2d_0b_1x3 = ConvBN(192, 192, (1, 3))
        self.Branch_1_Conv2d_0c_3x1 = ConvBN(192, 192, (3, 1))
        self.Conv2d_1x1 = Conv(384, 1792, 1)

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1x1(x)
        b1 = self.Branch_1_Conv2d_0c_3x1(self.Branch_1_Conv2d_0b_1x3(
            self.Branch_1_Conv2d_0a_1x1(x)))
        out = x + self.scale * self.Conv2d_1x1(torch.cat([b0, b1], 1))
        return F.relu(out) if self.act else out


def _pool(x):
    return F.max_pool2d(x, 3, 2)


class FaceNet(nn.Module):
    """(N, 3, 160, 160) prewhitened crops → (N, dim) bottleneck
    features (before the L2 norm)."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, 2, "VALID")
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3, 1, "VALID")
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, 1, "SAME")
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1, 1, "VALID")
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3, 1, "VALID")
        self.Conv2d_4b_3x3 = ConvBN(192, 256, 3, 2, "VALID")
        for i in range(5):
            self.add_module(f"Repeat_block35_{i + 1}", Block35())
        self.Mixed_6a_Branch_0_Conv2d_1a_3x3 = ConvBN(256, 384, 3, 2, "VALID")
        self.Mixed_6a_Branch_1_Conv2d_0a_1x1 = ConvBN(256, 192, 1)
        self.Mixed_6a_Branch_1_Conv2d_0b_3x3 = ConvBN(192, 192, 3)
        self.Mixed_6a_Branch_1_Conv2d_1a_3x3 = ConvBN(192, 256, 3, 2, "VALID")
        for i in range(10):
            self.add_module(f"Repeat_1_block17_{i + 1}", Block17())
        self.Mixed_7a_Branch_0_Conv2d_0a_1x1 = ConvBN(896, 256, 1)
        self.Mixed_7a_Branch_0_Conv2d_1a_3x3 = ConvBN(256, 384, 3, 2, "VALID")
        self.Mixed_7a_Branch_1_Conv2d_0a_1x1 = ConvBN(896, 256, 1)
        self.Mixed_7a_Branch_1_Conv2d_1a_3x3 = ConvBN(256, 256, 3, 2, "VALID")
        self.Mixed_7a_Branch_2_Conv2d_0a_1x1 = ConvBN(896, 256, 1)
        self.Mixed_7a_Branch_2_Conv2d_0b_3x3 = ConvBN(256, 256, 3)
        self.Mixed_7a_Branch_2_Conv2d_1a_3x3 = ConvBN(256, 256, 3, 2, "VALID")
        for i in range(5):
            self.add_module(f"Repeat_2_block8_{i + 1}", Block8())
        self.Block8 = Block8(scale=1.0, act=False)
        self.Bottleneck = nn.Linear(1792, dim, bias=False)
        self.Bottleneck_BatchNorm = BatchNorm(dim)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4b_3x3(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(
            _pool(x))))
        for i in range(5):
            x = getattr(self, f"Repeat_block35_{i + 1}")(x)
        x = torch.cat([
            self.Mixed_6a_Branch_0_Conv2d_1a_3x3(x),
            self.Mixed_6a_Branch_1_Conv2d_1a_3x3(
                self.Mixed_6a_Branch_1_Conv2d_0b_3x3(
                    self.Mixed_6a_Branch_1_Conv2d_0a_1x1(x))),
            _pool(x)], 1)
        for i in range(10):
            x = getattr(self, f"Repeat_1_block17_{i + 1}")(x)
        x = torch.cat([
            self.Mixed_7a_Branch_0_Conv2d_1a_3x3(
                self.Mixed_7a_Branch_0_Conv2d_0a_1x1(x)),
            self.Mixed_7a_Branch_1_Conv2d_1a_3x3(
                self.Mixed_7a_Branch_1_Conv2d_0a_1x1(x)),
            self.Mixed_7a_Branch_2_Conv2d_1a_3x3(
                self.Mixed_7a_Branch_2_Conv2d_0b_3x3(
                    self.Mixed_7a_Branch_2_Conv2d_0a_1x1(x))),
            _pool(x)], 1)
        for i in range(5):
            x = getattr(self, f"Repeat_2_block8_{i + 1}")(x)
        x = self.Block8(x).mean(dim=(2, 3))
        return self.Bottleneck_BatchNorm(self.Bottleneck(x))


def detector_state_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """A Flax single-file checkpoint (``/``-joined leaves) as this
    module's state dict: HWIO kernels to OIHW, ``Conv_0``/``BatchNorm_0``
    to ``conv``/``bn``."""
    import numpy as np

    rename = {"Conv_0": "conv", "BatchNorm_0": "bn"}
    out = {}
    with np.load(path) as data:
        for key in data.files:
            _, *mods, leaf = key.split("/")
            arr = np.asarray(data[key], np.float32)
            if leaf == "kernel":
                leaf = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            name = ".".join([rename.get(m, m) for m in mods] + [leaf])
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
