"""FaceNet (Inception-ResNet-v1) embedder.

Port of ``facerec_tpu/models/facenet.py``: the davidsandberg
Inception-ResNet-v1 with a 512- or 128-d bottleneck, module names
mirroring the TF checkpoint scopes as the Flax model does.  Embedding
convention: per-image prewhitening of the 160×160 crop, forward pass,
L2 normalization.

:class:`PooledEmbedders` runs all checkpoints over one crop batch: the
backbones one after another (the default unrolled stems of the JAX
package's pooled program), then each checkpoint's bottleneck matmul +
batch norm by hand in float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from facerec_torch.models.layers import BatchNorm, Conv, ConvBN, init_weights
from facerec_torch.runtime.device import resolve_device


class Block35(nn.Module):
    """Inception-ResNet-A residual block (256 channels)."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
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
        up = self.Conv2d_1x1(torch.cat([b0, b1, b2], dim=1))
        return F.relu(x + self.scale * up)


class Block17(nn.Module):
    """Inception-ResNet-B residual block (896 channels)."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.Branch_0_Conv2d_1x1 = ConvBN(896, 128, 1)
        self.Branch_1_Conv2d_0a_1x1 = ConvBN(896, 128, 1)
        self.Branch_1_Conv2d_0b_1x7 = ConvBN(128, 128, (1, 7))
        self.Branch_1_Conv2d_0c_7x1 = ConvBN(128, 128, (7, 1))
        self.Conv2d_1x1 = Conv(256, 896, 1)

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1x1(x)
        b1 = self.Branch_1_Conv2d_0c_7x1(self.Branch_1_Conv2d_0b_1x7(
            self.Branch_1_Conv2d_0a_1x1(x)))
        up = self.Conv2d_1x1(torch.cat([b0, b1], dim=1))
        return F.relu(x + self.scale * up)


class Block8(nn.Module):
    """Inception-ResNet-C residual block (1792 channels)."""

    def __init__(self, scale: float = 0.20, act: bool = True):
        super().__init__()
        self.scale = scale
        self.act = act
        self.Branch_0_Conv2d_1x1 = ConvBN(1792, 192, 1)
        self.Branch_1_Conv2d_0a_1x1 = ConvBN(1792, 192, 1)
        self.Branch_1_Conv2d_0b_1x3 = ConvBN(192, 192, (1, 3))
        self.Branch_1_Conv2d_0c_3x1 = ConvBN(192, 192, (3, 1))
        self.Conv2d_1x1 = Conv(384, 1792, 1)

    def forward(self, x):
        b0 = self.Branch_0_Conv2d_1x1(x)
        b1 = self.Branch_1_Conv2d_0c_3x1(self.Branch_1_Conv2d_0b_1x3(
            self.Branch_1_Conv2d_0a_1x1(x)))
        out = x + self.scale * self.Conv2d_1x1(torch.cat([b0, b1], dim=1))
        return F.relu(out) if self.act else out


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)      # 3×3 / 2, VALID


class FaceNet(nn.Module):
    """Inception-ResNet-v1 → unnormalized bottleneck features.  Input
    (N, 3, 160, 160) prewhitened crops."""

    def __init__(self, embedding_dim: int = 512):
        super().__init__()
        self.embedding_dim = embedding_dim
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
        self.Bottleneck = nn.Linear(1792, embedding_dim, bias=False)
        # Flax's default momentum (0.99), unlike ConvBN's 0.995
        self.Bottleneck_BatchNorm = BatchNorm(embedding_dim, eps=1e-3,
                                              momentum=0.99)

    def pooled(self, x: torch.Tensor) -> torch.Tensor:
        """Backbone → (N, 1792) global average pool."""
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _pool(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = self.Conv2d_4b_3x3(x)
        for i in range(5):
            x = getattr(self, f"Repeat_block35_{i + 1}")(x)
        b0 = self.Mixed_6a_Branch_0_Conv2d_1a_3x3(x)
        b1 = self.Mixed_6a_Branch_1_Conv2d_1a_3x3(
            self.Mixed_6a_Branch_1_Conv2d_0b_3x3(
                self.Mixed_6a_Branch_1_Conv2d_0a_1x1(x)))
        x = torch.cat([b0, b1, _pool(x)], dim=1)
        for i in range(10):
            x = getattr(self, f"Repeat_1_block17_{i + 1}")(x)
        b0 = self.Mixed_7a_Branch_0_Conv2d_1a_3x3(
            self.Mixed_7a_Branch_0_Conv2d_0a_1x1(x))
        b1 = self.Mixed_7a_Branch_1_Conv2d_1a_3x3(
            self.Mixed_7a_Branch_1_Conv2d_0a_1x1(x))
        b2 = self.Mixed_7a_Branch_2_Conv2d_1a_3x3(
            self.Mixed_7a_Branch_2_Conv2d_0b_3x3(
                self.Mixed_7a_Branch_2_Conv2d_0a_1x1(x)))
        x = torch.cat([b0, b1, b2, _pool(x)], dim=1)
        for i in range(5):
            x = getattr(self, f"Repeat_2_block8_{i + 1}")(x)
        x = self.Block8(x)
        return x.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Bottleneck_BatchNorm(self.Bottleneck(self.pooled(x)))

    def bottleneck(self, feats: torch.Tensor) -> torch.Tensor:
        """The pooled path's bottleneck, written out in float32 as the
        JAX package's pooled program does."""
        bn = self.Bottleneck_BatchNorm
        f = feats.to(torch.float32) @ self.Bottleneck.weight.T.to(
            torch.float32)
        return (f - bn.mean) * torch.rsqrt(bn.var + 1e-3) + bn.bias


def prewhiten(crops: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-image standardization over all pixels and channels, in
    ``dtype``."""
    x = crops.to(dtype)
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    std = x.std(dim=dims, keepdim=True, correction=0)
    return (x - mean) / std.clamp_min(1e-6)


def l2_normalize(e: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return e / norm.clamp_min(1e-12)


def _nchw(crops: torch.Tensor) -> torch.Tensor:
    """(N, 160, 160, 3) crops → prewhitened (N, 3, 160, 160)."""
    return prewhiten(crops).permute(0, 3, 1, 2)


class FaceNetEmbedder:
    """One checkpoint: (N, 160, 160, 3) crops → (N, dim) unit vectors.
    Weights from ``state_dict`` when given, else random from ``seed``;
    on the card unless ``device="cpu"`` is asked for."""

    def __init__(self, name: str, embedding_dim: int, device=None,
                 seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None):
        self.name = name
        self.embedding_dim = embedding_dim
        model = FaceNet(embedding_dim)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(resolve_device(device)).eval()

    @torch.no_grad()
    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model(_nchw(crops)))


class PooledEmbedders:
    """All checkpoints (any bottleneck dims) over one crop batch."""

    def __init__(self, embedders: Sequence[FaceNetEmbedder]):
        self.names: List[str] = [e.name for e in embedders]
        self.models: List[FaceNet] = [e.model for e in embedders]

    @torch.no_grad()
    def __call__(self, crops: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(N, 160, 160, 3) → tuple of (N, dim_i) unit embeddings."""
        x = _nchw(crops)
        return tuple(l2_normalize(m.bottleneck(m.pooled(x)))
                     for m in self.models)

