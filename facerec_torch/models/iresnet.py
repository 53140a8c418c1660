"""ArcFace IResNet-100 embedder.

insightface's ``iresnet100`` (``recognition/arcface_torch/backbones/
iresnet.py``; Deng et al., "ArcFace", arXiv:1801.07698) with the
published module names, so that a published ``backbone.pth`` loads with
``load_state_dict(strict=True)``: a 3x3 stem to 64 channels, batch norm
and PReLU; four stages of :class:`IBasicBlock` ([3, 13, 30, 3] blocks at
widths 64, 128, 256, 512), each stage opening with stride 2; then batch
norm, the 512x7x7 map flattened channel first, a dense layer to 512 and
a batch norm whose scale is fixed at 1.  Every batch norm has eps 1e-5.

The input is the (N, 3, 112, 112) crop aligned to insightface's
five-point template and scaled as (x - 127.5) / 127.5
(:mod:`facerec_torch.ops.align`); the embedder returns L2-normalised
vectors (insightface's ``normed_embedding``).  The published network
was trained under fp16 autocast; the port runs it in float32 with TF32
off, as every stage entry point sets.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from facerec_torch.models.facenet import l2_normalize
from facerec_torch.runtime.device import resolve_device

LAYERS = (3, 13, 30, 3)
WIDTHS = (64, 128, 256, 512)
EMBEDDING_DIM = 512
INPUT_SIZE = 112
EPS = 1e-5
# scale of each block's last batch norm in a random initialisation:
# every block adds its branch to the identity, so at 1 the stream's
# scale grows some thousandfold over the 49 blocks
INIT_RESIDUAL_SCALE = 0.2


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)


class IBasicBlock(nn.Module):
    """BN → 3x3 conv → BN → PReLU → 3x3 conv (the stride) → BN, plus
    the identity (``downsample``: a strided 1x1 conv and BN where the
    shape changes); no activation after the sum."""

    def __init__(self, cin: int, width: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin, eps=EPS)
        self.conv1 = conv3x3(cin, width)
        self.bn2 = nn.BatchNorm2d(width, eps=EPS)
        self.prelu = nn.PReLU(width)
        self.conv2 = conv3x3(width, width, stride)
        self.bn3 = nn.BatchNorm2d(width, eps=EPS)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


class IResNet(nn.Module):
    """(N, 3, 112, 112) → (N, num_features) unnormalised features."""

    def __init__(self, layers: Sequence[int] = LAYERS,
                 num_features: int = EMBEDDING_DIM):
        super().__init__()
        self.conv1 = conv3x3(3, 64)
        self.bn1 = nn.BatchNorm2d(64, eps=EPS)
        self.prelu = nn.PReLU(64)
        cin = 64
        for s, (n, width) in enumerate(zip(layers, WIDTHS)):
            down = nn.Sequential(
                nn.Conv2d(cin, width, 1, 2, bias=False),
                nn.BatchNorm2d(width, eps=EPS))
            blocks = [IBasicBlock(cin, width, 2, down)]
            blocks += [IBasicBlock(width, width) for _ in range(1, n)]
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))
            cin = width
        self.bn2 = nn.BatchNorm2d(cin, eps=EPS)
        side = INPUT_SIZE >> len(layers)
        self.fc = nn.Linear(cin * side * side, num_features)
        self.features = nn.BatchNorm1d(num_features, eps=EPS)
        nn.init.constant_(self.features.weight, 1.0)
        self.features.weight.requires_grad = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        # channel-first flatten, as the published (N, C, H, W) layout
        return self.features(self.fc(torch.flatten(self.bn2(x), 1)))


def init_weights(model: IResNet, generator: torch.Generator) -> None:
    """Random initialisation from ``generator``: conv and dense weights
    normal with variance 1/fan_in, biases 0, batch norms at identity but
    for each block's last, scaled by ``INIT_RESIDUAL_SCALE``, PReLU
    slopes at 0.25 (PyTorch's default)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator)
                        / w[0].numel() ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, IBasicBlock):
                m.bn3.weight.fill_(INIT_RESIDUAL_SCALE)


class ArcFaceEmbedder:
    """One IResNet-100: (N, 3, 112, 112) aligned crops → (N, 512) unit
    vectors, float32.  Weights from ``state_dict`` (the published names)
    when given, else random from ``seed``; on the card unless
    ``device="cpu"`` is asked for.  ``layers`` other than the published
    depth serve the tests."""

    embedding_dim = EMBEDDING_DIM
    # its crop is aligned to the face's five landmarks, not its box
    takes_landmarks = True

    def __init__(self, name: str, device=None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: Optional[int] = None,
                 layers: Sequence[int] = LAYERS):
        self.name = name
        model = IResNet(layers)
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(seed or 0))
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(resolve_device(device)).eval()

    @torch.no_grad()
    def __call__(self, crops: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model(crops))
