"""The ``arcface`` embedder family: the configuration's ``arcface``
block, insightface's IResNet-100 on a 112x112 crop aligned by the
similarity that takes the saved face's five landmarks to insightface's
template (``portbench/embedders/__init__.py`` says what a family file
gives; the reference is :mod:`portbench.reference.arcface`).

The seeded weights are drawn on the device in four draws, each cut into
its tensors: every convolution and dense kernel LeCun-normal (variance
1 / fan-in); every batch-norm scale uniform in [0.8, 1.2), that of each
block's last batch norm (``bn3``) then times ``BN3_SCALE``; every
batch-norm mean and offset and the dense layer's bias normal with
standard deviation 0.1; every batch-norm variance uniform in [0.5, 2)
and every PReLU slope uniform in [0.1, 0.4).  The last batch norm's
scale stays 1, as published.  ``BN3_SCALE`` keeps the residual
stream's scale bounded over the 49 blocks: each block adds its branch
to the identity, and at scale ~1 the stream's RMS grows some
thousandfold by the last stage (0.38 after the stem to 3.1e3 on seed 0;
0.38 to 1.12 with it).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.probe import make_bank
from portbench.reference import arcface

BN3_SCALE = 0.2
STAT_STD = 0.1
SCALE_RANGE = (0.8, 1.2)
VAR_RANGE = (0.5, 2.0)
SLOPE_RANGE = (0.1, 0.4)


def draw(seed: int, device, layers=arcface.LAYERS):
    """The seeded state dict of one network on ``device``, float32."""
    shapes = arcface.shapes(layers)
    kernels = [k for k, s in shapes.items()
               if k.endswith("weight") and len(s) >= 2]
    scales = [k for k, s in shapes.items() if k.endswith("weight")
              and len(s) == 1 and "prelu" not in k and k != "features.weight"]
    shifts = [k for k in shapes if k.endswith(("running_mean", ".bias"))]
    uniform = [k for k in shapes if k.endswith("running_var")
               or "prelu" in k]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))

    def cut(keys, flat):
        at = 0
        for k in keys:
            n = int(np.prod(shapes[k]))
            yield k, flat[at:at + n].view(shapes[k])
            at += n

    def count(keys):
        return sum(int(np.prod(shapes[k])) for k in keys)

    sd = {}
    for k, v in cut(kernels, torch.randn(count(kernels), generator=gen,
                                         device=device)):
        sd[k] = v / (v.numel() // v.shape[0]) ** 0.5
    lo, hi = SCALE_RANGE
    for k, v in cut(scales, torch.rand(count(scales), generator=gen,
                                       device=device)):
        sd[k] = (lo + (hi - lo) * v) * (BN3_SCALE if k.endswith(
            ".bn3.weight") else 1.0)
    for k, v in cut(shifts, torch.randn(count(shifts), generator=gen,
                                        device=device)):
        sd[k] = v * STAT_STD
    for k, v in cut(uniform, torch.rand(count(uniform), generator=gen,
                                        device=device)):
        lo, hi = VAR_RANGE if k.endswith("running_var") else SLOPE_RANGE
        sd[k] = lo + (hi - lo) * v
    sd["features.weight"] = torch.ones(shapes["features.weight"],
                                       device=device)
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros(s, dtype=torch.int64, device=device)
    return {k: sd[k] for k in shapes}


def states(config, seed, device):
    net = config["arcface"]
    return {net["name"]: (net["features"],
                          draw(seed, device, tuple(net["layers"])))}


def program_bank(states, device, probe):
    from facerec_torch.models.iresnet import ArcFaceEmbedder
    from facerec_torch.pipeline.extract import EmbedderBank

    return make_bank(EmbedderBank, {
        name: ArcFaceEmbedder(name, device=device, state_dict=sd,
                              layers=_layers(sd))
        for name, (_, sd) in states.items()}, probe)


def warm(bank, stack, block, height, width):
    """A centred 40x48 box with the template's landmarks scaled into it,
    once for each slot of a batch."""
    from facerec_torch.pipeline.extract import EMBED_BATCH

    box = np.float32([width / 2 - 20, height / 2 - 24, width / 2 + 20,
                      height / 2 + 24])
    ldm = box[:2] + arcface.TEMPLATE * (40 / arcface.SIZE)
    bank.dispatch_crop_embed(
        stack, np.arange(EMBED_BATCH) % block,
        np.tile(box, (EMBED_BATCH, 1)),
        np.tile(np.float32(ldm), (EMBED_BATCH, 1, 1)))


def reference(states, device):
    nets = {name: arcface.Embedder(sd, device, _layers(sd))
            for name, (_, sd) in states.items()}
    return lambda frames, faces: {name: net(frames, faces)
                                  for name, net in nets.items()}


def flops_per_crop(states):
    return sum(arcface.flops(_layers(sd)) for _, sd in states.values())


def _layers(sd):
    """The blocks of each stage of a state dict."""
    return tuple(len({k.split(".")[1] for k in sd
                      if k.startswith(f"layer{s}.")}) for s in range(1, 5))
