"""The four FaceNets' weights, made on the device from the seed.

Three draws a network on a generator on the device, each cut into its
tensors: every convolution and dense kernel LeCun-normal (variance
1 / fan-in); every conv bias, batch-norm mean and batch-norm offset
normal with standard deviation 0.1; every batch-norm variance uniform
in [0.5, 2).  So each term of the inference-form batch norm and each
bias enters the embeddings.  The same state dicts go to the program's
embedders and to the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference.nets import FaceNet

STAT_STD = 0.1
VAR_RANGE = (0.5, 2.0)


def facenet_states(names_dims: Dict[str, int], seed: int,
                   device: torch.device
                   ) -> Dict[str, Tuple[int, Dict[str, torch.Tensor]]]:
    """{name: (dim, state dict on ``device``)} in float32."""
    out = {}
    for i, (name, dim) in enumerate(names_dims.items()):
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in FaceNet(dim).state_dict().items()}
        kernels = [k for k, s in shapes.items()
                   if k.endswith("weight") and len(s) >= 2]
        variances = [k for k in shapes if k.endswith(".var")]
        shifts = [k for k in shapes if k not in kernels and k not in variances]
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * 8 + i) % (1 << 63))

        def draw(keys, fn):
            flat = fn(sum(shapes[k].numel() for k in keys))
            at = 0
            for k in keys:
                n = shapes[k].numel()
                yield k, flat[at:at + n].view(shapes[k])
                at += n

        sd = {}
        for k, v in draw(kernels, lambda n: torch.randn(
                n, generator=gen, device=device)):
            sd[k] = v / (v.numel() // v.shape[0]) ** 0.5
        for k, v in draw(shifts, lambda n: torch.randn(
                n, generator=gen, device=device)):
            sd[k] = v * STAT_STD
        lo, hi = VAR_RANGE
        for k, v in draw(variances, lambda n: torch.rand(
                n, generator=gen, device=device)):
            sd[k] = lo + (hi - lo) * v
        out[name] = (dim, {k: sd[k] for k in shapes})
    return out
