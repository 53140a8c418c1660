"""The ``facenet`` embedder family: the configuration's ``facenets``
({checkpoint: embedding width}), Inception-ResNet-v1 on a crop of the
saved face's box widened by 8 px and resized to 160x160
(``portbench/embedders/__init__.py`` says what a family file gives).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import counts, weights
from portbench.probe import make_bank
from portbench.reference import embed

# crops a forward in the reference, as the program's bank embeds them
BATCH = 64


def states(config, seed, device):
    return weights.facenet_states(config["facenets"], seed, device)


def program_bank(states, device, probe):
    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.pipeline.extract import EmbedderBank

    return make_bank(EmbedderBank, {
        name: FaceNetEmbedder(name, dim, device=device, state_dict=sd)
        for name, (dim, sd) in states.items()}, probe)


def warm(bank, stack, block, height, width):
    """A centred 40x48 box, once for each slot of a batch."""
    from facerec_torch.pipeline.extract import EMBED_BATCH

    h, w = height, width
    bank.dispatch_crop_embed(
        stack, np.arange(EMBED_BATCH) % block,
        np.tile(np.float32([[w / 2 - 20, h / 2 - 24, w / 2 + 20,
                             h / 2 + 24]]), (EMBED_BATCH, 1)))


def reference(states, device):
    nets = embed.Embedders(states, device)

    def run(frames, faces):
        h, w = frames.shape[1:3]
        px = []
        for a in range(0, len(faces), BATCH):
            part = faces[a:a + BATCH]
            idx = torch.tensor([f["frame"] for f in part],
                               device=frames.device)
            boxes = torch.tensor([embed.crop_box(f["box"], w, h)
                                  for f in part], dtype=torch.float32,
                                 device=frames.device)
            px.append(embed.crops(frames[idx], boxes))
        return nets(torch.cat(px), BATCH)
    return run


def flops_per_crop(states):
    return sum(counts.facenet_flops(dim) for dim, _ in states.values())
