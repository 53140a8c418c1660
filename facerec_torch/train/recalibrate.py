"""Post-training BatchNorm running-statistics recalibration.

Port of ``facerec_tpu/train/recalibrate.py``.  A short training run
leaves the running statistics stale: at ConvBN's momentum 0.995 a
200-step probe still carries 0.995^200 ≈ 37% of the initial statistics
(mean 0, var 1), and normalising with those at deploy time compounds
through the ~20 scale-free BN layers of the detector
(docs/DESIGN.md "BN recalibration").

The fix runs K calibration batches forward in train mode, which folds
their batch statistics into each running average at the module's own
momentum m, then unwinds the average exactly:

    ra_K = m^K · ra_0 + (1 − m^K) · S
    S    = (ra_K − m^K · ra_0) / (1 − m^K)

S is a geometrically weighted average of the calibration batches'
statistics with none of ra_0 left.  Unlike the JAX function, which
applies one momentum (0.995) to every leaf, each module unwinds with
its own: FaceNet's bottleneck BN runs at 0.99.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from facerec_torch.models.layers import BatchNorm


@torch.no_grad()
def recalibrate_batch_stats(model: nn.Module, batches: Iterable,
                            forward: Optional[Callable] = None) -> int:
    """Replace the running statistics of every :class:`BatchNorm` in
    ``model`` with statistics estimated from ``batches``, in place;
    parameters are untouched.  ``forward(model, batch)`` runs one batch
    (default ``model(batch)``); the model runs in train mode and gets
    its previous mode back.  Returns the number of batches."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    ra0 = [(m.mean.clone(), m.var.clone()) for m in bns]
    was_training = model.training
    model.train()
    n = 0
    try:
        for batch in batches:
            if forward is None:
                model(batch)
            else:
                forward(model, batch)
            n += 1
    finally:
        model.train(was_training)
    if n == 0:
        raise ValueError("recalibration needs at least one batch")
    for m, (mean0, var0) in zip(bns, ra0):
        w = m.momentum ** n
        m.mean.copy_((m.mean - w * mean0) / (1.0 - w))
        # exact algebra keeps the variance positive; guard the roundoff
        m.var.copy_(torch.clamp_min((m.var - w * var0) / (1.0 - w), 1e-6))
    return n
