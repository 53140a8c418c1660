"""Linear SVM (one-vs-rest, squared hinge) trained on the device.

Port of ``facerec_tpu/ops/svm.py``: full-batch gradient descent on the
L2-regularised squared-hinge loss, 500 steps at lr 0.1 from zeros,
with the explicit gradient (plain tensor code: the JAX function is XLA
code outside any Pallas kernel).  It replaces the reference's offline
``LinearSVC``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from facerec_torch.runtime.device import resolve_device, use_full_float32


def train_linear_svm(x: np.ndarray, y: np.ndarray, c: float = 1.0,
                     steps: int = 500, lr: float = 0.1, device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit one-vs-rest linear SVMs on ``device`` (the card unless
    ``"cpu"`` is asked for).

    Args:
        x: (N, D) float32 features.
        y: (N,) int labels (arbitrary values).
    Returns:
        (W (D, C), b (C,), classes (C,)) — the decision function is
        ``x @ W + b`` with columns ordered by sorted class value.
    """
    dev = resolve_device(device)
    use_full_float32()
    classes, y_idx = np.unique(y, return_inverse=True)
    n, d = x.shape
    targets = np.full((n, len(classes)), -1.0, np.float32)
    targets[np.arange(n), y_idx] = 1.0

    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    td = torch.from_numpy(targets).to(dev)
    w = torch.zeros((d, len(classes)), dtype=torch.float32, device=dev)
    b = torch.zeros(len(classes), dtype=torch.float32, device=dev)
    # loss = (0.5·|w|²/c + Σ max(0, 1 − t·(xw + b))²) / n
    for _ in range(steps):
        hinge = (1.0 - td * (xd @ w + b)).clamp_min(0.0)
        dz = -2.0 * hinge * td / n
        w = w - lr * (w / (c * n) + xd.T @ dz)
        b = b - lr * dz.sum(0)
    return w.cpu().numpy(), b.cpu().numpy(), classes


def decision_function(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                      device=None) -> np.ndarray:
    """``x @ w + b`` on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    use_full_float32()
    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return (xd @ torch.as_tensor(w, device=dev)
            + torch.as_tensor(b, device=dev)).cpu().numpy()
