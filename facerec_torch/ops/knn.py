"""K-nearest-neighbour probability voting on the device.

Port of ``facerec_tpu/ops/knn.py``: one float32 distance product, the k
nearest training rows per query, and a one-hot mean.  ``lax.top_k``
breaks ties toward the lower training index and ``torch.topk`` on a
card fixes no order among ties, so the neighbours come from a stable
ascending sort of the distances.  Ties are routine here: the training
set upsamples by repeating vectors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from facerec_torch.runtime.device import resolve_device


def squared_distances(query: torch.Tensor,
                      train_x: torch.Tensor) -> torch.Tensor:
    """(Q, M) squared distances in the JAX package's matrix-product
    form."""
    sq_t = torch.sum(train_x * train_x, dim=-1)
    sq_q = torch.sum(query * query, dim=-1)
    return sq_q[:, None] - 2.0 * (query @ train_x.T) + sq_t[None, :]


def nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) indices of the k smallest entries per row, ties to the
    lower index."""
    return torch.sort(d2, dim=1, stable=True).indices[:, :k]


def knn_predict_proba(train_x: np.ndarray, train_y: np.ndarray,
                      query: np.ndarray, k: int, device=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform-weight KNN class probabilities on ``device`` (the card
    unless ``"cpu"`` is asked for).

    Returns (proba (Q, C) float32, classes (C,) sorted unique class ids),
    sklearn's ``predict_proba`` / ``classes_`` contract.  ``k >
    len(train_x)`` raises, as sklearn does.
    """
    classes, class_idx = np.unique(train_y, return_inverse=True)
    if len(query) == 0:
        return np.zeros((0, len(classes)), np.float32), classes
    if k > len(train_x):
        raise ValueError(
            f"Expected n_neighbors <= n_samples_fit, but "
            f"n_neighbors = {k}, n_samples_fit = {len(train_x)}")
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    d2 = squared_distances(put(query, np.float32), put(train_x, np.float32))
    votes = put(class_idx, np.int64)[nearest(d2, k)]          # (Q, k)
    onehot = torch.nn.functional.one_hot(votes, len(classes))
    return onehot.to(torch.float32).mean(dim=1).cpu().numpy(), classes
