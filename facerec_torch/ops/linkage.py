"""Complete-linkage agglomerative clustering on the device.

Port of ``facerec_tpu/ops/linkage.py``.  The O(N²) distance matrix is
one float32 matrix product; the greedy merge loop runs over that matrix
on its device, N - 1 steps of an argmin, a row/column max-update and an
INF fill.  The loop never reads a value back: each step's indices stay
1-element device tensors, and the merges land in a preallocated
(N - 1, 2) tensor that comes back to the host once.  N is ~10³
trajectories per film.

The host then reproduces scipy's ``fcluster(..., criterion="maxclust")``
1-based numbering from the merge sequence (:func:`fcluster_from_merges`,
copied from the JAX package); the label values, not only the partition,
are part of the contract.
"""
from __future__ import annotations

import numpy as np
import torch

from facerec_torch.runtime.device import resolve_device

_INF = 3.0e38


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix of (N, dim) float32 rows through one
    matrix product, in the JAX package's form: |x|² − 2x·xᵀ + |y|²,
    clamped at 0, then sqrt (``torch.cdist`` rounds differently)."""
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def complete_linkage_merges(dist: torch.Tensor) -> torch.Tensor:
    """Full agglomeration sequence from an (N, N) distance matrix, on
    its device.

    Returns (N-1, 2) int64 on the same device: per merge step (ascending
    height for the monotone complete-linkage criterion), the two merged
    clusters identified by their row index = lowest member point index;
    the merged cluster continues under the smaller row index.  Ties go
    to the lowest flat index, as ``jnp.argmin``'s do.
    """
    n = dist.shape[0]
    dev = dist.device
    d = dist.to(torch.float32).clone()
    d.fill_diagonal_(_INF)
    merges = torch.empty((max(n - 1, 0), 2), dtype=torch.int64, device=dev)
    for step in range(n - 1):
        flat = torch.argmin(d).reshape(1)
        a, b = flat // n, flat % n
        i, j = torch.minimum(a, b), torch.maximum(a, b)
        # complete linkage: the new cluster's distance is the max
        row = torch.maximum(d.index_select(0, i), d.index_select(0, j))
        row.index_fill_(1, i, _INF)
        row.index_fill_(1, j, _INF)
        d.index_copy_(0, i, row)
        d.index_copy_(1, i, row.T)
        d.index_fill_(0, j, _INF)
        d.index_fill_(1, j, _INF)
        merges[step] = torch.cat([i, j])
    return merges


def fcluster_from_merges(merges: np.ndarray, n: int,
                         n_clusters: int) -> np.ndarray:
    """scipy ``fcluster(..., criterion="maxclust")`` labels from a
    recorded merge sequence.

    Reproduces scipy's numbering (scipy/cluster/_hierarchy.pyx
    ``cluster_monocrit`` + ``label``): linkage rows get cluster ids
    n+row with children ordered smaller-id first; the tree walk
    descends into unvisited internal children (left then right) before
    labeling a node's leaf children, a below-cutoff internal node
    claims the next label for its whole subtree on first entry, and a
    leaf outside any such subtree is a singleton claiming the next
    label where the walk assigns it.
    """
    n_clusters = int(n_clusters)
    if n == 1 or n_clusters >= n:
        # t >= n: scipy returns identity labels, skipping the tree walk
        return np.arange(1, n + 1, dtype=np.int32)
    id_of = list(range(n))          # root point index → scipy cluster id
    children = {}                   # scipy id → (left_id, right_id)
    for k, (i, j) in enumerate(np.asarray(merges)):
        a, b = id_of[i], id_of[j]
        children[n + k] = (a, b) if a < b else (b, a)
        id_of[i] = n + k

    # Internal nodes that are maximal below the maxclust cut (= merged
    # within the first n - n_clusters height-ordered rows).  t <= 0:
    # scipy's bisection ends below the smallest merge height — no node
    # qualifies and every point becomes a traversal-order singleton.
    active = set()
    for k in range(n - n_clusters if n_clusters > 0 else 0):
        active.discard(children[n + k][0])
        active.discard(children[n + k][1])
        active.add(n + k)

    labels = np.zeros(n, np.int32)
    nc = 0
    leader = -1
    visited = set()
    stack = [2 * n - 2]
    while stack:
        node = stack[-1]
        left, right = children[node]
        if leader == -1 and node in active:
            leader = node
            nc += 1
        if left >= n and left not in visited:
            visited.add(left)
            stack.append(left)
            continue
        if right >= n and right not in visited:
            visited.add(right)
            stack.append(right)
            continue
        if left < n:
            if leader == -1:
                nc += 1
            labels[left] = nc
        if right < n:
            if leader == -1:
                nc += 1
            labels[right] = nc
        if leader == node:
            leader = -1
        stack.pop()
    return labels


def cluster_vectors(vectors: np.ndarray, n_clusters: int,
                    device=None) -> np.ndarray:
    """Embeddings → scipy-fcluster-identical labels (1-based), with the
    distance product and the merge loop on ``device`` (the card unless
    ``"cpu"`` is asked for)."""
    n = len(vectors)
    if n == 0:
        return np.zeros((0,), np.int32)
    if n == 1:
        return np.ones((1,), np.int32)
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)
    merges = complete_linkage_merges(pairwise_distances(x)).cpu().numpy()
    return fcluster_from_merges(merges, n, n_clusters)
