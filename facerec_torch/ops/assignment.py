"""Linear assignment for the tracker.

Port of ``facerec_tpu/ops/assignment.py``: the Jonker–Volgenant
shortest-augmenting-path solver and the IoU association with its
argmax fast path.  The vectors stay on the tracker's device; the
solver's data-dependent loops are driven from the host, one scalar
read per search step, and run only on frames whose association has a
genuine conflict.
"""
from __future__ import annotations

from typing import Dict, List

import torch

_INF = 3.0e38

# Associations that took the exact solve (one per frame that reached it;
# the plain tracker's frames).  The tracker's tests and chip_smoke.py
# read it to show that a stream really exercises the solver.
solves: Dict[str, int] = {"jv": 0}


def solve_lap_min(cost: torch.Tensor) -> torch.Tensor:
    """Minimum-cost perfect assignment of a square (K, K) float32 cost
    matrix (finite everywhere) → (K,) int32 ``col_for_row``."""
    k = cost.shape[0]
    if cost.shape != (k, k):
        raise ValueError(f"expected a square cost matrix, got {cost.shape}")
    dev = cost.device
    cost = cost.to(torch.float32)
    arange = torch.arange(k, device=dev)
    u = torch.zeros(k, dtype=torch.float32, device=dev)
    v = torch.zeros(k, dtype=torch.float32, device=dev)
    # integer bookkeeping stays on the host: it steers the loops
    col4row: List[int] = [-1] * k
    row4col: List[int] = [-1] * k

    for cur_row in range(k):
        min_cur = torch.zeros((), dtype=torch.float32, device=dev)
        min_val = torch.full((k,), _INF, dtype=torch.float32, device=dev)
        path = torch.full((k,), -1, dtype=torch.int64, device=dev)
        scanned_rows = torch.zeros(k, dtype=torch.bool, device=dev)
        scanned_cols = torch.zeros(k, dtype=torch.bool, device=dev)
        i = cur_row
        while True:
            scanned_rows[i] = True
            remaining = ~scanned_cols
            reduced = min_cur + cost[i] - u[i] - v
            better = remaining & (reduced < min_val)
            min_val = torch.where(better, reduced, min_val)
            path = torch.where(better, i, path)
            masked = torch.where(remaining, min_val, _INF)
            jt = torch.argmin(masked)
            min_cur = masked[jt]
            scanned_cols[jt] = True
            j = int(jt)
            if row4col[j] < 0:
                sink = j
                break
            i = row4col[j]

        # dual updates (keep reduced costs non-negative)
        u[cur_row] += min_cur
        other_rows = scanned_rows & (arange != cur_row)
        assigned = torch.tensor(col4row, device=dev).clamp(0, k - 1)
        u = torch.where(other_rows, u + min_cur - min_val[assigned], u)
        v = torch.where(scanned_cols, v - (min_cur - min_val), v)

        # augment along the alternating path ending at the sink
        path_l = path.tolist()
        j = sink
        while True:
            i = path_l[j]
            row4col[j] = i
            j_next = col4row[i]
            col4row[i] = j
            if i == cur_row:
                break
            j = j_next
    return torch.tensor(col4row, dtype=torch.int32, device=dev)


def solve_lap_max(utility: torch.Tensor) -> torch.Tensor:
    """Maximum-utility perfect assignment."""
    return solve_lap_min(-utility)


def associate(iou: torch.Tensor, det_valid: torch.Tensor,
              trk_valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Associate padded detections with padded tracks by IoU.

    Sub-threshold pairs are demoted to -1 utility before the optimal
    assignment and discarded after it.

    Args:
        iou: (D, T) IoU between detection and track boxes.
        det_valid: (D,) bool — real detections.
        trk_valid: (T,) bool — live tracks.

    Returns:
        (D,) int32 matched track slot per detection, -1 if none.
    """
    d, t = iou.shape
    k = max(d, t)
    pair_ok = det_valid[:, None] & trk_valid[None, :] & (iou >= iou_threshold)
    utility = torch.where(pair_ok, iou, -1.0)

    def solve() -> torch.Tensor:
        solves["jv"] += 1
        padded = torch.full((k, k), -2.0, dtype=torch.float32,
                            device=iou.device)
        padded[:d, :t] = utility
        col4row = solve_lap_max(padded)[:d]
        in_range = col4row < t
        col_clipped = col4row.clamp(0, t - 1).long()
        good = (in_range & det_valid
                & torch.gather(pair_ok, 1, col_clipped[:, None])[:, 0])
        return torch.where(good, col4row, -1)

    if d > t:
        # with more rows than real columns the -1/-2 padding can move
        # the optimum away from the row argmaxes: always solve exactly
        return solve()

    # Fast path: every active detection has a strictly unique row
    # maximum and the argmax columns are distinct, so assigning each
    # its argmax is THE optimum.  Covers almost every frame.
    active = pair_ok.any(dim=1)
    best = torch.argmax(utility, dim=1).to(torch.int32)
    best_val = utility.max(dim=1).values
    tied = (utility == best_val[:, None]).sum(dim=1) > 1
    arange_t = torch.arange(t, dtype=torch.int32, device=iou.device)
    taken = (active[:, None] & (best[:, None] == arange_t[None, :])).sum(0)
    fast_ok = ~(taken > 1).any() & ~(tied & active).any()
    if bool(fast_ok):
        return torch.where(active, best, -1)
    return solve()
