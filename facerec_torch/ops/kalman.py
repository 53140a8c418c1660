"""Batched constant-velocity Kalman filtering for box tracking.

Port of ``facerec_tpu/ops/kalman.py``.  State per track is the 8-vector
``[cx, cy, area, aspect, d cx, d cy, d area, d aspect]`` observed as
``[cx, cy, area, aspect]``; the whole fixed-capacity track table
predicts and updates at once, with the Joseph-form covariance update.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DIM_X = 8
DIM_Z = 4

F_NP = np.eye(DIM_X, dtype=np.float32) + np.eye(DIM_X, k=4, dtype=np.float32)
H_NP = np.eye(DIM_Z, DIM_X, dtype=np.float32)
R_NP = np.diag(np.array([1.0, 1.0, 10.0, 10.0], np.float32))
Q_NP = np.eye(DIM_X, dtype=np.float32)
Q_NP[4:, 4:] *= 0.01
Q_NP[7, 7] *= 0.01
P0_NP = np.eye(DIM_X, dtype=np.float32)
P0_NP[4:, 4:] *= 1000.0
P0_NP *= 10.0


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


class KalmanState(NamedTuple):
    x: torch.Tensor  # (T, 8) state means
    p: torch.Tensor  # (T, 8, 8) state covariances


def init_state(num_tracks: int, device: torch.device) -> KalmanState:
    p0 = torch.from_numpy(P0_NP).to(device)
    return KalmanState(
        x=torch.zeros((num_tracks, DIM_X), dtype=torch.float32,
                      device=device),
        p=p0.expand(num_tracks, DIM_X, DIM_X).clone())


def reset_tracks(state: KalmanState, mask: torch.Tensor,
                 z: torch.Tensor) -> KalmanState:
    """Re-initialize the masked tracks from measurements ``z`` (T, 4):
    state = [z, 0,0,0,0], covariance = P0."""
    x_new = torch.cat([z, torch.zeros_like(z)], dim=-1)
    p_new = _const(P0_NP, state.p).expand_as(state.p)
    m = mask[:, None]
    return KalmanState(x=torch.where(m, x_new, state.x),
                       p=torch.where(m[..., None], p_new, state.p))


def predict(state: KalmanState) -> KalmanState:
    """Advance all tracks one frame; a velocity that would drive area
    or aspect non-positive is zeroed first."""
    x, p = state
    f = _const(F_NP, x)
    q = _const(Q_NP, x)
    vel_area = torch.where(x[:, 6] + x[:, 2] < 1e-3, 0.0, x[:, 6])
    vel_aspect = torch.where(x[:, 7] + x[:, 3] < 1e-3, 0.0, x[:, 7])
    x = torch.cat([x[:, :6], vel_area[:, None], vel_aspect[:, None]], dim=1)
    x = x @ f.T
    p = f @ p @ f.T + q
    return KalmanState(x, p)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` summed in index order, without fused
    multiply-adds (a product of a library fixes no summation order)."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _inv2(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2×2 inverse."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def inv4(s: torch.Tensor) -> torch.Tensor:
    """Batched 4×4 inverse via the 2×2 block Schur complement (the
    innovation covariance S = P₄₄ + R is well conditioned)."""
    a = s[..., :2, :2]
    b = s[..., :2, 2:]
    c = s[..., 2:, :2]
    d = s[..., 2:, 2:]
    ai = _inv2(a)
    aib = _mm(ai, b)
    si = _inv2(d - _mm(c, aib))
    ca = _mm(c, ai)
    tl = ai + _mm(_mm(aib, si), ca)
    tr = _mm(-aib, si)
    bl = _mm(-si, ca)
    return torch.cat([torch.cat([tl, tr], -1),
                      torch.cat([bl, si], -1)], -2)


def update(state: KalmanState, z: torch.Tensor,
           mask: torch.Tensor) -> KalmanState:
    """Measurement update of the tracks where ``mask`` (T,) is True;
    ``z`` (T, 4) is ignored elsewhere."""
    x, p = state
    h = _const(H_NP, x)
    r = _const(R_NP, x)
    eye = torch.eye(DIM_X, dtype=torch.float32, device=x.device)

    # H selects: the products by H are exact
    y = z - x @ h.T                                    # innovation
    s = h @ p @ h.T + r                                # (T, 4, 4)
    k = _mm(p @ h.T, inv4(s))                          # (T, 8, 4)

    x_post = x + _mm(k, y[..., None])[..., 0]
    ikh = eye - k @ h
    p_post = (_mm(_mm(ikh, p), ikh.transpose(1, 2))
              + _mm(_mm(k, r), k.transpose(1, 2)))

    m = mask[:, None]
    return KalmanState(x=torch.where(m, x_post, x),
                       p=torch.where(m[..., None], p_post, p))
