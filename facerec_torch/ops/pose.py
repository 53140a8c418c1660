"""Face pose heuristics from 5-point landmarks.

Port of ``facerec_tpu/ops/pose.py`` (plain tensor code: the JAX
functions are XLA code outside any Pallas kernel).  A face is scored
frontal vs profile from where the nose falls along the eye line.
"""
from __future__ import annotations

import torch


def frontalness(landmarks: torch.Tensor) -> torch.Tensor:
    """Frontalness score in [0, 1] per face.

    Args:
        landmarks: (..., 5, 2) points ordered
            (left_eye, right_eye, nose, mouth_left, mouth_right).

    Returns:
        (...,) — 1 for a symmetric frontal layout, → 0 as the nose
        shifts toward either eye (yaw) or the eye line degenerates.
    """
    left_eye = landmarks[..., 0, :]
    right_eye = landmarks[..., 1, :]
    nose = landmarks[..., 2, :]

    eye_vec = right_eye - left_eye
    eye_dist = torch.linalg.vector_norm(eye_vec, dim=-1)
    safe = eye_dist.clamp_min(1e-6)
    # signed position of the nose along the eye line, 0.5 = centered
    t = ((nose - left_eye) * eye_vec).sum(-1) / (safe * safe)
    symmetry = 1.0 - ((t - 0.5).abs() * 2.0).clamp(0.0, 1.0)
    return torch.where(eye_dist > 1e-3, symmetry,
                       torch.zeros_like(symmetry))


def is_frontal(landmarks: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """Boolean frontal/profile decision per face."""
    return frontalness(landmarks) >= threshold
