"""Shot-boundary detection over a block of frames.

Port of ``facerec_tpu/ops/scene.py``: the same statistics and fixed
thresholds ("Fast Pixel-Based Video Scene Change Detection"), a whole
block of frames at once, with only the last frame's planes plus four
scalars carried across blocks.  Luminance and per-frame histogram
equalization run on the hand-written CUDA kernels
(:mod:`facerec_torch.ops.equalize`) when the frames are on the card:
they read the uint8 frames directly.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# luminance lives beside the kernel that computes it; scene.luminance
# stays a name of this module
from facerec_torch.ops.equalize import (  # noqa: F401
    cum_lookup, cum_lookup_plain, hist256_rgb, hist256_rgb_plain, luminance,
    pack_planes)


class SceneState(NamedTuple):
    """Cross-block carry.  Planes are (R, W) with rows padded to a
    multiple of 8 by -1; ``n_seen`` counts frames consumed so far."""

    prev_y: torch.Tensor        # (R, W) f32 luminance of last frame
    prev_eq: torch.Tensor       # (R, W) f32 RAW equalization of last frame
    prev_mafd_eq: torch.Tensor  # () float32
    prev_fv_eq: torch.Tensor    # () float32
    n_seen: torch.Tensor        # () int32


def initial_state(height: int, width: int, crop: bool = True,
                  device: torch.device = torch.device("cpu")
                  ) -> SceneState:
    """Fresh carry for frames of the given full dimensions, on
    ``device``; the planes use the post-crop height."""
    lo, hi = crop_bounds(height, width, crop)
    zero = pack_planes(torch.zeros((1, hi - lo, width), dtype=torch.float32,
                                   device=device))[0]
    scalar = torch.zeros((), dtype=torch.float32, device=device)
    return SceneState(prev_y=zero, prev_eq=zero.clone(),
                      prev_mafd_eq=scalar, prev_fv_eq=scalar.clone(),
                      n_seen=torch.zeros((), dtype=torch.int32,
                                         device=device))


def crop_bounds(height: int, width: int, crop: bool) -> Tuple[int, int]:
    """Static center 2:1 crop bounds: rows [inset, H-inset)."""
    if crop and width / height < 2.0:
        inset = int((height - 0.5 * width) / 2)
        return inset, height - inset
    return 0, height


def decide(mafd, mafd_eq, sdmafd_eq, adfv_eq) -> torch.Tensor:
    """The fixed-threshold decision rule, elementwise over a block;
    earlier rules take precedence."""
    r4 = (mafd_eq > 50) & (mafd > 35) & (sdmafd_eq > 50) & (adfv_eq > 50)
    r3 = (adfv_eq < 2) | (sdmafd_eq < 5)          # → False
    r2 = (mafd_eq < 85) & (mafd > 170)            # → True
    r1 = (mafd_eq < 100) & (mafd_eq > 58) & (mafd < 100) & (adfv_eq > 23)
    r0 = (mafd < 14) | (mafd_eq < 40)             # → False
    out = r4 & ~r3
    out = out | r2
    out = out | r1
    return out & ~r0


def detect_block(frames: torch.Tensor, state: SceneState, crop: bool = True,
                 grayscale: bool = False) -> Tuple[torch.Tensor, SceneState]:
    """Scene-change flags for a block of frames.

    Args:
        frames: (B, H, W, 3) uint8 RGB frames, consecutive in time, on
            the state's device.
        state: carry from the previous block (or :func:`initial_state`).
        crop: apply the center 2:1 crop.
        grayscale: treat channel 0 as luminance.

    Returns:
        (flags (B,) bool, new_state).
    """
    b, height, width, _ = frames.shape
    lo, hi = crop_bounds(height, width, crop)
    p = (hi - lo) * width

    if frames.device.type == "cuda":
        # the kernels read the uint8 frames and write the packed plane
        y, counts = hist256_rgb(frames.contiguous(), lo, hi, grayscale)
        eq, cum = cum_lookup(y, counts)
    else:
        y, counts = hist256_rgb_plain(frames, lo, hi, grayscale)
        eq, cum = cum_lookup_plain(y, counts)

    # Padding rows hold -1 in y and 0 in eq for every frame, so they add
    # 0 to the diffs; dividing by p keeps the means over real pixels.
    scale = 255.0 / p

    def diffs(cur, prev_plane, s=1.0):
        inb = (cur[1:] * s - cur[:-1] * s).abs().sum(dim=(1, 2))
        carry = (cur[0] * s - prev_plane * s).abs().sum()
        return torch.cat([carry[None], inb]) / p

    mafd = diffs(y, state.prev_y)
    mafd_eq = diffs(eq, state.prev_eq, scale)

    # fv = mean|eq - mafd_eq| is an expectation over the ≤256 distinct
    # equalized values: computed from the histogram, not the pixels.
    hist = torch.diff(cum, dim=-1, prepend=torch.zeros_like(cum[:, :1]))
    eqval = cum * scale
    fv_eq = (hist * (eqval - mafd_eq[:, None]).abs()).sum(dim=-1) / p

    mafd_eq_prev = torch.cat([state.prev_mafd_eq[None], mafd_eq[:-1]])
    fv_eq_prev = torch.cat([state.prev_fv_eq[None], fv_eq[:-1]])
    sdmafd_eq = mafd_eq - mafd_eq_prev
    adfv_eq = (fv_eq - fv_eq_prev).abs()

    # frame i (global index n_seen + i) needs two predecessors
    global_idx = state.n_seen + torch.arange(b, dtype=torch.int32,
                                             device=frames.device)
    flags = decide(mafd, mafd_eq, sdmafd_eq, adfv_eq) & (global_idx >= 2)

    new_state = SceneState(
        prev_y=y[-1].clone(),
        prev_eq=eq[-1].clone(),
        prev_mafd_eq=mafd_eq[-1].clone(),
        prev_fv_eq=fv_eq[-1].clone(),
        n_seen=state.n_seen + b,
    )
    return flags, new_state
