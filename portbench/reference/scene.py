"""Shot boundaries, plainly ("Fast Pixel-Based Video Scene Change
Detection", the extract stage's fixed thresholds).

Per frame, over the centre 2:1 crop of its rows: the luminance Y
(``fma(b, w2, fma(g, w1, r * w0))`` with float32 weights, each step
rounded to float32), its 256-bin histogram and the raw equalisation
``eq = cumhist[int(Y)]``.  Between consecutive frames: mafd = mean|dY|,
mafd_eq = mean|d(eq * 255 / P)|, fv_eq = mean|eq * 255 / P - mafd_eq|,
sdmafd_eq and adfv_eq their changes; a frame is a cut by the decision
rule below, never among the first two frames of the film.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

W = [float(np.float32(w)) for w in (0.299, 0.587, 0.114)]


def crop_rows(h: int, w: int):
    if w / h < 2.0:
        inset = int((h - 0.5 * w) / 2)
        return inset, h - inset
    return 0, h


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    f32, f64 = torch.float32, torch.float64
    p = (rgb[..., 0].to(f32) * W[0]).to(f64)
    q = (p + rgb[..., 1].to(f64) * W[1]).to(f32).to(f64)
    return (q + rgb[..., 2].to(f64) * W[2]).to(f32)


def decide(mafd, mafd_eq, sdmafd_eq, adfv_eq):
    r4 = (mafd_eq > 50) & (mafd > 35) & (sdmafd_eq > 50) & (adfv_eq > 50)
    r3 = (adfv_eq < 2) | (sdmafd_eq < 5)
    r2 = (mafd_eq < 85) & (mafd > 170)
    r1 = (mafd_eq < 100) & (mafd_eq > 58) & (mafd < 100) & (adfv_eq > 23)
    r0 = (mafd < 14) | (mafd_eq < 40)
    return ((r4 & ~r3) | r2 | r1) & ~r0


def _planes(rgb: torch.Tensor, lo: int, hi: int):
    """(B, H, W, 3) uint8 → Y, eq (B, rows, W) float64, cum (B, 256)."""
    y = luminance(rgb[:, lo:hi])
    bins = y.to(torch.int64).clamp(0, 255).reshape(len(y), -1)
    hist = torch.zeros((len(y), 256), dtype=torch.float64, device=y.device)
    hist.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.float64))
    cum = hist.cumsum(1)
    eq = torch.gather(cum, 1, bins).reshape(y.shape)
    return y.to(torch.float64), eq, cum


def pool_flags(block: Callable[[int, int], np.ndarray], n: int,
               device: torch.device, chunk: int = 32):
    """Cut flags of a film that loops over ``n`` pool frames
    (``block(a, b)`` gives frames [a, b)): (first pass, every later
    pass), each (n,) bool.  A later pass differs from the first only in
    its first two frames, whose predecessors are the pool's last."""
    mafd, mafd_eq, fv = (np.zeros(n) for _ in range(3))
    prev_y = prev_eq = None
    first = None
    for a in range(0, n, chunk):
        rgb = torch.from_numpy(np.ascontiguousarray(
            block(a, min(n, a + chunk)))).to(device)
        _, h, w, _ = rgb.shape
        lo, hi = crop_rows(h, w)
        p = (hi - lo) * w
        y, eq, cum = _planes(rgb, lo, hi)
        eqs = eq * (255.0 / p)
        if prev_y is None:
            prev_y, prev_eq = torch.zeros_like(y[0]), torch.zeros_like(eqs[0])
            first = (y[0], eqs[0], cum[0])
        py = torch.cat([prev_y[None], y[:-1]])
        pe = torch.cat([prev_eq[None], eqs[:-1]])
        m = ((y - py).abs().sum((1, 2)) / p)
        me = ((eqs - pe).abs().sum((1, 2)) / p)
        hist = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
        f = (hist * (cum * (255.0 / p) - me[:, None]).abs()).sum(1) / p
        mafd[a:a + len(y)] = m.cpu().numpy()
        mafd_eq[a:a + len(y)] = me.cpu().numpy()
        fv[a:a + len(y)] = f.cpu().numpy()
        prev_y, prev_eq = y[-1], eqs[-1]
    # a later pass: frame 0 follows the pool's last frame
    y0, e0, c0 = first
    m0 = float((y0 - prev_y).abs().sum() / p)
    me0 = float((e0 - prev_eq).abs().sum() / p)
    h0 = torch.diff(c0, prepend=torch.zeros_like(c0[:1]))
    f0 = float((h0 * (c0 * (255.0 / p) - me0).abs()).sum() / p)

    def flags(m, me, f, me_prev0, f_prev0, skip_two):
        me_prev = np.concatenate([[me_prev0], me[:-1]])
        f_prev = np.concatenate([[f_prev0], f[:-1]])
        out = decide(m, me, me - me_prev, np.abs(f - f_prev))
        if skip_two:
            out[:2] = False
        return out

    first_pass = flags(mafd, mafd_eq, fv, 0.0, 0.0, True)
    later = flags(np.concatenate([[m0], mafd[1:]]),
                  np.concatenate([[me0], mafd_eq[1:]]),
                  np.concatenate([[f0], fv[1:]]), mafd_eq[-1], fv[-1], False)
    return first_pass, later
