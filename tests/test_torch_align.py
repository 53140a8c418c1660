"""The five-point alignment (``facerec_torch/ops/align.py``) against the
plain reference's (``tests/plain_arcface.py``: Umeyama's similarity by
SVD, the inverse map by a 3x3 inverse, four gathered taps), on the CPU:
the crops to 1e-5, the closed-form map to 1e-9, zeros outside the frame,
the degenerate rule, and swapped eyes seen.  The kernel is compared with
the plain version on the card (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from facerec_torch.ops import align
from tests import plain_arcface as plain


def face_landmarks(rng, n, width, height, scale=(0.15, 0.6), noise=1.5):
    """(n, 5, 2) float32 landmarks of faces at random places, sizes and
    tilts (the template moved, scaled, turned and jittered)."""
    out = []
    for _ in range(n):
        th = rng.uniform(-0.6, 0.6)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pts = ((plain.TEMPLATE - 56.0) @ rot.T * rng.uniform(*scale)
               + rng.uniform([-10, -10], [width + 10, height + 10])
               + rng.normal(0, noise, (5, 2)))
        out.append(pts)
    return np.float32(out)


def reference_crops(frames, idx, ldm):
    maps = np.stack([plain.similarity(l) for l in ldm])
    return plain.warp(frames[idx], maps)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.integers(0, 256, (4, 96, 128, 3),
                                         dtype=np.uint8))


def test_crops_match_the_reference(frames):
    rng = np.random.default_rng(3)
    ldm = face_landmarks(rng, 24, 128, 96)
    idx = torch.from_numpy(rng.integers(0, 4, 24))
    got = align.align_plain(frames, idx, torch.from_numpy(ldm))
    assert got.shape == (24, 3, 112, 112) and got.dtype == torch.float32
    want = reference_crops(frames, idx, ldm)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(align.align(frames, idx, torch.from_numpy(ldm)), got)


@pytest.mark.parametrize("flip", [False, True])
def test_closed_form_equals_svd(flip):
    """Umeyama by SVD and the closed form agree, also where the best
    proper map is far from a fit (mirrored sets, det < 0)."""
    rng = np.random.default_rng(5)
    ldm = face_landmarks(rng, 50, 400, 300, noise=4.0)
    if flip:
        ldm[..., 0] *= -1
    ldm = np.concatenate([ldm, np.float32(
        rng.uniform(0, 300, (20, 5, 2)))])
    got = align.inverse_maps(torch.from_numpy(ldm)).numpy().reshape(-1, 2, 3)
    full = np.zeros((len(ldm), 3, 3))
    full[:, :2] = [plain.similarity(l) for l in ldm]
    full[:, 2, 2] = 1.0
    want = np.linalg.inv(full)[:, :2]
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 1e-9


def test_zeros_outside_the_frame():
    white = torch.full((1, 40, 50, 3), 255, dtype=torch.uint8)
    # a face near the top-left corner: much of its crop lies off frame
    ldm = np.float32(plain.TEMPLATE * 0.3 - [8, 10])[None]
    got = align.align_plain(white, torch.zeros(1, dtype=torch.int64),
                            torch.from_numpy(ldm))
    want = reference_crops(white, torch.zeros(1, dtype=torch.int64), ldm)
    assert float((got - want).abs().max()) <= 1e-5
    # every pixel reads 1 (255) inside, -1 (0) where all four taps lie
    # outside, and between on the edge
    assert float(got.min()) == -1.0 and float(got.max()) == 1.0
    assert int((got == -1.0).sum()) > 0 and int((got == 1.0).sum()) > 0


def test_degenerate_rule(frames):
    """A set with no spread is mapped by the translation of its mean
    onto the template's, in the program and the reference alike, and
    only such sets are counted."""
    point = np.float32([[60.25, 40.5]] * 5)
    tiny = point + np.float32([[0, 0], [2e-4, 0], [0, 2e-4], [0, 0],
                               [1e-4, 1e-4]])
    wide = point + np.float32([[0, 0], [1e-3, 0], [0, 1e-3], [0, 0],
                               [0, 0]])
    ldm = np.stack([point, tiny, wide])
    assert align.degenerate(ldm).tolist() == [True, True, False]
    idx = torch.zeros(3, dtype=torch.int64)
    got = align.align_plain(frames, idx, torch.from_numpy(ldm))
    want = reference_crops(frames, idx, ldm)
    assert float((got - want).abs().max()) <= 1e-5
    m = align.inverse_maps(torch.from_numpy(ldm[:1])).numpy()[0]
    shift = point[0].astype(np.float64) - plain.TEMPLATE.mean(0)
    assert np.allclose(m, [1, 0, shift[0], 0, 1, shift[1]], atol=1e-12)


def test_swapped_eyes_are_seen(frames):
    rng = np.random.default_rng(9)
    ldm = face_landmarks(rng, 8, 128, 96, scale=(0.4, 0.6), noise=0.5)
    idx = torch.from_numpy(rng.integers(0, 4, 8))
    right = align.align_plain(frames, idx, torch.from_numpy(ldm))
    swapped = align.align_plain(frames, idx, torch.from_numpy(
        ldm[:, [1, 0, 2, 3, 4]]))
    assert float((right - swapped).abs().mean()) > 0.1


def test_kernel_takes_only_card_tensors(frames):
    ldm = torch.from_numpy(face_landmarks(np.random.default_rng(0), 2,
                                          128, 96))
    with pytest.raises(ValueError, match="CUDA"):
        align.align_warp(frames, torch.zeros(2, dtype=torch.int64), ldm)
    with pytest.raises(ValueError, match="landmarks"):
        align.align_plain(frames, torch.zeros(3, dtype=torch.int64), ldm)
