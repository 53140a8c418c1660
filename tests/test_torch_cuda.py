"""Checks that need the card (marker ``cuda``; they skip without one).

Run on a machine with a GPU: ``python -m pytest tests/test_torch_cuda.py
-m cuda -q`` (add ``--noconftest`` where JAX is not installed: the
repo's conftest imports it, these tests do not).  ``chip_smoke.py``
covers the same ground at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from facerec_torch.ops import equalize as eqm
from facerec_torch.ops import scene
from facerec_torch.video.synth import make_frames

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,real_rows", [((4, 64, 96), 64),
                                             ((3, 48, 130), 41)])
def test_kernels_bit_equal_to_plain(card, shape, real_rows):
    rng = np.random.default_rng(0)
    y = np.full(shape, -1.0, np.float32)
    y[:, :real_rows] = rng.uniform(-0.5, 260, (shape[0], real_rows,
                                               shape[2]))
    y[:, 0, ::5] = np.floor(y[:, 0, ::5])
    yc = torch.from_numpy(y).to(card)
    before = dict(eqm.launches)
    eq, cum = eqm.equalize_stats(yc)
    assert eqm.launches["hist256"] == before["hist256"] + 1
    assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 1
    eq_p, cum_p = eqm.equalize_stats_plain(yc)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)


def _rgb(kind, shape, seed=0):
    """(B, H, W, 3) uint8: noise, black, white or a dark scene."""
    if kind == "black":
        return np.zeros((*shape, 3), np.uint8)
    if kind == "white":
        return np.full((*shape, 3), 255, np.uint8)
    high = 8 if kind == "dark" else 256
    return np.random.default_rng(seed).integers(
        0, high, (*shape, 3)).astype(np.uint8)


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("kind", ["noisy", "black", "white", "dark"])
@pytest.mark.parametrize("shape,crop", [
    ((4, 72, 96), True),        # W % 16 == 0: staged loads, crop to 48 rows
    ((2, 90, 192), False),      # staged, 6 padding rows
    ((3, 41, 130), False),      # ragged width: byte loads, 7 padding rows
])
def test_rgb_entry_bit_equal_to_plain(card, shape, crop, kind, grayscale):
    """hist256 from uint8 frames, and both entry points on its plane,
    bit-equal to the plain versions; one launch counted per call.  The
    white frames in grayscale are the constant bin-255 case."""
    frames = torch.from_numpy(_rgb(kind, shape)).to(card)
    lo, hi = scene.crop_bounds(shape[1], shape[2], crop)
    before = eqm.launches["hist256"]
    y, hist = eqm.hist256_rgb(frames, lo, hi, grayscale)
    assert eqm.launches["hist256"] == before + 1
    hist_plane = eqm.hist256(y)
    assert eqm.launches["hist256"] == before + 2
    eq, cum = eqm.cum_lookup(y, hist)
    y_p, hist_p = eqm.hist256_rgb_plain(frames, lo, hi, grayscale)
    eq_p, cum_p = eqm.cum_lookup_plain(y_p, hist_p)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)
    assert torch.equal(hist, hist_p) and torch.equal(hist_plane, hist_p)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)
    if kind == "white" and grayscale:
        assert int(hist[:, 255].min()) == (hi - lo) * shape[2]


@pytest.mark.parametrize("value", [0.0, 255.0, 255.5, "dark"])
def test_plane_entry_on_constant_and_dark_planes(card, value):
    shape = (3, 48, 130)
    if value == "dark":
        y = np.random.default_rng(1).uniform(0, 8, shape)
    else:
        y = np.full(shape, value)
    yc = torch.from_numpy(y.astype(np.float32)).to(card)
    before = dict(eqm.launches)
    eq, cum = eqm.equalize_stats(yc)
    assert eqm.launches["hist256"] == before["hist256"] + 1
    assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 1
    eq_p, cum_p = eqm.equalize_stats_plain(yc)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)


def test_rgb_entry_on_unaligned_frames(card):
    """Frames that do not start on a 16-byte boundary take byte loads
    and give the same result."""
    b, h, w = 2, 40, 96
    flat = torch.from_numpy(_rgb("noisy", (b, h, w))).reshape(-1).to(card)
    buf = torch.zeros(flat.numel() + 1, dtype=torch.uint8, device=card)
    buf[1:] = flat
    frames = buf[1:].view(b, h, w, 3)
    assert frames.data_ptr() % 16 and frames.is_contiguous()
    y, hist = eqm.hist256_rgb(frames, 4, 36)
    y_p, hist_p = eqm.hist256_rgb_plain(frames, 4, 36)
    assert torch.equal(y, y_p) and torch.equal(hist, hist_p)


def test_plane_entry_refuses_unaligned_plane(card):
    buf = torch.zeros(2 * 8 * 16 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        eqm.hist256(buf[1:].view(2, 8, 16))


def test_detect_block_card_equals_cpu(card):
    clip = make_frames(32, seed=4, cuts=(9, 20))
    flags = []
    for dev in (card, torch.device("cpu")):
        state = scene.initial_state(144, 192, device=dev)
        f, state = scene.detect_block(
            torch.from_numpy(clip.frames).to(dev), state)
        flags.append(f.cpu().numpy())
    np.testing.assert_array_equal(flags[0], flags[1])
    assert np.nonzero(flags[0])[0].tolist() == [9, 20]
