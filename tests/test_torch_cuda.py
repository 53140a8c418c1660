"""Checks that need the card (marker ``cuda``; they skip without one).

Run on a machine with a GPU: ``python -m pytest tests/test_torch_cuda.py
-m cuda -q``.  ``chip_smoke.py`` covers the same ground at the main
path's shapes.
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
