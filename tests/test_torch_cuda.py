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
    bit-equal to the plain versions; one launch counted per call, under
    the entry point's own key.  The white frames in grayscale are the
    constant bin-255 case."""
    frames = torch.from_numpy(_rgb(kind, shape)).to(card)
    lo, hi = scene.crop_bounds(shape[1], shape[2], crop)
    before = dict(eqm.launches)
    y, hist = eqm.hist256_rgb(frames, lo, hi, grayscale)
    assert eqm.launches == {**before, "hist256_rgb": before["hist256_rgb"] + 1}
    hist_plane = eqm.hist256(y)
    assert eqm.launches["hist256"] == before["hist256"] + 1
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


@pytest.mark.parametrize("n", [40, 300])
def test_linkage_loop_card_equals_cpu_on_the_cards_matrix(card, n):
    """The merge loop on the card records what the CPU loop records on
    the card's own distance matrix, duplicates (exact ties) included."""
    from facerec_torch.ops import linkage

    rng = np.random.default_rng(n)
    base = rng.normal(size=(n // 2, 16)).astype(np.float32)
    x = np.concatenate([base, base[: n - n // 2]])
    dist = linkage.pairwise_distances(torch.from_numpy(x).to(card))
    got = linkage.complete_linkage_merges(dist).cpu()
    want = linkage.complete_linkage_merges(dist.cpu())
    assert torch.equal(got, want)


def test_knn_selection_card_equals_cpu_on_the_cards_matrix(card):
    """The stable sort on the card picks the CPU's neighbours, ties
    (repeated training rows) to the lower index."""
    from facerec_torch.ops import knn

    rng = np.random.default_rng(0)
    train = np.repeat(rng.normal(size=(30, 16)), 4, axis=0)
    query = np.concatenate([train[::7], rng.normal(size=(200, 16))])
    d2 = knn.squared_distances(
        torch.from_numpy(query.astype(np.float32)).to(card),
        torch.from_numpy(train.astype(np.float32)).to(card))
    for k in (1, 4, 10):
        assert torch.equal(knn.nearest(d2, k).cpu(),
                           knn.nearest(d2.cpu(), k))


def test_train_step_card_equals_cpu(card):
    """One detector step (width 16, 64², batch 4) and one FaceNet step (2
    identities × 2 crops) from one initial state: the card's loss,
    gradients, batch statistics and Adam update against the CPU's, at
    the tolerances and dtypes of ``chip_smoke.py``'s ``train`` phase."""
    import chip_smoke as cs

    cases = cs.train_cases(size=64, batch=4, n_ids=2, per_id=2, width=16)
    for name, (make, batch) in cases.items():
        row, failed = cs.step_parity_row(name, make, batch, card)
        assert not failed, (failed, row)


@pytest.mark.parametrize("b,h,w", [(4, 144, 192), (2, 576, 768)])
def test_delta_i420_to_rgb_card_equals_cpu(card, b, h, w):
    """The wire decode is the same float64 code on both devices: bit
    for bit, wraparound deltas included."""
    from facerec_torch.ops import yuv

    rng = np.random.default_rng(h)
    wire = torch.from_numpy(rng.integers(0, 256, (b, yuv.i420_rows(h), w),
                                         dtype=np.uint8))
    got = yuv.delta_i420_to_rgb(wire.to(card), h).cpu()
    assert torch.equal(got, yuv.delta_i420_to_rgb(wire, h))
    assert torch.equal(yuv.delta_decode(wire.to(card)).cpu(),
                       yuv.delta_decode(wire))


def test_grouped_rgb_delta_extract_card_equals_cpu(card, tmp_path):
    """rgb-delta with fetch groups of 3 and checkpoints: the card's
    trajectories, scene changes and features are the CPU's (features
    within 1e-5), and the scene kernels ran once per block."""
    import json
    import os

    from facerec_torch.config import ExtractConfig
    from facerec_torch.pipeline.extract import run_extract
    from facerec_torch.tools.soak import StubBank
    from facerec_torch.video.synth import ScriptedDetector

    clip = make_frames(70, width=192, height=144, seed=3, cuts=(30,),
                       path="125261-Card.mp4")
    cfg = ExtractConfig(block_frames=16, save_images=False, resume=False,
                        wire_format="rgb-delta", fetch_every_blocks=3,
                        checkpoint_every_blocks=3)
    outs = {}
    for dev in (card, torch.device("cpu")):
        before = dict(eqm.launches)
        run_extract(clip, cfg, str(tmp_path / dev.type),
                    detector=ScriptedDetector(clip),
                    embedders=StubBank(device=dev), device=dev)
        if dev.type == "cuda":
            assert eqm.launches["hist256_rgb"] == before["hist256_rgb"] + 5
            assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 5
        outs[dev.type] = os.path.join(str(tmp_path / dev.type),
                                      "125261-data")
    for sub in ("trajectories", "scene_changes"):
        for name in os.listdir(os.path.join(outs["cpu"], sub)):
            a, b = (open(os.path.join(outs[k], sub, name), "rb").read()
                    for k in ("cuda", "cpu"))
            assert a == b, (sub, name)
    (name,) = os.listdir(os.path.join(outs["cpu"], "features"))
    recs = [[json.loads(l) for l in open(os.path.join(outs[k], "features",
                                                      name))]
            for k in ("cuda", "cpu")]
    assert recs[1] and len(recs[0]) == len(recs[1])
    for a, b in zip(*recs):
        ea, eb = a.pop("embeddings"), b.pop("embeddings")
        assert a == b
        for k in ea:
            np.testing.assert_allclose(ea[k], eb[k], rtol=0, atol=1e-5)
