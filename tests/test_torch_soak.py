"""The port's film-scale soak (``facerec_torch/tools/soak.py``), cut to
size for the CPU: bounded RSS, monotone checkpoint progress, healthy
output files, on the delta-I420 wire with grouped fetches."""
import os

import pytest

from facerec_torch.tools.soak import run_soak


def test_soak_small_yuv420_delta(tmp_path):
    """≈200 frames, fetch 2, checkpoint 2, the mp4 film with images."""
    report = run_soak(
        str(tmp_path / "soak"), n_frames=200, width=192, height=144,
        block_frames=16, checkpoint_every=2, fetch_every=2,
        decode_workers=0, rss_budget_gb=8.0, device="cpu",
        monitor_interval=0.05)
    assert report["pass"], report["failures"]
    assert report["wire_format"] == "yuv420-delta"
    assert report["frames_processed"] == 200
    assert report["ckpt_samples"] >= 2
    first, last = report["ckpt_first_last"]
    assert first < last
    assert report["saved_boxes"] > 0
    assert report["n_face_images"] == report["saved_boxes"]
    assert os.path.exists(tmp_path / "soak" / "soak_report.json")


def test_soak_in_memory_film_without_images(tmp_path):
    """The card host's setting: painted frames, no JPEG codec."""
    report = run_soak(
        str(tmp_path / "soak"), n_frames=120, width=128, height=96,
        block_frames=16, checkpoint_every=2, fetch_every=2,
        save_images=False, in_memory=True, device="cpu",
        monitor_interval=0.05)
    assert report["pass"], report["failures"]
    assert report["film"] == "in memory" and report["n_face_images"] == 0


@pytest.mark.slow
def test_soak_trimmed(tmp_path):
    report = run_soak(
        str(tmp_path / "soak"), n_frames=2000, width=256, height=192,
        block_frames=64, checkpoint_every=4, fetch_every=4,
        rss_budget_gb=8.0, device="cpu")
    assert report["pass"], report["failures"]
    assert report["frames_processed"] == 2000
    assert report["ckpt_samples"] >= 2
    first, last = report["ckpt_first_last"]
    assert first < last
    assert report["saved_boxes"] > 0
    assert report["n_face_images"] == report["saved_boxes"]
    assert report["features_bytes"] > 0


@pytest.mark.parametrize("kw", [
    dict(n_frames=70, cuts=(30,), seed=21),
    dict(n_frames=40, width=128, height=96, cuts=(0, 13, 14, 39), seed=5,
         n_faces=3, identities=5)])
def test_painted_clip_equals_make_frames(kw):
    """paint_frames paints each block as it is read: the bytes and truth
    of make_frames, on blocks that straddle the cuts, after a pickle
    (what a worker process receives) and read whole."""
    import pickle

    import numpy as np

    from facerec_torch.video.synth import make_frames, paint_frames

    want, got = make_frames(**kw), paint_frames(**kw)
    frames = pickle.loads(pickle.dumps(got.frames))
    assert len(pickle.dumps(got.frames)) < 1000     # its arguments only
    for a in range(0, kw["n_frames"], 9):
        np.testing.assert_array_equal(frames[a:a + 16], want.frames[a:a + 16])
    np.testing.assert_array_equal(np.stack(list(got.frames)), want.frames)
    np.testing.assert_array_equal(got.frames[kw["n_frames"] - 1],
                                  want.frames[-1])
    assert got.frames.shape == want.frames.shape
    assert got.truth_ids == want.truth_ids
    for f, entries in want.truth.items():
        for (wb, wl), (gb, gl) in zip(entries, got.truth[f]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gl, wl)


def test_soak_report_samples_rss_at_each_checkpoint(tmp_path):
    report = run_soak(
        str(tmp_path / "soak"), n_frames=96, width=128, height=96,
        block_frames=16, checkpoint_every=1, fetch_every=1,
        save_images=False, in_memory=True, device="cpu",
        monitor_interval=0.02)
    assert report["pass"], report["failures"]
    samples = report["ckpt_rss_gb"]
    frames = [f for f, _ in samples]
    assert frames == sorted(set(frames))
    assert all(f % 16 == 0 and 16 <= f <= 96 for f in frames)
    assert len(samples) == report["ckpt_samples"] >= 2
    assert all(0 < rss <= report["max_rss_gb"] for _, rss in samples)
    assert 0 < report["start_rss_gb"] <= report["max_rss_gb"]
