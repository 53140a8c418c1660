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
