"""The selfcheck and its synthetic training data against the JAX
package's (CPU).

``synth_batch`` and ``identity_crops`` give byte-identical arrays for
one generator state and leave it in the same state; the port's uint8
bilinear resize equals ``cv2.resize`` (INTER_LINEAR) byte for byte on
the crop windows ``identity_crops`` draws and beyond.
``deploy_style_batch``'s anti-aliased downscale lands within 1 LSB of
``jax.image.resize``'s after rounding (at most 0.1% of the pixels
differ); targets are exact, and so is the whole batch at scale 1.
``cluster_purity``, ``check_gates`` and ``trajectory_identities`` give
the JAX package's results.  A tiny selfcheck runs end to end on the CPU.
"""
import json
import os

import numpy as np
import pytest

from facerec_tpu.tools import selfcheck as J
from facerec_tpu.video import synth as JS

from facerec_torch.tools import selfcheck as T
from facerec_torch.video import synth as TS

DEPLOY_LSB = 1
DEPLOY_SHARE = 1e-3


def _same_state(ra, rb):
    assert ra.integers(1 << 62) == rb.integers(1 << 62)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(identities=5, identity_base=1000),
    dict(max_faces=1, face_size=(12.0, 30.0)),
])
def test_synth_batch_is_byte_identical(kw):
    for seed in range(2):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):
            want = JS.synth_batch(ra, 3, 96, 64, **kw)
            got = TS.synth_batch(rb, 3, 96, 64, **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
        _same_state(ra, rb)


@pytest.mark.parametrize("identity", [0, 2, 1003])
def test_identity_crops_are_byte_identical(identity):
    ra, rb = np.random.default_rng(identity), np.random.default_rng(identity)
    want = JS.identity_crops(ra, identity, 12)
    got = TS.identity_crops(rb, identity, 12)
    assert got.dtype == np.uint8 and got.shape == (12, 160, 160, 3)
    np.testing.assert_array_equal(got, want)
    _same_state(ra, rb)


def test_linear_resize_equals_opencv():
    """Every square window from 18 to 60 px (``identity_crops`` draws
    about 21–55) up to 160, plus non-square, other targets and
    downscales."""
    import cv2

    rng = np.random.default_rng(0)
    cases = [((s, s), (160, 160)) for s in range(18, 61)]
    cases += [((37, 23), (160, 96)), ((30, 41), (64, 200)),
              ((160, 160), (40, 40)), ((97, 61), (33, 50)),
              ((25, 25), (25, 25))]
    for (h, w), (oh, ow) in cases:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(TS.resize_linear_u8(img, ow, oh), want,
                                      err_msg=f"{(h, w)} -> {(oh, ow)}")


@pytest.mark.parametrize("deploy_hw,input_size", [
    ((288, 384), (384, 384)),      # the pinned probe budget: scale 1
    ((120, 160), (64, 64)),        # downscale + letterbox
])
def test_deploy_style_batch_matches_jax(deploy_hw, input_size):
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    want = J.deploy_style_batch(ra, 2, input_size, deploy_hw, (28.0, 44.0))
    got = T.deploy_style_batch(rb, 2, input_size, deploy_hw, (28.0, 44.0))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    diff = np.abs(got[0].astype(int) - want[0].astype(int))
    if input_size == (384, 384):
        assert not diff.any()
    assert diff.max() <= DEPLOY_LSB and diff.mean() <= DEPLOY_SHARE
    _same_state(ra, rb)


def test_cluster_purity_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        clusters = rng.integers(0, 5, n)
        ids = rng.integers(-1, 4, n)
        assert T.cluster_purity(clusters, ids) == J.cluster_purity(clusters,
                                                                   ids)
    assert T.cluster_purity([0, 1], [-1, -1]) == (None, {0: -1, 1: -1})


@pytest.mark.parametrize("report,kw", [
    ({}, {}),
    ({"detection": {"precision": 1.0, "recall": 0.861},
      "cluster_purity": 1.0, "classify_accuracy": 1.0,
      "scene_cuts_found": [60, 120], "scene_cuts_truth": [60, 120]},
     {"min_recall": 0.8}),
    ({"detection": {"precision": 0.5, "recall": 0.95},
      "cluster_purity": None, "classify_accuracy": 0.95,
      "scene_cuts_found": [60], "scene_cuts_truth": [60, 120]}, {}),
])
def test_check_gates_matches_jax(report, kw):
    assert T.check_gates(report, **kw) == J.check_gates(report, **kw)


def test_trajectory_identities_match_jax(tmp_path):
    clip = TS.make_frames(30, cuts=(15,), n_faces=2, identities=3, seed=2)
    rng = np.random.default_rng(0)
    with open(tmp_path / "trajectories.jsonl", "w") as f:
        for start in (0, 5, 16):
            for g in range(2):
                bbs = []
                for fr in range(start, start + 8):
                    box = np.asarray(clip.truth[fr][g][0], float)
                    bbs.append((box + rng.normal(0, 4, 4)).tolist())
                f.write(json.dumps({"start": start, "bbs": bbs}) + "\n")
        f.write(json.dumps({"start": 2, "bbs": [[0, 0, 3, 3]] * 4}) + "\n")
    got = T.trajectory_identities(str(tmp_path), clip)
    assert got == J.trajectory_identities(str(tmp_path), clip)
    assert got[-1] == -1 and set(got[:-1]) <= {0, 1, 2}


def test_tiny_selfcheck_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """Train 2 + 1 steps, recalibrate on 2 + 1 batches, deploy a 30-frame
    film through extract → merge → cluster → classify, score it, and
    report the gates it misses at this budget (exit 1 with --assert)."""
    for name, kw in (("recalibrate_detector", dict(n_batches=2, batch=2)),
                     ("recalibrate_embedder", dict(n_batches=1,
                                                   crops_per_id=2))):
        orig = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _o=orig, _k=kw, **k:
                            _o(*a, **_k))
    out = str(tmp_path / "sc")
    rc = T.main(["--out", out, "--device", "cpu", "--train-steps", "2",
                 "--embedder-steps", "1", "--film-width", "192",
                 "--film-height", "144", "--detector-size", "128",
                 "--identities", "3", "--film-frames", "30", "--batch", "2",
                 "--assert"])
    report = json.load(open(os.path.join(out, "selfcheck.json")))
    assert report["device"] == "cpu"
    assert report["scene_cuts_truth"] == [10, 20]
    assert set(report["wall_s"]) == {
        "train_detector", "recalibrate_detector", "train_embedder",
        "recalibrate_embedder", "deploy"}
    assert all(np.isfinite(report["detector_loss"] + report["embedder_loss"]))
    for f in ("detector.npz", "facenet/20170512-110547.npz",
              "actors/actor-images.zip", "data/777-data/predictions.json"):
        assert os.path.isfile(os.path.join(out, f)), f
    failed = T.check_gates(report, min_recall=0.9)
    assert rc == (1 if failed else 0)
    if failed:
        assert "SELFCHECK GATES FAILED" in capsys.readouterr().out
