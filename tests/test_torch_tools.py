"""The port's tools against the JAX package's, on the CPU.

* subtitles, twins, boxdata and aspect_ratio: the same output bytes on
  the fixtures of ``tests/test_tools.py``;
* ``train_linear_svm``: the same classes, ``w``/``b`` within 1e-6
  (float32 over 500 steps: measured ≤ 1.2e-7 apart), the same argmax
  labels; ``svm_propagate``'s lines equal but for the margin's last
  float32 digits (within 1e-5);
* pose: ``frontalness`` within 1e-6 on the cases of
  ``tests/test_crops_nms.py`` and on random landmarks;
* ``embedding_eval`` and ``evaluate_detections``: reports equal;
* ``harness_predictions`` with the probe detector: valid sets equal,
  boxes within 1e-4;
* a truth pickle written by the JAX package read with JAX blocked;
* ``parity_rehearsal`` end to end with a scripted detector (no
  distillation) and, ``slow`` as the JAX package's, with distillation.
"""
import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tools import METADATA, actors_csv, movie_data  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(REPO, "tests", "data", "probe_detector_w96.npz")


def test_subtitles_equal_jax(movie_data, actors_csv, tmp_path):
    from facerec_torch.tools import subtitles
    from facerec_tpu.tools import subtitles as jax_subtitles

    outs = {}
    for key, mod in (("jax", jax_subtitles), ("port", subtitles)):
        outs[key] = tmp_path / f"{key}.ass"
        assert mod.write_subtitles(str(movie_data), str(outs[key]),
                                   actors_csv, METADATA) == 12
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert subtitles.parse_video_metadata(METADATA) == \
        jax_subtitles.parse_video_metadata(METADATA)


def _main_out(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_twins_and_boxdata_equal_jax(movie_data, actors_csv, tmp_path,
                                     capsys):
    from facerec_torch.tools import boxdata, twins
    from facerec_tpu.tools import boxdata as jax_boxdata
    from facerec_tpu.tools import twins as jax_twins

    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps(METADATA))
    argv = ["--path", str(movie_data), "--actors-csv", actors_csv,
            "--metadata", str(meta)]
    want = _main_out(jax_twins.main, argv, capsys)
    assert want and _main_out(twins.main, argv, capsys) == want
    want = _main_out(jax_boxdata.main, ["--path", str(movie_data)], capsys)
    assert len(want.splitlines()) == 6
    assert _main_out(boxdata.main, ["--path", str(movie_data)],
                     capsys) == want


def test_aspect_ratio_equal_jax(tmp_path, capsys):
    from facerec_torch.tools import aspect_ratio
    from facerec_torch.video.synth import make_clip
    from facerec_tpu.tools import aspect_ratio as jax_aspect_ratio

    clip = make_clip(str(tmp_path / "123-Ar.mp4"), n_frames=3)
    for extra in ([], ["--csv"]):
        want = _main_out(jax_aspect_ratio.main, [clip.path, *extra], capsys)
        assert want and _main_out(aspect_ratio.main, [clip.path, *extra],
                                  capsys) == want


def svm_data(rng):
    """The data of tests/test_tools.py::test_svm_propagation."""
    centers = rng.normal(size=(3, 8)) * 4
    x = np.concatenate([centers[i] + rng.normal(size=(30, 8)) * 0.3
                        for i in range(3)]).astype(np.float32)
    return x, np.repeat([5, 9, 2], 30)


def test_train_linear_svm_matches_jax(rng):
    from facerec_torch.ops.svm import decision_function, train_linear_svm
    from facerec_tpu.ops import svm as jax_svm

    x, y = svm_data(rng)
    w, b, classes = train_linear_svm(x, y, device="cpu")
    jw, jb, jclasses = jax_svm.train_linear_svm(x, y)
    np.testing.assert_array_equal(classes, jclasses)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-6)
    pred = decision_function(x, w, b, device="cpu").argmax(1)
    np.testing.assert_array_equal(
        pred, jax_svm.decision_function(x, jw, jb).argmax(1))
    assert (classes[pred] == y).mean() > 0.95


def test_svm_propagate_lines_match_jax(rng, tmp_path, capsys):
    from facerec_torch.tools import svm_propagate
    from facerec_tpu.tools import svm_propagate as jax_svm_propagate

    x, y = svm_data(rng)
    tags = [f"x123456:{100 + i}_{i}_{i + 1}_{i + 20}_{i + 30}"
            for i in range(len(y))]
    cluster_of = {5: 5, 9: 9, 2: 3}        # label → hand-labelled cluster
    (tmp_path / "c.tsv").write_text("5 Tauno\n9 Ansa\n3 Regina\n2 ?\n")
    (tmp_path / "l.txt").write_text("".join(
        f"LABEL [{cluster_of[y[i]]}] {tags[i]}\n"
        for i in range(0, len(y), 3)))
    (tmp_path / "f.dat").write_text("".join(
        " ".join(str(float(v)) for v in vec) + f" {tag}\n"
        for vec, tag in zip(x, tags)))
    argv = ["--clusters-tsv", str(tmp_path / "c.tsv"), "--labels-txt",
            str(tmp_path / "l.txt"), "--features-dat",
            str(tmp_path / "f.dat")]
    want = _main_out(jax_svm_propagate.main, argv, capsys).splitlines()
    got = _main_out(svm_propagate.main, argv + ["--device", "cpu"],
                    capsys).splitlines()
    assert len(got) == len(want) == len(y)
    for g, w in zip(got, want):
        gt, wt = g.split(" "), w.split(" ")
        assert gt[:10] + gt[11:] == wt[:10] + wt[11:]
        assert abs(float(gt[10]) - float(wt[10])) <= 1e-5
        assert ("e" in gt[10]) == ("e" in wt[10])


def test_frontalness_matches_jax():
    from facerec_torch.ops.pose import frontalness, is_frontal
    from facerec_tpu.ops import pose as jax_pose

    cases = np.array([[[10.0, 10], [30, 10], [20, 20], [13, 28], [27, 28]],
                      [[10.0, 10], [30, 10], [29, 20], [13, 28], [27, 28]],
                      [[10.0, 10], [10, 10], [10, 20], [10, 28], [10, 28]]],
                     np.float32)
    rng = np.random.default_rng(0)
    rand = rng.uniform(0, 60, (200, 5, 2)).astype(np.float32)
    rand[::7, 1] = rand[::7, 0]          # degenerate eye lines
    for ldm in (cases, rand, rand.reshape(20, 10, 5, 2)):
        got = frontalness(torch.from_numpy(ldm)).numpy()
        want = np.asarray(jax_pose.frontalness(jnp.asarray(ldm)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            is_frontal(torch.from_numpy(ldm)).numpy(),
            np.asarray(jax_pose.is_frontal(jnp.asarray(ldm))))
    s = frontalness(torch.from_numpy(cases))
    assert float(s[0]) > 0.9 and float(s[1]) < 0.2 and float(s[2]) == 0.0


def _write_features(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _rec(frame, box, vecs):
    return {"frame": frame, "box": box,
            "embeddings": {k: list(map(float, v)) for k, v in vecs.items()}}


def feature_cases(tmp_path, rng):
    """(ref, ours) file pairs of tests/test_parity_tools.py: a jittered
    near-identical pair, a divergent checkpoint, a missed face, a
    one-to-one conflict."""
    dim = 8
    ref, ours = [], []
    for f in (0, 5, 10):
        vv = rng.normal(size=(2, dim))
        for k in range(2):
            v = vv[k] / np.linalg.norm(vv[k])
            box = [10 + 40 * k, 10, 40 + 40 * k, 50]
            ref.append(_rec(f, box, {"m1": v, "m2": -v}))
            v2 = v + rng.normal(size=dim) * 1e-3
            ours.append(_rec(f, [b + 1 for b in box], {"m1": v2, "m2": -v2}))
    v, u, w = (rng.normal(size=8) for _ in range(3))
    pairs = [
        (ref, ours),
        ([_rec(0, [0, 0, 10, 10], {"m1": v, "m2": v})],
         [_rec(0, [0, 0, 10, 10], {"m1": v, "m2": u})]),
        ([_rec(0, [0, 0, 10, 10], {"m1": w}),
          _rec(1, [50, 50, 90, 90], {"m1": w})],
         [_rec(0, [1, 1, 11, 11], {"m1": w})]),
        ([_rec(0, [0, 0, 10, 10], {"m": [1.0]}),
          _rec(0, [1, 1, 11, 11], {"m": [1.0]})],
         [_rec(0, [0, 0, 10, 10], {"m": [1.0]}),
          _rec(3, [0, 0, 10, 10], {"other": [1.0]})]),
    ]
    out = []
    for i, (a, b) in enumerate(pairs):
        rp, op = str(tmp_path / f"r{i}.jsonl"), str(tmp_path / f"o{i}.jsonl")
        _write_features(rp, a)
        _write_features(op, b)
        out.append((rp, op))
    return out


def test_embedding_eval_report_equals_jax(tmp_path, rng, capsys):
    from facerec_torch.tools import embedding_eval
    from facerec_tpu.tools import embedding_eval as jax_embedding_eval

    for rp, op in feature_cases(tmp_path, rng):
        for kw in (dict(max_p95=0.05), dict(iou_thr=0.3, max_p95=1e-9)):
            assert embedding_eval.evaluate_embedding_parity(rp, op, **kw) \
                == jax_embedding_eval.evaluate_embedding_parity(rp, op, **kw)
        argv = ["--ref", rp, "--ours", op]
        assert embedding_eval.main(argv) == jax_embedding_eval.main(argv)
    capsys.readouterr()


def test_evaluate_detections_equals_jax(rng):
    from facerec_torch.tools.detector_eval import evaluate_detections
    from facerec_tpu.tools.detector_eval import \
        evaluate_detections as jax_evaluate

    truth, preds = {}, {}
    for f in range(30):
        gts = []
        for _ in range(int(rng.integers(0, 4))):
            x, y, s = rng.uniform(0, 200), rng.uniform(0, 150), \
                rng.uniform(8, 80)
            gts.append([x, y, x + s, y + s * 1.2])
        if gts or f % 5:
            truth[f] = gts
        preds[f + (f % 7 == 0)] = [
            ([c + rng.normal(0, 3) for c in g], float(rng.uniform(0.5, 1)))
            for g in gts if rng.uniform() < 0.8] + [
            ([10.0, 10.0, 30.0, 34.0], 0.6)] * int(f % 4 == 0)
    for thr in (0.3, 0.5, 0.7):
        assert evaluate_detections(preds, truth, thr) == \
            jax_evaluate(preds, truth, thr)


def test_harness_predictions_probe_detector_matches_jax():
    from facerec_torch.models.detector import DetectorHarness
    from facerec_torch.tools.detector_eval import harness_predictions
    from facerec_torch.video.synth import make_frames
    from facerec_tpu.models.detector import DetectorHarness as JaxHarness
    from facerec_tpu.models.weights import load_params_npz
    from facerec_tpu.tools.detector_eval import \
        harness_predictions as jax_predictions

    clip = make_frames(6, width=192, height=144, seed=2, n_faces=2)
    kw = dict(input_size=(128, 192), max_detections=16, score_threshold=0.9,
              min_face_size=20)
    jh = JaxHarness.create(backbone_width=96, **kw)
    jh.variables = load_params_npz(PROBE, jh.variables)
    frames = list(enumerate(clip.frames))
    want = jax_predictions(jh, frames, batch=4)
    got = harness_predictions(DetectorHarness.from_npz(PROBE, device="cpu",
                                                       **kw), frames, batch=4)
    assert sorted(got) == sorted(want) == list(range(6))
    assert sum(len(v) for v in want.values()) >= 4
    for f in want:
        assert len(got[f]) == len(want[f])
        for (gb, gs), (wb, ws) in zip(got[f], want[f]):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-4)
            assert abs(gs - ws) <= 1e-5


def test_truth_pickle_of_the_jax_package_reads_without_it(tmp_path):
    from facerec_tpu.video.synth import make_clip as jax_make_clip

    clip = jax_make_clip(str(tmp_path / "5-T.mp4"), n_frames=6, seed=1)
    path = tmp_path / "t.pkl"
    with open(path, "wb") as f:
        pickle.dump(clip, f)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'facerec_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from facerec_torch.tools.detector_eval import load_truth_pickle\n"
        "from facerec_torch.video.synth import SynthClip\n"
        f"clip = load_truth_pickle({str(path)!r})\n"
        "assert type(clip) is SynthClip and clip.frames is None\n"
        "print(len(clip.truth), float(clip.truth[3][0][0][0]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, x1 = out.stdout.split()
    assert int(n) == 6 and float(x1) == float(clip.truth[3][0][0][0])


class EvalAwareScripted:
    """A scripted detector that also answers ``harness_predictions``,
    which batches (frame, image) pairs by position: its first calls
    replay the truth of ``eval_order``, then it scripts blocks."""

    def __init__(self, clip, eval_order, max_detections=8):
        from facerec_torch.video.synth import ScriptedDetector

        self.inner = ScriptedDetector(clip, max_detections=max_detections)
        self.eval_order = list(eval_order)
        self.device = torch.device("cpu")

    def set_block_start(self, frame0):
        self.inner.set_block_start(frame0)

    def __call__(self, frames):
        from facerec_torch.models.detector import Detections

        if not self.eval_order:
            return self.inner(frames)
        idxs = self.eval_order[:frames.shape[0]]
        del self.eval_order[:len(idxs)]
        outs = []
        for row, fi in enumerate(idxs):
            self.inner.set_block_start(fi)
            outs.append(self.inner(frames[row:row + 1]))
        return Detections(*(torch.cat(f) for f in zip(*outs)))


def reference_features(clip, out, save_every=2):
    from facerec_torch.config import ExtractConfig
    from facerec_torch.pipeline.extract import run_extract
    from facerec_torch.video.synth import ScriptedDetector
    from tests.test_torch_wire import deferred_bank

    cfg = ExtractConfig(block_frames=16, max_detections=8, max_tracks=16,
                        save_images=False, save_every=save_every,
                        resume=False)
    run_extract(clip.path, cfg, out,
                detector=ScriptedDetector(clip, max_detections=8),
                embedders=deferred_bank(), device="cpu")
    movie = os.path.basename(clip.path).split("-")[0]
    return (f"{out}/{movie}-data/features/"
            f"features_{movie}_0-{clip.n_frames}.jsonl"), cfg


def test_parity_rehearsal_with_a_scripted_detector(tmp_path):
    """distill is skipped (an injected detector); detector_eval,
    extract and embedding_eval run on the port, on the CPU."""
    from facerec_torch.tools.parity_rehearsal import run_rehearsal
    from facerec_torch.video.synth import make_clip
    from tests.test_torch_wire import deferred_bank

    clip = make_clip(str(tmp_path / "97-Rehearse.mp4"), n_frames=16, seed=5)
    ref_feats, cfg = reference_features(clip, str(tmp_path / "ref"))
    frames = sorted({json.loads(l)["frame"] for l in open(ref_feats)})
    assert frames
    rep = run_rehearsal(
        clip.path, ref_feats, str(tmp_path / "out"), long_side=96,
        max_p95=1e-6, min_recall=0.9, min_precision=0.9, extract_cfg=cfg,
        detector=EvalAwareScripted(clip, frames), embedders=deferred_bank(),
        device="cpu")
    assert "distill" not in rep
    assert rep["detector"]["pass"] and rep["detector"]["recall"] == 1.0
    assert rep["embeddings"]["n_matched"] == rep["embeddings"]["n_ref_faces"]
    assert rep["pass"] is True
    assert json.load(open(tmp_path / "out" / "parity_report.json"))["pass"]


@pytest.mark.slow
def test_parity_rehearsal_distills_and_cli_exit_codes(tmp_path):
    """The whole chain with the port's distillation (a narrow detector),
    then the CLI with the distilled ``.npz``: an impossible gate exits
    1."""
    from facerec_torch.tools.parity_rehearsal import main, run_rehearsal
    from facerec_torch.video.synth import make_clip
    from tests.test_torch_wire import deferred_bank

    clip = make_clip(str(tmp_path / "99-Rehearse.mp4"), n_frames=32, seed=7)
    ref_feats, cfg = reference_features(clip, str(tmp_path / "ref"))
    extract_cfg = cfg.__class__(**{**cfg.__dict__, "detector_long_side": 96,
                                   "face_threshold": 0.5})
    out = str(tmp_path / "rehearsal")
    rep = run_rehearsal(
        clip.path, ref_feats, out, steps=600, long_side=96,
        model_kwargs={"backbone_width": 32, "fpn_features": 16},
        distill_kwargs={"batch_size": 4, "learning_rate": 3e-3},
        max_p95=0.05, min_recall=0.5, min_precision=0.5,
        extract_cfg=extract_cfg, embedders=deferred_bank(), device="cpu")
    assert rep["detector"]["pass"] is True
    assert rep["embeddings"]["n_matched"] > 0
    assert os.path.exists(f"{out}/detector_ckpt.npz")
    rc = main(["--film", clip.path, "--ref-features", ref_feats,
               "--out", str(tmp_path / "cli"), "--device", "cpu",
               "--detector-weights", f"{out}/detector_ckpt.npz",
               "--long-side", "96", "--min-recall", "1.01",
               "--max-eval-frames", "4"])
    assert rc == 1


def test_detector_eval_cli_on_a_film_with_its_truth(tmp_path, capsys):
    """``main`` decodes the film through the port's reader, reads the
    truth pickle and runs the probe detector from its ``.npz``; its
    report equals ``evaluate_detections`` over ``harness_predictions``
    on the JAX package's decode of the same film.  A directory as
    ``--weights`` raises and names the ``.npz`` export."""
    from facerec_torch.models.detector import DetectorHarness
    from facerec_torch.tools import detector_eval
    from facerec_torch.video.synth import make_clip
    from facerec_tpu.tools.detector_eval import _decode_film as jax_decode

    clip = make_clip(str(tmp_path / "7-Eval.mp4"), n_frames=6, seed=4)
    truth = tmp_path / "7-Eval.mp4.truth.pkl"
    with open(truth, "wb") as f:
        pickle.dump(clip.__class__(**{**clip.__dict__, "frames": None}), f)
    out = tmp_path / "rep.json"
    assert detector_eval.main([
        "--film", clip.path, "--truth-pkl", str(truth), "--weights", PROBE,
        "--device", "cpu", "--face-threshold", "0.9",
        "--sweep-long-side", "0", "--out", str(out)]) == 0
    capsys.readouterr()
    rep = json.load(open(out))["sweeps"]["native"]
    harness = DetectorHarness.from_npz(
        PROBE, device="cpu", input_size=tuple(rep["input_size"]),
        max_detections=32, score_threshold=0.9, min_face_size=20.0)
    want = detector_eval.evaluate_detections(
        detector_eval.harness_predictions(harness, jax_decode(clip.path)),
        {f: [t[0].tolist() for t in v] for f, v in clip.truth.items()})
    assert {k: rep[k] for k in want} == want
    with pytest.raises(ValueError, match="npz"):
        detector_eval.build_harness((64, 64), str(tmp_path), 0.9, 20.0,
                                    "cpu")
