"""``facerec_torch.benchdev`` against ``facerec_tpu.benchdev`` (CPU).

``HybridDetector`` returns the scripted truth bit for bit, as JAX's
does.  ``make_device_step`` runs eagerly on the CPU (its plain version;
on a card it is one captured CUDA graph, held to this eager step by
``chip_smoke.py``) at a small size: block 8, 96×128 frames, 4 crops,
float32.  Each part is held to the JAX function that the
JAX step composes, at the tolerance of that part's own parity test:
scene flags and tracker integers exact, detection boxes within 1e-3 px,
tracker boxes within 1e-4 px, crops within 1e-3 on 0..255, embeddings
within 1e-4.  The fingerprint is held to the JAX formula over JAX's
parts within the sum of those tolerances over the values it adds.  The
port's random weights are carried to the JAX models by
``models/convert.py`` (``flax_leaves``), which spares the JAX package's
slow initialisation.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from facerec_tpu.benchdev import HybridDetector as JaxHybridDetector
from facerec_tpu.models.detector import DetectorHarness as JaxHarness
from facerec_tpu.models.detector import FaceDetector as JaxFaceDetector
from facerec_tpu.models.facenet import FaceNetEmbedder as JaxEmbedder
from facerec_tpu.ops import scene as jax_scene
from facerec_tpu.ops.crops import crop_resize as jax_crop_resize
from facerec_tpu.pipeline.extract import EmbedderBank as JaxBank
from facerec_tpu.track import TrackerConfig as JaxTrackerConfig
from facerec_tpu.track import init_tracker as jax_init_tracker
from facerec_tpu.track.tracker import _run_block_impl
from facerec_tpu.video.synth import PureScriptedDetector

from facerec_torch.benchdev import HybridDetector, make_device_step
from facerec_torch.models import convert
from facerec_torch.models.detector import DetectorHarness
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.pipeline.extract import EmbedderBank
from facerec_torch.video.synth import ScriptedDetector, make_frames

DET_BOX_ATOL = 1e-3      # px (tests/test_torch_detector.py)
BOX_ATOL = 1e-4          # px (tests/test_torch_tracker_block.py)
CROP_ATOL = 1e-3         # on 0..255 (tests/test_torch_extract.py)
EMB_ATOL = 1e-4          # (tests/test_torch_facenet.py)
INT_EMIT = ("emit", "detected", "uid", "first_frame", "det_slot", "overflow")
NAME = "20170512-110547"


def _jax_tree(module):
    """A port module's weights as the JAX package's variables."""
    tree = {}
    for key, arr in convert.flax_leaves(module).items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def _jax_harness(harness):
    return JaxHarness(
        model=JaxFaceDetector(
            backbone_width=harness.model.backbone_width),
        variables=_jax_tree(harness.model), input_size=harness.input_size,
        max_detections=harness.max_detections,
        score_threshold=harness.score_threshold)


def test_hybrid_detector_returns_the_scripted_truth_as_jax_does():
    clip = make_frames(24, width=128, height=96, seed=0, n_faces=2,
                       identities=2)
    harness = DetectorHarness.create(backbone_width=16, device="cpu",
                                     input_size=(64, 96), max_detections=16)
    jax_det = JaxHybridDetector(
        _jax_harness(harness), PureScriptedDetector(clip, max_detections=16))
    det = HybridDetector(harness, ScriptedDetector(clip, max_detections=16))
    frames = clip.frames[8:16]
    want = jax.jit(jax_det.forward_indexed)(
        jax_det.variables, jnp.asarray(frames), 8)
    det.set_block_start(8)
    got = det(torch.from_numpy(frames))
    assert got.valid.any()
    for k in ("boxes", "scores", "landmarks", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.fixture(scope="module")
def steps():
    """The port's eager step, its parts, and the JAX parts with the same
    weights on the same inputs."""
    emb = FaceNetEmbedder(NAME, 128, "cpu", seed=0)
    jax_bank = JaxBank({NAME: JaxEmbedder(NAME, 128,
                                          params=_jax_tree(emb.model))})
    step, args = make_device_step((64, 96), 8, 96, 128, 4,
                                  bank=EmbedderBank({NAME: emb}),
                                  device="cpu", dtype=torch.float32)
    jax_det = _jax_harness(step.detector)
    got = step.components(*args)
    fp, scene_state, tracker_state = step(*args)

    frames, crop_boxes, crop_frames = (jnp.asarray(a.numpy())
                                       for a in (args[0], args[3], args[4]))
    flags, jscene = jax_scene.detect_block(frames,
                                           jax_scene.initial_state(96, 128))
    det = jax_det(frames)
    tcfg = JaxTrackerConfig(max_tracks=32, max_detections=16)
    jtracker, emit = _run_block_impl(tcfg, jax_init_tracker(tcfg),
                                     det.boxes, det.valid, flags,
                                     jnp.int32(0))
    crops = jax_crop_resize(frames, crop_frames, crop_boxes, 160)
    embs = jax_bank.pooled(crops)
    jfp = (flags.sum().astype(jnp.float32) + emit.box.sum()
           + sum(e.sum().astype(jnp.float32) for e in embs))
    want = {"flags": flags, "detections": det, "emit": emit, "crops": crops,
            "embeddings": embs, "fingerprint": jfp, "scene_state": jscene,
            "tracker_state": jtracker}
    return got, want, (fp, scene_state, tracker_state), args


def test_step_inputs_are_the_jax_benchs():
    """The same draws from ``np.random.default_rng(0)`` as
    ``facerec_tpu/benchdev.py:100-114``."""
    _, args = make_device_step((64, 96), 4, 32, 64, 3, bank=EmbedderBank(
        {"a": FaceNetEmbedder("a", 128, "cpu")}), device="cpu",
        dtype=torch.float32)
    rng = np.random.default_rng(0)
    frames = np.asarray(jnp.asarray(rng.integers(0, 255, (4, 32, 64, 3)),
                                    jnp.uint8))
    boxes = np.stack([rng.uniform(0, 300, 3), rng.uniform(0, 300, 3),
                      rng.uniform(360, 700, 3), rng.uniform(360, 560, 3)],
                     axis=1).astype(np.float32)
    idx = rng.integers(0, 4, 3)
    np.testing.assert_array_equal(args[0].numpy(), frames)
    np.testing.assert_array_equal(args[3].numpy(), boxes)
    np.testing.assert_array_equal(args[4].numpy(), idx)


def test_step_scene_and_detections_match_jax(steps):
    got, want, _, _ = steps
    np.testing.assert_array_equal(got["flags"].numpy(),
                                  np.asarray(want["flags"]))
    gd, wd = got["detections"], want["detections"]
    valid = np.asarray(wd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), valid)
    np.testing.assert_allclose(gd.boxes.numpy()[valid],
                               np.asarray(wd.boxes)[valid], rtol=0,
                               atol=DET_BOX_ATOL)
    ws = want["scene_state"]
    gs = got["scene_state"]
    assert int(gs.n_seen) == int(ws.n_seen) == 8
    for k in ("prev_y", "prev_eq"):
        np.testing.assert_array_equal(getattr(gs, k).numpy(),
                                      np.asarray(getattr(ws, k)))


def test_step_tracker_matches_jax(steps):
    got, want, _, _ = steps
    ge, we = got["emit"], want["emit"]
    for k in INT_EMIT:
        np.testing.assert_array_equal(getattr(ge, k).numpy(),
                                      np.asarray(getattr(we, k)), err_msg=k)
    np.testing.assert_allclose(ge.box.numpy(), np.asarray(we.box), rtol=0,
                               atol=BOX_ATOL)
    assert int(got["tracker_state"].next_uid) == int(
        want["tracker_state"].next_uid)


def test_step_crops_and_embeddings_match_jax(steps):
    got, want, _, _ = steps
    np.testing.assert_allclose(got["crops"].numpy(),
                               np.asarray(want["crops"]), rtol=0,
                               atol=CROP_ATOL)
    assert len(got["embeddings"]) == len(want["embeddings"]) == 1
    for g, w in zip(got["embeddings"], want["embeddings"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=EMB_ATOL)


def test_step_fingerprint_is_the_jax_formula(steps):
    """The step returns its parts' fingerprint and states, and the
    fingerprint is JAX's over JAX's parts within the parts' tolerances
    summed over the values it adds."""
    got, want, (fp, scene_state, tracker_state), _ = steps
    assert torch.equal(fp, got["fingerprint"])
    assert torch.equal(scene_state.prev_eq, got["scene_state"].prev_eq)
    assert torch.equal(tracker_state.uid, got["tracker_state"].uid)
    n_emb = sum(e.numel() for e in got["embeddings"])
    tol = n_emb * EMB_ATOL + got["emit"].box.numel() * BOX_ATOL
    assert abs(float(fp) - float(want["fingerprint"])) <= tol


def test_step_threads_its_states():
    """A second step from the first's states sees the carried scene
    state (frames counted on) and the carried track table."""
    step, args = make_device_step((64, 96), 4, 48, 64, 2, bank=EmbedderBank(
        {"a": FaceNetEmbedder("a", 128, "cpu")}), device="cpu",
        dtype=torch.float32)
    _, sc, tr = step(*args)
    _, sc2, tr2 = step(args[0], sc, tr, args[3], args[4])
    assert int(sc.n_seen) == 4 and int(sc2.n_seen) == 8
    assert step.graph is None and step.replays == 0
