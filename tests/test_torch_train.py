"""The port's detector training path against the JAX package's (CPU).

Same numpy-seeded inputs through both: BatchNorm in train mode (a
``ConvBN`` and a bare Flax ``nn.BatchNorm`` as FaceNet's bottleneck
uses it), anchor assignment (labels exact, targets within 1e-5 + 1e-6
relative), the multi-task loss and its gradient with respect to the raw
heads (rtol 1e-5), one ``DetectorTrainer`` step at ``backbone_width=16``
and 64² (loss rtol 1e-5, batch statistics within 1e-5; every gradient
leaf within 1e-4 of its max |g| and the Adam update within 1e-6 where
|g| ≥ 1e-2 of the leaf's max |g|, for the port's step in float64), the single-file ``.npz`` round trip,
and the WIDER-FACE and distillation data paths.  The model constructors
and trainers raise without a card unless ``device="cpu"`` is given.
"""
import json
import os

import numpy as np
import pytest
import torch
import flax.linen as fnn
import jax
import jax.numpy as jnp

from facerec_tpu.models.detector import DetectorHarness as JaxHarness
from facerec_tpu.models.detector import FaceDetector as JaxDetector
from facerec_tpu.models.layers import ConvBN as JaxConvBN
from facerec_tpu.models.weights import load_params_npz
from facerec_tpu.train import DetectorTrainer as JaxTrainer
from facerec_tpu.train import anchor_targets as jax_anchor_targets
from facerec_tpu.train import detector_loss as jax_detector_loss
from facerec_tpu.video.synth import synth_batch as jax_synth_batch

from facerec_torch.models import convert
from facerec_torch.models.detector import (DetectorHarness, FaceDetector,
                                           anchor_centers)
from facerec_torch.models.layers import BatchNorm, ConvBN
from facerec_torch.train import DetectorTrainer, anchor_targets, detector_loss
from facerec_torch.train.detector_train import AnchorTargets
from tests.test_torch_detector import _numpy_tree, _perturb

BN_ATOL = 1e-5
TARGET_ATOL, TARGET_RTOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4          # max |Δg| over the leaf's max |g|
STATS_ATOL = 1e-5
ADAM_ATOL = 1e-6
ADAM_G_FLOOR = 1e-2      # compare updates where |g| ≥ this × max |g|
SIZE = (64, 64)


def torch_grads_of(flax_grads):
    """A Flax ``params`` gradient tree under the port's state-dict keys
    (numpy, kernels transposed as the weights are)."""
    return {convert._torch_key(p): convert._torch_value(p[-1], a).numpy()
            for p, a in convert.flatten({"params": flax_grads}).items()}


def assert_grads_close(got, want, rel=GRAD_REL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-8)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, (k, err, scale)


def assert_stats_close(module, flax_stats, atol=STATS_ATOL):
    want = {convert._torch_key(p): a for p, a in
            convert.flatten({"batch_stats": flax_stats}).items()}
    state = module.state_dict()
    assert want
    for k, w in want.items():
        np.testing.assert_allclose(state[k].numpy(), w, rtol=0, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------- BN


@pytest.mark.parametrize("kind", ["convbn", "bottleneck"])
def test_batchnorm_train_mode_matches_flax(kind):
    """Forward with batch statistics, input and parameter gradients, and
    the running update (biased variance, ra = m·ra + (1−m)·batch)."""
    rng = np.random.default_rng(0)
    if kind == "convbn":
        x = rng.normal(1.0, 2.0, (4, 6, 7, 3)).astype(np.float32)
        jmod = JaxConvBN(features=8, kernel=3)
        port = ConvBN(3, 8, 3)
        to_port = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
        from_port = lambda t: t.permute(0, 2, 3, 1)
    else:                        # FaceNet's Bottleneck_BatchNorm
        x = rng.normal(0.5, 3.0, (6, 16)).astype(np.float32)
        jmod = fnn.BatchNorm(epsilon=1e-3, use_scale=False)
        port = BatchNorm(16, eps=1e-3, momentum=0.99)
        to_port = torch.from_numpy
        from_port = lambda t: t
    variables = _numpy_tree(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x),
        **({} if kind == "convbn" else {"use_running_average": True})))
    _perturb(variables, rng)
    params = variables["params"]
    if kind == "bottleneck":
        params = jax.tree.map(lambda a: a + 0.3, params)
        variables = {"params": params,
                     "batch_stats": variables["batch_stats"]}
    cot = rng.normal(size=x.shape[:-1] + (8 if kind == "convbn" else 16,)
                     ).astype(np.float32)

    def f(p, xin):
        kw = ({"train": True} if kind == "convbn"
              else {"use_running_average": False})
        y, mut = jmod.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            xin, mutable=["batch_stats"], **kw)
        return (y * cot).sum(), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    port.load_state_dict(convert.state_dict_from_flax(port, variables))
    port.train()
    xt = to_port(x).clone().requires_grad_()
    yt = port(xt)
    (from_port(yt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(from_port(yt).detach().numpy(), np.asarray(y),
                               rtol=0, atol=BN_ATOL)
    np.testing.assert_allclose(from_port(xt.grad).numpy(), np.asarray(gx),
                               rtol=0, atol=BN_ATOL)
    assert_grads_close({k: p.grad.numpy()
                        for k, p in port.named_parameters()},
                       torch_grads_of(gp))
    assert_stats_close(port, stats, atol=1e-6)
    # eval mode normalises with the running statistics, updated above
    port.eval()
    want = jmod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x),
                      **({} if kind == "convbn" else
                         {"use_running_average": True}))
    with torch.no_grad():
        got = from_port(port(to_port(x))).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=BN_ATOL)


# ---------------------------------------------------------------- targets


def _gt(rng, b=3, g=4, hw=SIZE):
    h, w = hw
    xy = rng.uniform(0, [w - 10, h - 10], (b, g, 2))
    wh = rng.uniform(4, 40, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(
        np.float32)
    valid = rng.uniform(size=(b, g)) < 0.7
    valid[:, 0] = True
    boxes[~valid] = 0.0
    ldm = (boxes[..., None, :2] + rng.uniform(0, 1, (b, g, 5, 2))
           * (boxes[..., None, 2:] - boxes[..., None, :2])).astype(np.float32)
    return boxes, valid, ldm


def jax_targets(anchors, boxes, valid, ldm, content):
    return jax.vmap(lambda b, v, l, c: jax_anchor_targets(
        jnp.asarray(anchors), b, v, l, content_hw=c))(
        jnp.asarray(boxes), jnp.asarray(valid),
        None if ldm is None else jnp.asarray(ldm), jnp.asarray(content))


@pytest.mark.parametrize("landmarks", [True, False])
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_anchor_targets_match_jax(hw, landmarks):
    rng = np.random.default_rng(hw[1] + landmarks)
    anchors = anchor_centers(hw)
    boxes, valid, ldm = _gt(rng, hw=hw)
    content = np.array([hw, [hw[0] - 16, hw[1]], [hw[0], hw[1] - 24]],
                       np.float32)
    if not landmarks:
        ldm = None
    want = (jax.vmap(lambda b, v, c: jax_anchor_targets(
        jnp.asarray(anchors), b, v, None, content_hw=c))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(content))
        if ldm is None else jax_targets(anchors, boxes, valid, ldm, content))
    got = anchor_targets(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid),
                         None if ldm is None else torch.from_numpy(ldm),
                         content_hw=torch.from_numpy(content))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels.numpy() == 1).any()
    np.testing.assert_array_equal(got.ldm_valid.numpy(),
                                  np.asarray(want.ldm_valid))
    for g, w in ((got.box_targets, want.box_targets),
                 (got.ldm_targets, want.ldm_targets)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=TARGET_RTOL, atol=TARGET_ATOL)


@pytest.mark.parametrize("gts,valid,label0", [
    # a valid gt in the corner claims anchor 0 with IoU < 0.3; the
    # padded gt's all −1 column claims anchor 0 too
    ([[0, 0, 6, 6], [0, 0, 0, 0]], [True, False], 0),
    ([[0, 0, 0, 0], [0, 0, 6, 6]], [False, True], 1),
    ([[0, 0, 6, 6], [1, 1, 7, 7], [0, 0, 0, 0]], [True, True, False], 0),
    ([[0, 0, 6, 6], [1, 1, 7, 7], [0, 0, 0, 0]], [True, False, True], 1),
    ([[0, 0, 6, 6], [1, 1, 7, 7], [0, 0, 0, 0]], [False, True, True], 1),
])
def test_force_match_collision_takes_the_last_gt(gts, valid, label0):
    """Two gts whose best anchor is anchor 0: the JAX scatter on the CPU
    keeps the highest gt index's write, and so does the port."""
    anchors = anchor_centers(SIZE)
    boxes = np.asarray([gts], np.float32)
    valid = np.asarray([valid])
    want = jax.vmap(lambda b, v: jax_anchor_targets(
        jnp.asarray(anchors), b, v))(jnp.asarray(boxes), jnp.asarray(valid))
    got = anchor_targets(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid))
    assert int(np.asarray(want.labels)[0, 0]) == label0
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


def _raw_heads(rng, b, hw):
    n = [(hw[0] // s) * (hw[1] // s) * 2 for s in (8, 16, 32)]
    return [{"score": rng.normal(0, 2, (b, k)).astype(np.float32),
             "box": rng.normal(0, 1, (b, k, 4)).astype(np.float32),
             "ldm": rng.normal(0, 1.5, (b, k, 10)).astype(np.float32)}
            for k in n]


def test_detector_loss_and_head_gradients_match_jax():
    rng = np.random.default_rng(3)
    anchors = anchor_centers(SIZE)
    boxes, valid, ldm = _gt(rng)
    content = np.broadcast_to(np.asarray(SIZE, np.float32), (3, 2))
    targets = jax_targets(anchors, boxes, valid, ldm, content)
    raw = _raw_heads(rng, 3, SIZE)

    def f(r):
        return jax_detector_loss(r, targets)
    (want, parts), want_g = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, raw))

    raw_t = [{k: torch.from_numpy(v).requires_grad_() for k, v in o.items()}
             for o in raw]
    got, got_parts = detector_loss(raw_t, AnchorTargets(
        *(torch.from_numpy(np.asarray(t)) for t in targets)))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for k in ("cls", "box", "ldm"):
        np.testing.assert_allclose(float(got_parts[k]), float(parts[k]),
                                   rtol=LOSS_RTOL)
    assert int(got_parts["n_pos"]) == int(parts["n_pos"])
    for o, w in zip(raw_t, want_g):
        for k in ("score", "box", "ldm"):
            np.testing.assert_allclose(o[k].grad.numpy(), np.asarray(w[k]),
                                       rtol=LOSS_RTOL, atol=1e-8)


# ---------------------------------------------------------------- step


@pytest.fixture(scope="module")
def detector_step():
    """One JAX step and one port step from the same initial state on the
    same synth_batch; JAX's gradient from the trainer's own loss."""
    rng = np.random.default_rng(0)
    batch = jax_synth_batch(rng, 4, SIZE[1], SIZE[0], max_faces=2,
                            face_size=(12.0, 30.0))
    jt = JaxTrainer(JaxDetector(backbone_width=16), input_size=SIZE,
                    learning_rate=1e-3)
    variables, opt_state = jt.init(0)
    frames, boxes, valid, ldm = (jnp.asarray(a) for a in batch)
    content = jnp.broadcast_to(jnp.asarray(SIZE, jnp.float32), (4, 2))

    def loss_fn(params):
        x = (frames.astype(jnp.float32) - 127.5) / 128.0
        raw, mut = jt.model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        targets = jax.vmap(lambda b, v, l, c: jax_anchor_targets(
            jt.anchors, b, v, l, content_hw=c))(boxes, valid, ldm, content)
        return jax_detector_loss(raw, targets)[0], mut["batch_stats"]

    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    new_vars, _, step_loss = jt.step(variables, opt_state, frames, boxes,
                                     valid, ldm)
    out = {"loss": float(loss), "step_loss": float(step_loss),
           "grads": torch_grads_of(grads), "new": _numpy_tree(new_vars)}
    for dtype in (torch.float32, torch.float64):
        model = FaceDetector(backbone_width=16)
        model.load_state_dict(convert.detector_state_dict(
            _numpy_tree(variables)))
        trainer = DetectorTrainer(model.to(dtype), SIZE, learning_rate=1e-3,
                                  device="cpu")
        out[dtype] = (float(trainer.step(*batch)), trainer.model)
    return out


def test_detector_step_loss_and_gradients_match_jax(detector_step):
    """The port's step in float64 against JAX's in float32.  In float32
    a pre-activation within rounding of a ReLU's kink can land on the
    other side in one package: at 64² one such element of smooth4's 4×4
    map moved its bias gradient by 15%, while the float64 port stays
    within 1e-5 of JAX's max |g| on every leaf."""
    s = detector_step
    np.testing.assert_allclose(s["step_loss"], s["loss"], rtol=1e-6)
    for dtype in (torch.float32, torch.float64):
        np.testing.assert_allclose(s[dtype][0], s["loss"], rtol=LOSS_RTOL)
    assert_grads_close({k: p.grad.numpy() for k, p in
                        s[torch.float64][1].named_parameters()}, s["grads"])


def test_detector_step_stats_and_adam_update_match_jax(detector_step):
    s = detector_step
    for dtype in (torch.float32, torch.float64):
        assert_stats_close(s[dtype][1], s["new"]["batch_stats"])
    model = s[torch.float64][1]
    want = convert.state_dict_from_flax(model, s["new"])
    n = 0
    for k, p in model.named_parameters():
        g = s["grads"][k]
        big = np.abs(g) >= ADAM_G_FLOOR * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[big],
                                   want[k].numpy()[big], rtol=0,
                                   atol=ADAM_ATOL, err_msg=k)
        n += int(big.sum())
    assert n > 1000


# ---------------------------------------------------------------- weights


def test_port_written_detector_npz_loads_in_both_packages(tmp_path):
    rng = np.random.default_rng(4)
    model = FaceDetector(backbone_width=16)
    jmodel = JaxDetector(backbone_width=16)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)))
    tree = _numpy_tree(template)
    _perturb(tree, rng)
    model.load_state_dict(convert.detector_state_dict(tree))
    path = str(tmp_path / "det.npz")
    convert.save_params_npz(path, model)

    loaded = load_params_npz(path, template)
    for p, a in convert.flatten(_numpy_tree(loaded)).items():
        np.testing.assert_array_equal(a, convert.flatten(tree)[p])
    port = DetectorHarness.from_npz(path, device="cpu", input_size=(64, 96),
                                    max_detections=8, score_threshold=0.5,
                                    min_face_size=0.0)
    for k, v in model.state_dict().items():
        assert torch.equal(port.model.state_dict()[k], v), k
    jh = JaxHarness(model=jmodel, variables=loaded, input_size=(64, 96),
                    max_detections=8, score_threshold=0.5, min_face_size=0.0)
    frames = rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    want, got = jh(jnp.asarray(frames)), port(torch.from_numpy(frames))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], atol=1e-3)
    # the float16 cast of the committed fixture
    convert.save_params_npz(str(tmp_path / "h.npz"), model, cast=np.float16)
    with np.load(str(tmp_path / "h.npz")) as data:
        assert data["params/stem/Conv_0/kernel"].dtype == np.float16


# ---------------------------------------------------------------- devices


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    "harness_create", "harness_from_npz", "facenet_embedder",
    "load_facenet_embedders", "detector_trainer", "facenet_trainer",
    "selfcheck_main"])
def test_entry_points_raise_without_a_card(make, monkeypatch, tmp_path):
    """No device given and no card: every constructor and trainer raises
    instead of running on the host."""
    from facerec_torch.config import EMB_NAME
    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.models.load import load_facenet_embedders
    from facerec_torch.tools import selfcheck
    from facerec_torch.train.facenet_train import FaceNetTrainer
    from tests.test_torch_detector import PROBE

    (tmp_path / f"{EMB_NAME}.npz").write_bytes(b"")
    calls = {
        "harness_create": lambda: DetectorHarness.create(backbone_width=16),
        "harness_from_npz": lambda: DetectorHarness.from_npz(PROBE),
        "facenet_embedder": lambda: FaceNetEmbedder("n", 128),
        "load_facenet_embedders": lambda: load_facenet_embedders(
            str(tmp_path), names=(EMB_NAME,)),
        "detector_trainer": lambda: DetectorTrainer(
            FaceDetector(backbone_width=16), SIZE),
        "facenet_trainer": lambda: FaceNetTrainer(),
        "selfcheck_main": lambda: selfcheck.main(
            ["--out", str(tmp_path / "sc")]),
    }
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[make]()


# ---------------------------------------------------------------- data


@pytest.fixture
def wider_tree(tmp_path, rng):
    from tests.test_detector_data import wider_dir

    return wider_dir.__wrapped__(tmp_path, rng)


def test_parse_bbx_gt_and_wider_dataset_match_jax(wider_tree):
    from facerec_tpu.train import widerface as J
    from facerec_torch.train import widerface as T

    root, ann = wider_tree
    want, got = J.parse_bbx_gt(ann), T.parse_bbx_gt(ann)
    assert [s.path for s in got] == [s.path for s in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.invalid, w.invalid)
    kw = dict(input_size=(64, 64), max_boxes=8, min_face=4)
    jd, td = J.WiderFaceDataset(root, ann, **kw), T.WiderFaceDataset(
        root, ann, **kw)
    assert len(td) == len(jd) == 4
    for i in range(len(td)):
        for g, w in zip(td.load(i), jd.load(i)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(next(td.batches(2, np.random.default_rng(0))),
                    next(jd.batches(2, np.random.default_rng(0)))):
        np.testing.assert_array_equal(g, w)


def test_wider_train_writes_a_loadable_recalibrated_npz(wider_tree,
                                                        tmp_path):
    from facerec_torch.train.widerface import train

    root, ann = wider_tree
    kw = dict(steps=2, batch_size=2, input_size=(64, 64), seed=0,
              device="cpu")
    losses = train(root, ann, str(tmp_path / "ckpt"), **kw)
    assert len(losses) == 2 and all(np.isfinite(losses))
    h = DetectorHarness.from_npz(str(tmp_path / "ckpt.npz"), device="cpu",
                                 input_size=(64, 64), max_detections=4,
                                 score_threshold=0.5, min_face_size=4)
    assert h(torch.zeros((1, 64, 64, 3), dtype=torch.uint8)).boxes.shape \
        == (1, 4, 4)
    train(root, ann, str(tmp_path / "raw"), recalibrate=False, **kw)
    cal = convert.load_flax_npz(str(tmp_path / "ckpt.npz"))
    raw = convert.load_flax_npz(str(tmp_path / "raw.npz"))
    cal_f, raw_f = convert.flatten(cal), convert.flatten(raw)
    assert any(not np.allclose(cal_f[k], raw_f[k])
               for k in cal_f if k[0] == "batch_stats")
    for k in (k for k in cal_f if k[0] == "params"):
        np.testing.assert_array_equal(cal_f[k], raw_f[k])


@pytest.fixture(scope="module")
def distill_clip(tmp_path_factory):
    from facerec_torch.video.synth import make_clip

    path = str(tmp_path_factory.mktemp("dclips") / "42-Distill.mp4")
    return make_clip(path, n_frames=24, cuts=(), seed=13)


@pytest.mark.parametrize("keypoints", [True, False])
def test_load_truth_and_distill_dataset_match_jax(distill_clip, tmp_path,
                                                  keypoints):
    from facerec_tpu.train import distill as J
    from facerec_torch.train import distill as T
    from tests.test_parity_tools import truth_jsonl_from_clip

    tj = truth_jsonl_from_clip(distill_clip, str(tmp_path / "t.jsonl"),
                               with_keypoints=keypoints)
    want, got = J.load_truth(tj), T.load_truth(tj)
    assert sorted(got) == sorted(want)
    for f in want:
        for (gb, gl), (wb, wl) in zip(got[f], want[f]):
            np.testing.assert_array_equal(gb, wb)
            assert (gl is None) == (wl is None)
            if wl is not None:
                np.testing.assert_array_equal(gl, wl)
    kw = dict(input_size=(64, 96), max_boxes=8)
    jd = J.DistillDataset(distill_clip.path, want, **kw)
    td = T.DistillDataset(distill_clip.path, got, **kw)
    assert len(td) == len(jd) and td.use_landmarks == jd.use_landmarks \
        == keypoints
    jit, tit = (d.batches(4, np.random.default_rng(0)) for d in (jd, td))
    for _ in range(3):                  # the second epoch is cached
        for g, w in zip(next(tit), next(jit)):
            np.testing.assert_array_equal(g, w)


def test_distill_writes_npz_and_model_json(distill_clip, tmp_path):
    from facerec_torch.train.distill import distill
    from tests.test_parity_tools import truth_jsonl_from_clip

    tj = truth_jsonl_from_clip(distill_clip, str(tmp_path / "t.jsonl"))
    out = str(tmp_path / "det")
    losses = distill(distill_clip.path, tj, out, steps=2, batch_size=2,
                     input_size=(64, 96), model_kwargs={"backbone_width": 16},
                     device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert json.load(open(out + ".model.json")) == {"backbone_width": 16}
    h = DetectorHarness.from_npz(out + ".npz", device="cpu",
                                 input_size=(64, 96))
    assert h.model.backbone_width == 16
    again = distill(distill_clip.path, tj, out, steps=1, batch_size=2,
                    input_size=(64, 96), init_weights=out + ".npz",
                    model_kwargs={"backbone_width": 16}, recalibrate=False,
                    device="cpu")
    assert len(again) == 1 and os.path.isfile(out + ".npz")
