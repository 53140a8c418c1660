"""The port's detector against the JAX package's (CPU).

A narrow detector (``backbone_width=16``) with random Flax weights and
perturbed batch statistics is carried across with
``convert.detector_state_dict``.  Raw heads agree within 1e-4 (the
convolutions sum in another order); the harness's validity masks and
NMS choices are exact and valid boxes/landmarks agree within 1e-3 px.
"""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from facerec_tpu.models.detector import DetectorHarness as JaxHarness
from facerec_tpu.models.detector import FaceDetector as JaxDetector
from facerec_tpu.models.detector import anchor_centers as jax_anchors
from facerec_tpu.models.detector import fit_input_size as jax_fit
from facerec_tpu.ops.nms import nms as jax_nms

from facerec_torch.models import convert
from facerec_torch.models.detector import (DetectorHarness, FaceDetector,
                                           anchor_centers, fit_input_size)
from facerec_torch.ops.nms import nms

HEAD_ATOL = 1e-4
BOX_ATOL = 1e-3          # px
RESIZE_ATOL = 1e-4       # on 0..255 pixel values
PROBE = os.path.join(os.path.dirname(__file__), "data",
                     "probe_detector_w96.npz")


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _perturb(tree, rng):
    """Non-trivial batch-norm statistics and biases."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("mean", "bias"):
            tree[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(0)
    model = JaxDetector(backbone_width=16)
    variables = _numpy_tree(model.init(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 64, 96, 3))))
    _perturb(variables, rng)
    port = FaceDetector(backbone_width=16)
    port.load_state_dict(convert.detector_state_dict(variables))
    return model, variables, port.eval()


def test_raw_heads_match_jax(narrow):
    model, variables, port = narrow
    x = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    want = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for w, g in zip(want, got):
        for k in ("score", "box", "ldm"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=HEAD_ATOL)


@pytest.mark.parametrize("frame_hw,input_size", [
    ((64, 96), (64, 96)),          # native size: the resize is skipped
    ((96, 128), (64, 96)),         # anti-aliased downscale + letterbox
])
def test_harness_matches_jax(narrow, frame_hw, input_size):
    model, variables, port = narrow
    kw = dict(input_size=input_size, max_detections=8, score_threshold=0.5,
              min_face_size=0.0)
    jh = JaxHarness(model=model, variables=variables, **kw)
    th = DetectorHarness(model=port, **kw)
    frames = np.random.default_rng(2).integers(
        0, 256, (2,) + frame_hw + (3,)).astype(np.uint8)
    want = jh(jnp.asarray(frames))
    got = th(torch.from_numpy(frames))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() >= 4
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=BOX_ATOL)
    np.testing.assert_allclose(got.landmarks.numpy()[valid],
                               np.asarray(want.landmarks)[valid],
                               atol=BOX_ATOL)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-5)


def test_resize_identity_at_scale_one_and_antialiased_downscale():
    x = np.random.default_rng(3).integers(0, 256, (2, 96, 128, 3)).astype(
        np.float32)
    same = jax.image.resize(jnp.asarray(x), x.shape, "bilinear")
    np.testing.assert_array_equal(np.asarray(same), x)
    for hw in ((72, 96), (61, 83)):
        want = jax.image.resize(jnp.asarray(x), (2,) + hw + (3,), "bilinear")
        got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                            size=hw, mode="bilinear", align_corners=False,
                            antialias=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("seed", range(3))
def test_nms_indices_exact(seed):
    rng = np.random.default_rng(seed)
    b, n = 3, 64
    xy = rng.uniform(0, 60, (b, n, 2))
    bx = np.concatenate([xy, xy + rng.uniform(8, 30, (b, n, 2))],
                        -1).astype(np.float32)
    sc = rng.uniform(0, 1, (b, n)).astype(np.float32)
    sc[:, ::3] = -1.0                  # masked candidates, all tied
    want_idx, want_valid = jax.vmap(
        lambda x, s: jax_nms(x, s, 0.4, 16))(jnp.asarray(bx),
                                             jnp.asarray(sc))
    idx, valid = nms(torch.from_numpy(bx), torch.from_numpy(sc), 0.4, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


def test_anchor_and_input_size_helpers_match_jax():
    for hw in ((576, 768), (288, 384), (1080, 1920)):
        assert fit_input_size(*hw) == jax_fit(*hw)
        assert fit_input_size(*hw, long_side=max(hw)) == \
            jax_fit(*hw, long_side=max(hw))
    np.testing.assert_array_equal(anchor_centers((576, 768)),
                                  jax_anchors((576, 768)))


def test_probe_checkpoint_restores_every_key():
    tree = convert.load_flax_npz(PROBE)
    h = DetectorHarness.from_npz(PROBE, device="cpu",
                                 input_size=(64, 64))
    assert h.model.backbone_width == 96
    state = h.model.state_dict()
    flat = convert.flatten(tree)
    assert len(flat) == len(state)
    with np.load(PROBE) as data:
        k = data["params/stem/Conv_0/kernel"].astype(np.float32)
        np.testing.assert_array_equal(
            state["stem.conv.weight"].numpy(), k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            state["c5_2.conv2.bn.var"].numpy(),
            data["batch_stats/c5_2/conv2/BatchNorm_0/var"].astype(np.float32))


def test_converter_rejects_a_mismatched_tree(narrow):
    _, variables, _ = narrow
    bad = _numpy_tree(variables)
    del bad["params"]["head0"]
    with pytest.raises(KeyError, match="missing"):
        convert.detector_state_dict(bad)
    bad = _numpy_tree(variables)
    bad["params"]["head0"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.detector_state_dict(bad)
