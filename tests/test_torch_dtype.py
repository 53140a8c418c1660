"""Reduced-precision compute in the port's models against the JAX
package's ``dtype=`` (CPU).

The floating weights are cast once (``cast_float_tree``), the inputs
enter the networks in the compute dtype, and the detector's heads and
the embeddings come back to float32, as in the JAX package.  bfloat16
rounds in other places in the two frameworks, so the tolerances are
measured, not zero:
- detector raw heads (width 16, 64×96): measured 0.0 apart; held
  within 4e-3, one bfloat16 step at the heads' scale (|h| < 1);
- pooled FaceNet unit embeddings (one 128-d checkpoint, 2 crops):
  measured 6.8e-4 apart (7.6e-4 through the single embedder), where
  bfloat16 moves the JAX package's own embeddings 1.4e-3 from its
  float32 ones; held within 2e-3.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from facerec_tpu.models.detector import FaceDetector as JaxFaceDetector
from facerec_tpu.models.facenet import FaceNetEmbedder as JaxEmbedder
from facerec_tpu.models.facenet import cast_float_tree as jax_cast
from facerec_tpu.pipeline.extract import EmbedderBank as JaxBank

from facerec_torch.models import convert
from facerec_torch.models.detector import DetectorHarness, normalize_images
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.models.layers import cast_float_tree
from facerec_torch.pipeline.extract import EmbedderBank
from tests.test_torch_benchdev import _jax_tree

BF16 = torch.bfloat16
HEAD_ATOL_BF16 = 4e-3
EMB_ATOL_BF16 = 2e-3


def test_cast_float_tree_casts_floats_once():
    h = DetectorHarness.create(backbone_width=8, device="cpu",
                               input_size=(32, 32))
    assert cast_float_tree(h.model, torch.float32) is h.model
    assert h.dtype == torch.float32
    model = cast_float_tree(h.model, BF16)
    assert all(p.dtype == BF16 for p in model.parameters())
    assert all(b.dtype == BF16 for b in model.buffers())
    assert DetectorHarness(model=model).dtype == BF16


def test_reduced_dtype_constructors(tmp_path):
    """``create``/``from_npz``, the embedder and the bank take ``dtype``
    and round the float32 weights once; float32 stays the default."""
    h32 = DetectorHarness.create(seed=3, backbone_width=8, device="cpu")
    h16 = DetectorHarness.create(seed=3, backbone_width=8, device="cpu",
                                 dtype=BF16)
    path = str(tmp_path / "det.npz")
    convert.save_params_npz(path, h32.model)
    loaded = DetectorHarness.from_npz(path, device="cpu", dtype=BF16)
    want = {k: v.to(BF16) for k, v in h32.model.state_dict().items()}
    for got in (h16.model.state_dict(), loaded.model.state_dict()):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    emb = FaceNetEmbedder("a", 128, "cpu", seed=1, dtype=BF16)
    assert emb.dtype == BF16 and emb.model.Bottleneck.weight.dtype == BF16
    assert FaceNetEmbedder("a", 128, "cpu").dtype == torch.float32
    bank = EmbedderBank({"a": emb})
    assert bank.pooled.dtypes == [BF16]


def test_bf16_detector_heads_match_jax():
    harness = DetectorHarness.create(backbone_width=16, device="cpu",
                                     input_size=(64, 96))
    variables = jax_cast(_jax_tree(harness.model), jnp.bfloat16)
    frames = np.random.default_rng(1).integers(
        0, 256, (2, 64, 96, 3)).astype(np.uint8)
    x = (jnp.asarray(frames).astype(jnp.bfloat16) - 127.5) / 128.0
    want = jax.jit(JaxFaceDetector(dtype=jnp.bfloat16,
                                   backbone_width=16).apply)(variables, x)
    model = cast_float_tree(harness.model, BF16)
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(frames), BF16))
    for w, g in zip(want, got):
        for k in ("score", "box", "ldm"):
            assert g[k].dtype == torch.float32
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=HEAD_ATOL_BF16)


@pytest.mark.parametrize("pooled", [True, False])
def test_bf16_embeddings_match_jax(pooled):
    emb = FaceNetEmbedder("a", 128, "cpu", seed=0)
    tree = _jax_tree(emb.model)
    crops = np.random.default_rng(0).integers(
        0, 256, (2, 160, 160, 3)).astype(np.uint8)
    jax_emb = JaxEmbedder("a", 128, dtype=jnp.bfloat16, params=tree)
    emb16 = FaceNetEmbedder("a", 128, "cpu", seed=0, dtype=BF16)
    x = torch.from_numpy(crops)
    if pooled:
        want = JaxBank({"a": jax_emb}).pooled(jnp.asarray(crops))[0]
        got = EmbedderBank({"a": emb16}).pooled(x)[0]
    else:
        want = jax_emb(jnp.asarray(crops))
        got = emb16(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EMB_ATOL_BF16)
