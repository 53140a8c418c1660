"""The port's FaceNet training path against the JAX package's (CPU).

Triplet mining on the same embeddings: distances within 1e-5, the loss
and its gradient within 1e-6 (rtol 1e-5), including exact ties (a crop
twice in a batch, as PK sampling with replacement gives) and a batch
of one identity (exactly 0, no gradient).  One ``FaceNetTrainer`` step
of the full Inception-ResNet-v1 on 4 crops of 2 identities at 160²,
from one initial state: in float64 in both packages the loss within
rtol 1e-6, every gradient leaf within 1e-6 of its max |g| and the batch
statistics within 1e-12; in float32 the loss within rtol 1e-5 of the
float64 one (1e-4 of JAX's float32 loss) and the batch statistics
within 1e-6.  The standalone trainer's ``.npz`` loads in both packages.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from facerec_tpu.models.facenet import FaceNetEmbedder as JaxEmbedder
from facerec_tpu.models.weights import load_params_npz
from facerec_tpu.train.facenet_train import FaceNetTrainer as JaxTrainer
from facerec_tpu.train.facenet_train import \
    pairwise_sq_dists as jax_pairwise
from facerec_tpu.train.facenet_train import \
    semi_hard_triplet_loss as jax_triplet
from facerec_tpu.video.synth import identity_crops as jax_identity_crops

from facerec_torch.config import EMB_NAME
from facerec_torch.models import convert
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.models.facenet import prewhiten as port_prewhiten
from facerec_torch.train.facenet_train import (FaceNetTrainer,
                                               IdentityCropDataset,
                                               pairwise_sq_dists,
                                               semi_hard_triplet_loss)
from tests.test_torch_detector import _numpy_tree
from tests.test_torch_train import (assert_grads_close, assert_stats_close,
                                    torch_grads_of)

DIST_ATOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
F64_LOSS_RTOL = 1e-6      # JAX's FaceNet casts its output to float32
F64_GRAD_REL = 1e-6       # max |Δg| over the leaf's max |g|
F64_STATS_ATOL = 1e-12
F32_LOSS_RTOL = 1e-4      # the port's float32 loss against JAX's
STATS_ATOL = 1e-6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def triplet_pair(emb, labels):
    """(loss, grad) of the JAX function and of the port's."""
    want, want_g = jax.value_and_grad(jax_triplet)(jnp.asarray(emb),
                                                   jnp.asarray(labels))
    e = torch.from_numpy(emb).requires_grad_()
    got = semi_hard_triplet_loss(e, torch.from_numpy(labels))
    got.backward()
    return (float(want), np.asarray(want_g)), (float(got), e.grad.numpy())


def test_pairwise_sq_dists_match_jax(rng):
    x = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(
        pairwise_sq_dists(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pairwise(jnp.asarray(x))), rtol=0, atol=DIST_ATOL)


@pytest.mark.parametrize("case", ["mixed", "separated", "duplicate_random",
                                  "duplicate_exact"])
def test_semi_hard_triplet_loss_and_gradient_match_jax(rng, case):
    labels = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    if case == "mixed":
        emb = _unit(rng.normal(size=(8, 8)))
    elif case == "separated":
        emb = _unit(np.eye(8)[[0] * 4 + [7] * 4]
                    + rng.normal(size=(8, 8)) * 0.01)
        labels = np.repeat([0, 1], 4)
    elif case == "duplicate_random":
        emb = _unit(rng.normal(size=(8, 8)))
        emb[4] = emb[0]            # one crop twice: d2 ≈ 0 off the diagonal
    else:
        # dyadic entries: every sum is exact, so the duplicate's d2 is
        # exactly 0 in both packages and the clamp sits on its tie, and
        # the two copies tie exactly as negatives of the other label
        emb = rng.integers(-4, 5, (8, 8)).astype(np.float32) / 8
        emb[4] = emb[0]
        emb[5] = emb[3]
    (want, want_g), (got, got_g) = triplet_pair(emb, labels)
    assert want > 0 or case == "separated"
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got_g, want_g, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_single_identity_batch_gives_exactly_zero(rng):
    emb = _unit(rng.normal(size=(6, 8)))
    labels = np.zeros(6, np.int64)
    (want, want_g), (got, got_g) = triplet_pair(emb, labels)
    assert got == want == 0.0
    assert not np.any(got_g) and not np.any(want_g)


@pytest.fixture(scope="module")
def facenet_step():
    """One step of the full net on 4 crops of 2 identities from one
    initial state: the JAX trainer's loss in float32 (its value) and in
    float64 (value, gradient, batch statistics), and the port's
    ``FaceNetTrainer.step`` in both dtypes."""
    from facerec_tpu.models.facenet import FaceNet as JaxFaceNet
    from facerec_tpu.models.facenet import prewhiten

    rng = np.random.default_rng(0)
    crops = np.concatenate([jax_identity_crops(rng, a, 2) for a in (0, 1)])
    labels = np.array([0, 0, 1, 1], np.int32)
    init = _numpy_tree(JaxTrainer(embedding_dim=128).init(0)[0])
    # the JAX package prewhitens in float32 whatever the model's dtype,
    # and both packages' float32 prewhitening differs in the last bit,
    # enough to move a pre-activation 3.7e-7 from a ReLU's kink to its
    # other side: the float64 step takes the port's float64 crops
    white = {jnp.float32: prewhiten(jnp.asarray(crops)),
             jnp.float64: port_prewhiten(torch.from_numpy(crops),
                                         torch.float64).numpy()}
    np.testing.assert_allclose(white[jnp.float64], white[jnp.float32],
                               rtol=0, atol=1e-5)

    def jax_loss(dtype):
        model = JaxFaceNet(embedding_dim=128, dtype=dtype)
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)

        def loss_fn(params):
            emb, mut = model.apply(
                {"params": params, "batch_stats": cast(init["batch_stats"])},
                jnp.asarray(white[dtype], dtype), train=True,
                mutable=["batch_stats"])
            emb = emb / jnp.maximum(jnp.linalg.norm(emb, axis=-1,
                                                    keepdims=True), 1e-12)
            return jax_triplet(emb, jnp.asarray(labels)), mut["batch_stats"]
        return loss_fn, cast(init["params"])

    out = {}
    loss_fn, params = jax_loss(jnp.float32)
    out["jax32"] = float(jax.jit(loss_fn)(params)[0])
    with jax.enable_x64(True):
        loss_fn, params = jax_loss(jnp.float64)
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        out["jax64"] = {"loss": float(loss), "grads": torch_grads_of(grads),
                        "stats": _numpy_tree(stats)}
    for dtype in (torch.float32, torch.float64):
        trainer = FaceNetTrainer(embedding_dim=128, learning_rate=3e-4,
                                 device="cpu")
        trainer.model.load_state_dict(convert.facenet_state_dict(init))
        trainer.model.to(dtype)
        out[dtype] = (float(trainer.step(crops, labels)), trainer.model)
    return out


def test_facenet_step_matches_jax(facenet_step):
    """The same step in float64 in both packages: loss, every gradient
    leaf and the batch statistics.  In float32 each package rounds on
    its own, and a gradient leaf can move by a few percent where a
    pre-activation lies within rounding of a ReLU's kink; JAX's float32
    loss lies 7.5e-5 from the float64 one, the port's 2e-6."""
    s = facenet_step
    want = s["jax64"]
    assert want["loss"] > 0
    got64, model64 = s[torch.float64]
    np.testing.assert_allclose(got64, want["loss"], rtol=F64_LOSS_RTOL)
    assert_grads_close({k: p.grad.numpy()
                        for k, p in model64.named_parameters()},
                       want["grads"], rel=F64_GRAD_REL)
    assert_stats_close(model64, want["stats"], atol=F64_STATS_ATOL)
    got32, model32 = s[torch.float32]
    np.testing.assert_allclose(got32, want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got32, s["jax32"], rtol=F32_LOSS_RTOL)
    assert_stats_close(model32, want["stats"], atol=STATS_ATOL)


def test_identity_crop_dataset_matches_jax(tmp_path, rng):
    """PK batches from a directory tree (with replacement where an
    identity has fewer than K crops), the same as the JAX dataset's."""
    import cv2

    from facerec_tpu.train.facenet_train import IdentityCropDataset as J

    for ident, n in (("anna", 4), ("bertil", 2), ("cecilia", 3)):
        d = tmp_path / ident
        d.mkdir()
        for i, c in enumerate(jax_identity_crops(rng, len(ident), n,
                                                 size=48)):
            cv2.imwrite(str(d / f"c{i}.jpg"),
                        cv2.cvtColor(c, cv2.COLOR_RGB2BGR))
    (tmp_path / "notes.txt").write_text("ignored")
    td = IdentityCropDataset(str(tmp_path), crop_size=32)
    jd = J(str(tmp_path), crop_size=32)
    assert td.idents == jd.idents == ["anna", "bertil", "cecilia"]
    tit = td.batches(3, 3, np.random.default_rng(0))
    jit = jd.batches(3, 3, np.random.default_rng(0))
    for _ in range(3):
        (ti, tl), (ji, jl) = next(tit), next(jit)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    assert ti.shape == (9, 32, 32, 3) and sorted(set(tl)) == [0, 1, 2]


def test_identity_crop_dataset_without_opencv_says_so(tmp_path,
                                                      monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        IdentityCropDataset(str(tmp_path))


def test_port_written_facenet_npz_loads_in_both_packages(tmp_path):
    """``save_params_npz`` of a FaceNet: the JAX package's
    ``load_params_npz`` restores it and embeds as the port does (1e-4,
    the FaceNet tolerance), and the port's loader resolves it exactly."""
    from facerec_torch.models.load import resolve_facenet_params
    from tests.test_torch_detector import _perturb

    rng = np.random.default_rng(5)
    template = JaxEmbedder(EMB_NAME, 128).variables
    tree = _numpy_tree(template)
    _perturb(tree, rng)
    port = FaceNetEmbedder(EMB_NAME, 128, "cpu",
                           state_dict=convert.facenet_state_dict(tree))
    d = tmp_path / "w"
    d.mkdir()
    convert.save_params_npz(str(d / f"{EMB_NAME}.npz"), port.model)
    loaded = load_params_npz(str(d / f"{EMB_NAME}.npz"), template)
    crops = rng.integers(0, 256, (2, 160, 160, 3)).astype(np.uint8)
    want = np.asarray(JaxEmbedder(EMB_NAME, 128, params=loaded)(
        jnp.asarray(crops)))
    np.testing.assert_allclose(port(torch.from_numpy(crops)).numpy(), want,
                               rtol=0, atol=1e-4)
    state = convert.facenet_state_dict(
        resolve_facenet_params(str(d), EMB_NAME), 128)
    for k, v in port.model.state_dict().items():
        assert torch.equal(state[k], v), k


@pytest.mark.slow
def test_facenet_train_cli_checkpoint_deploys(tmp_path, rng):
    """Identity dirs → 2-step train (recalibration on) →
    ``<out>/<name>.npz``, which the weights loader resolves."""
    import cv2

    from facerec_torch.models.load import load_facenet_embedders
    from facerec_torch.train.facenet_train import main

    root = tmp_path / "ids"
    for ident in range(3):
        d = root / f"id{ident}"
        d.mkdir(parents=True)
        for i, c in enumerate(jax_identity_crops(rng, ident, 3)):
            cv2.imwrite(str(d / f"c{i}.jpg"),
                        cv2.cvtColor(c, cv2.COLOR_RGB2BGR))
    out = str(tmp_path / "weights")
    main(["--root", str(root), "--out", out, "--steps", "2",
          "--ids-per-batch", "3", "--crops-per-id", "2", "--device", "cpu"])
    assert os.path.isfile(os.path.join(out, f"{EMB_NAME}.npz"))
    emb = load_facenet_embedders(out, names=[EMB_NAME], device="cpu")
    crops = torch.from_numpy(rng.integers(0, 255, (2, 160, 160, 3)).astype(
        np.uint8))
    e = emb[EMB_NAME](crops).numpy()
    assert e.shape == (2, 128) and np.isfinite(e).all()
