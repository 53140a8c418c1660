"""The port's FaceNet against the JAX package's (CPU).

One full Inception-ResNet-v1 (the architecture has no width knob) with
random Flax parameters and perturbed batch statistics is carried across
with ``convert.facenet_state_dict``; its unit embeddings agree within
1e-4 (convolutions summed in another order through 40-odd layers).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from facerec_tpu.models.facenet import FaceNetEmbedder as JaxEmbedder
from facerec_tpu.models.facenet import prewhiten as jax_prewhiten

from facerec_torch.models import convert
from facerec_torch.models.facenet import (FaceNetEmbedder, PooledEmbedders,
                                          prewhiten)
from tests.test_torch_detector import _numpy_tree, _perturb

EMB_ATOL = 1e-4
PREWHITEN_ATOL = 1e-6
POOLED_ATOL = 1e-6       # same math, a matmul in place of nn.Linear


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(0).integers(
        0, 256, (2, 160, 160, 3)).astype(np.uint8)


def test_embeddings_match_jax(crops):
    jax_emb = JaxEmbedder("20170512-110547", 128, rng_seed=3)
    variables = _numpy_tree(jax_emb.variables)
    _perturb(variables, np.random.default_rng(1))
    jax_emb.variables = jax.tree.map(jnp.asarray, variables)
    want = np.asarray(jax_emb(jnp.asarray(crops)))

    port = FaceNetEmbedder("20170512-110547", 128, device="cpu")
    port.model.load_state_dict(convert.facenet_state_dict(variables))
    got = port(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    assert port.model.Bottleneck_BatchNorm.momentum == 0.99
    assert port.model.Conv2d_1a_3x3.bn.momentum == 0.995


def test_pooled_bank_equals_individual_embedders(crops):
    bank = [FaceNetEmbedder("a", 512, "cpu", seed=0),
            FaceNetEmbedder("b", 128, "cpu", seed=1)]
    x = torch.from_numpy(crops)
    pooled = PooledEmbedders(bank)(x)
    assert [p.shape[1] for p in pooled] == [512, 128]
    for emb, got in zip(bank, pooled):
        np.testing.assert_allclose(got.numpy(), emb(x).numpy(), rtol=0,
                                   atol=POOLED_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                                   atol=1e-6)


def test_seeded_init_is_deterministic(crops):
    a = FaceNetEmbedder("a", 128, "cpu", seed=7).model.state_dict()
    b = FaceNetEmbedder("a", 128, "cpu", seed=7).model.state_dict()
    c = FaceNetEmbedder("a", 128, "cpu", seed=8).model.state_dict()
    key = "Conv2d_1a_3x3.conv.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])


def test_prewhiten_matches_jax(crops):
    np.testing.assert_allclose(
        prewhiten(torch.from_numpy(crops)).numpy(),
        np.asarray(jax_prewhiten(jnp.asarray(crops))), rtol=0,
        atol=PREWHITEN_ATOL)
    flat = np.full((1, 160, 160, 3), 7, np.uint8)      # zero variance
    np.testing.assert_allclose(
        prewhiten(torch.from_numpy(flat)).numpy(),
        np.asarray(jax_prewhiten(jnp.asarray(flat))), atol=PREWHITEN_ATOL)
