"""The port's wire formats (``facerec_torch/ops/yuv.py``) against the JAX
package's and OpenCV's.

* ``delta_decode`` equals JAX's exactly, with wraparound;
* ``i420_to_rgb`` equals the jitted JAX function on all 2^24 (Y, U, V)
  triples (exact: it redoes XLA's fused multiply-adds in float64);
* the numpy copies of OpenCV's fixed-point conversions equal ``cv2``
  byte for byte: I420→RGB on all 2^24 triples, RGB/BGR→I420 on
  random, flat, edge-valued and ragged frames at several sizes;
* ``encode_delta`` gives the same bytes from the native library and
  numpy; shapes are checked as the JAX package checks them.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_tpu.ops import yuv as jax_yuv
from facerec_torch.ops import yuv
from facerec_torch.runtime import native


def all_triples():
    """64 I420 frames of 4×65536: each 2×2 block has its own (U, V), so
    a frame holds all 65,536 pairs, and frame f's blocks hold Y = 4f ..
    4f + 3 — every (Y, U, V) triple once."""
    h, w = 4, 65536
    uv = np.arange(65536)
    u, v = (uv >> 8).astype(np.uint8), (uv & 255).astype(np.uint8)
    frames = np.empty((64, yuv.i420_rows(h), w), np.uint8)
    for f in range(64):
        y = np.empty((h, w), np.uint8)
        y[0::2, 0::2], y[0::2, 1::2] = 4 * f, 4 * f + 1
        y[1::2, 0::2], y[1::2, 1::2] = 4 * f + 2, 4 * f + 3
        frames[f] = np.concatenate([y.reshape(-1), u, v]).reshape(-1, w)
    return frames, h


@pytest.fixture(scope="module")
def triples():
    return all_triples()


@pytest.mark.parametrize("shape", [(17, 36, 48), (9, 24, 32, 3)])
def test_delta_decode_exact_against_jax(shape):
    """I420 planes and RGB frames, with deltas that wrap around."""
    rng = np.random.default_rng(0)
    block = rng.integers(0, 256, shape, dtype=np.uint8)
    block[1::2] = 255 - block[::2][:len(block[1::2])]
    delta = yuv.encode_delta(block)
    got = yuv.delta_decode(torch.from_numpy(delta)).numpy()
    want = np.asarray(jax_yuv.delta_decode(jnp.asarray(delta)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, block)


def test_i420_to_rgb_equals_jax_on_all_triples(triples):
    frames, h = triples
    want = np.asarray(jax.jit(lambda x: jax_yuv.i420_to_rgb(x, h))(
        jnp.asarray(frames)))
    got = yuv.i420_to_rgb(torch.from_numpy(frames), h).numpy()
    assert np.count_nonzero(got != want) == 0


@pytest.mark.parametrize("b,h,w", [(16, 144, 192), (2, 576, 768),
                                   (3, 48, 64), (4, 24, 32)])
def test_delta_i420_to_rgb_equals_jax_at_film_shapes(b, h, w):
    rng = np.random.default_rng(h)
    wire = rng.integers(0, 256, (b, yuv.i420_rows(h), w), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda x: jax_yuv.delta_i420_to_rgb(x, h))(
        jnp.asarray(wire)))
    got = yuv.delta_i420_to_rgb(torch.from_numpy(wire), h).numpy()
    np.testing.assert_array_equal(got, want)


def test_i420_frame_to_rgb_equals_cv2_on_all_triples(triples):
    frames, _ = triples
    for f in frames:
        np.testing.assert_array_equal(
            yuv.i420_frame_to_rgb(f), cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420))


def _frames(kind, h, w, rng):
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), rng.integers(0, 256), np.uint8)
    if kind == "edge":
        return rng.choice(np.array([0, 1, 254, 255], np.uint8), (h, w, 3))
    # ragged content: a noisy gradient with a bright moving rectangle
    g = np.linspace(0, 255, w)[None, :, None] + rng.normal(0, 9, (h, w, 3))
    im = np.clip(g, 0, 255).astype(np.uint8)
    im[h // 5:h // 2, w // 3:w // 2] = (230, 40, 200)
    return im


@pytest.mark.parametrize("h,w", [(2, 2), (6, 10), (144, 192), (150, 210),
                                 (576, 768), (1080, 1920)])
@pytest.mark.parametrize("kind", ["random", "flat", "edge", "ragged"])
def test_rgb_and_bgr_to_i420_equal_cv2(kind, h, w):
    im = _frames(kind, h, w, np.random.default_rng(h * w))
    np.testing.assert_array_equal(yuv.rgb_to_i420(im),
                                  cv2.cvtColor(im, cv2.COLOR_RGB2YUV_I420))
    np.testing.assert_array_equal(yuv.rgb_to_i420(im, bgr=True),
                                  cv2.cvtColor(im, cv2.COLOR_BGR2YUV_I420))


def test_encode_block_equals_jax():
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (5, 48, 64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(yuv.encode_block(frames),
                                  jax_yuv.encode_block(frames))


def test_encode_delta_native_equals_numpy(monkeypatch):
    if not native.delta_available():
        pytest.skip("the native library does not load on this host")
    rng = np.random.default_rng(3)
    block = rng.integers(0, 256, (7, 30, 40, 3)).astype(np.uint8)
    got_native = yuv.encode_delta(block)
    assert yuv.encode_path() == "native"
    monkeypatch.setattr(native, "delta_available", lambda: False)
    assert yuv.encode_path() == "numpy"
    np.testing.assert_array_equal(yuv.encode_delta(block), got_native)
    np.testing.assert_array_equal(got_native, jax_yuv.encode_delta(block))
    assert (yuv.encode_delta(np.broadcast_to(
        block[:1], block.shape).copy())[1:] == 0).all()


def test_i420_shape_validation():
    """As tests/test_yuv_ops.py:64-69 for the JAX package."""
    with pytest.raises(ValueError):
        yuv.i420_rows(33)
    with pytest.raises(ValueError):
        yuv.i420_to_rgb(torch.zeros((1, 36, 47), dtype=torch.uint8), 24)
    with pytest.raises(ValueError):
        yuv.rgb_to_i420(np.zeros((5, 8, 3), np.uint8))
