"""Scene statistics of the port against the JAX package (CPU).

Where the JAX result is an exact integer (equalization counts) or a
boolean (scene flags), the port must be bit-exact.  The carried means
(``prev_mafd_eq``, ``prev_fv_eq``) are sums over a whole plane, and
torch and XLA add them in other orders: they agree to float32 rounding,
held here at rtol 1e-5.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from facerec_tpu.ops import scene as jscene
from facerec_tpu.ops.pallas.equalize import pack_planes as jpack

from facerec_torch.ops import equalize as eqm
from facerec_torch.ops import scene
from facerec_torch.video.synth import make_frames

CARRY_RTOL = 1e-5


def test_luminance_bit_equal_on_every_rgb_triple():
    """All 2^24 uint8 RGB triples: the float32 Y, and so its histogram
    bin, is the JAX CPU path's exactly."""
    r, g, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    rgb = np.stack([r, g, b], -1).reshape(256, 256 * 256, 3).astype(np.uint8)
    want = np.asarray(jscene.luminance(jnp.asarray(rgb)))
    got = scene.luminance(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, want)
    # why luminance() is not the plain float32 expression: that rounds
    # after every product and sum, and lands elsewhere
    x = torch.from_numpy(rgb).to(torch.float32)
    plain = (x[..., 0] * 0.299 + x[..., 1] * 0.587) + x[..., 2] * 0.114
    assert (plain.numpy() != want).sum() > 0


def test_luminance_bit_equal_on_film_frames():
    frames = make_frames(8, cuts=(4,), seed=2).frames
    want = np.asarray(jscene.luminance(jnp.asarray(frames)))
    np.testing.assert_array_equal(
        scene.luminance(torch.from_numpy(frames)).numpy(), want)


def _plane(rng, shape, real_rows=None):
    """Uniform floats over and past the bin range, every 7th pixel an
    exact integer, rows from ``real_rows`` on padded by pack_planes."""
    b, h, w = shape
    y = rng.uniform(-0.5, 260.0, (b, h, w)).astype(np.float32)
    y.reshape(-1)[::7] = np.floor(y.reshape(-1)[::7])
    if real_rows is not None:
        y = y[:, :real_rows]
    return np.array(jpack(jnp.asarray(y)))


@pytest.mark.parametrize("shape,real_rows", [
    ((2, 40, 96), None),        # rows a multiple of 8
    ((3, 48, 130), 41),         # ragged: 7 padding rows
    ((1, 960, 1920), None),     # a 1080p-class plane (TPU tiled path)
])
def test_plain_equalize_bit_equal_to_jax(shape, real_rows):
    y = _plane(np.random.default_rng(sum(shape)), shape, real_rows)
    want_eq, want_cum = jscene._equalize_raw(jnp.asarray(y))
    before = dict(eqm.launches)
    eq, cum = eqm.equalize_stats(torch.from_numpy(y))
    assert eqm.launches == before       # the CPU never reaches a kernel
    np.testing.assert_array_equal(eq.numpy(), np.asarray(want_eq))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(want_cum))
    np.testing.assert_array_equal(
        eqm.hist256_plain(torch.from_numpy(y)).numpy(),
        np.diff(np.asarray(want_cum), axis=-1, prepend=0).astype(np.int32))


def test_pack_planes_matches_jax():
    y = np.random.default_rng(0).uniform(0, 255, (2, 41, 33)).astype(
        np.float32)
    np.testing.assert_array_equal(
        eqm.pack_planes(torch.from_numpy(y)).numpy(),
        np.asarray(jpack(jnp.asarray(y))))


@pytest.mark.parametrize("bad", [
    np.zeros((2, 16, 8), np.float64),          # not float32
    np.zeros((2, 12, 8), np.float32),          # rows not a multiple of 8
    np.zeros((16, 8), np.float32),             # not (B, R, W)
])
def test_equalize_wrapper_rejects_bad_planes(bad):
    with pytest.raises((TypeError, ValueError)):
        eqm.equalize_stats(torch.from_numpy(bad))


def test_equalize_wrapper_rejects_non_contiguous():
    y = torch.zeros((2, 8, 16)).transpose(1, 2)
    with pytest.raises(ValueError):
        eqm.equalize_stats(y)


def test_kernel_wrappers_refuse_cpu_tensors():
    y = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        eqm.hist256(y)
    with pytest.raises(ValueError, match="CUDA"):
        eqm.cum_lookup(y, torch.zeros((1, 256), dtype=torch.int32))


def test_initial_state_matches_jax():
    want = jscene.initial_state(144, 192, crop=True)
    got = scene.initial_state(144, 192, crop=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("height,width", [(144, 192), (90, 200)])
def test_detect_block_matches_jax_over_three_blocks(height, width):
    """Flags exact and carry equal over consecutive blocks with cuts
    (one cut on a block boundary)."""
    clip = make_frames(48, width=width, height=height, seed=4,
                       cuts=(9, 16, 37))
    jstate = jscene.initial_state(height, width)
    state = scene.initial_state(height, width)
    all_flags = []
    for f0 in range(0, 48, 16):
        block = clip.frames[f0:f0 + 16]
        jflags, jstate = jscene._detect_block_impl(jnp.asarray(block),
                                                   jstate)
        flags, state = scene.detect_block(torch.from_numpy(block), state)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
        np.testing.assert_array_equal(state.prev_y.numpy(),
                                      np.asarray(jstate.prev_y))
        np.testing.assert_array_equal(state.prev_eq.numpy(),
                                      np.asarray(jstate.prev_eq))
        for name in ("prev_mafd_eq", "prev_fv_eq"):
            np.testing.assert_allclose(
                getattr(state, name).numpy(),
                np.asarray(getattr(jstate, name)), rtol=CARRY_RTOL)
        assert int(state.n_seen) == int(jstate.n_seen)
        all_flags.extend(np.nonzero(flags.numpy())[0] + f0)
    assert all_flags == [9, 16, 37]


def test_decide_matches_jax_on_random_statistics():
    rng = np.random.default_rng(1)
    stats = [rng.uniform(-10, 200, 4096).astype(np.float32)
             for _ in range(4)]
    want = np.asarray(jscene.decide(*map(jnp.asarray, stats)))
    got = scene.decide(*map(torch.from_numpy, stats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
