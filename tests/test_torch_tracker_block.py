"""The port's tracker scan over frame blocks against the JAX package's
(CPU): slots, uids, emission flags and overflow exact, boxes within
1e-4 px (small matrix products summed in another order), and the
assembled trajectory records identical.  Split from
``test_torch_tracker.py`` to spread the JAX compiles over test workers.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from facerec_tpu.track import TrackerConfig as JaxTrackerConfig
from facerec_tpu.track import TrajectoryAssembler as JaxAssembler
from facerec_tpu.track import init_tracker as jax_init_tracker
from facerec_tpu.track import run_block as jax_run_block
from tests.test_tracker import simulate_stream

from facerec_torch.track import (TrackerConfig, TrajectoryAssembler,
                                 init_tracker, run_block)

BOX_ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stream_arrays(det_stream, d):
    n = len(det_stream)
    bx = np.zeros((n, d, 4), np.float32)
    valid = np.zeros((n, d), bool)
    for f, dets in enumerate(det_stream):
        for i, b in enumerate(dets[:d]):
            bx[f, i] = b
            valid[f, i] = True
    return bx, valid


@pytest.mark.parametrize("seed,block,max_tracks", [
    (0, 16, 16), (1, 7, 16), (2, 40, 16),
    (3, 16, 3),                        # track overflow
])
def test_run_block_matches_jax(seed, block, max_tracks):
    rng = np.random.default_rng(seed)
    det_stream, cuts = simulate_stream(rng, n_frames=60, p_cut=0.05)
    assert cuts.any()
    d = 8
    bx, valid = _stream_arrays(det_stream, d)
    jcfg = JaxTrackerConfig(max_tracks=max_tracks, max_detections=d)
    cfg = TrackerConfig(max_tracks=max_tracks, max_detections=d)
    jstate, state = jax_init_tracker(jcfg), init_tracker(cfg)
    jasm = JaxAssembler(320, 240)
    asm = TrajectoryAssembler(320, 240)
    want_rec, got_rec, overflow = [], [], 0
    for f0 in range(0, len(det_stream), block):
        sl = slice(f0, f0 + block)
        jstate, jemit = jax_run_block(
            jcfg, jstate, jnp.asarray(bx[sl]), jnp.asarray(valid[sl]),
            jnp.asarray(cuts[sl]), jnp.int32(f0))
        state, emit = run_block(cfg, state, t(bx[sl]), t(valid[sl]),
                                t(cuts[sl]), f0)
        for name in ("det_slot", "uid", "emit", "detected",
                     "first_frame", "overflow"):
            np.testing.assert_array_equal(
                getattr(emit, name).numpy(),
                np.asarray(getattr(jemit, name)), err_msg=name)
        np.testing.assert_allclose(emit.box.numpy(), np.asarray(jemit.box),
                                   rtol=0, atol=BOX_ATOL)
        overflow += int(emit.overflow.sum())
        want_rec.extend(jasm.feed(jemit, f0))
        got_rec.extend(asm.feed(TrackEmitNumpy(emit), f0))
    want_rec.extend(jasm.finish())
    got_rec.extend(asm.finish())
    assert got_rec == want_rec and got_rec
    assert (overflow > 0) == (max_tracks == 3)


def TrackEmitNumpy(emit):
    """The host copy the extract stage hands the assembler."""
    return type(emit)(*(f.numpy() for f in emit))


def test_overflow_counted():
    cfg = TrackerConfig(max_tracks=2, max_detections=4)
    bx = np.zeros((1, 4, 4), np.float32)
    for i in range(4):
        bx[0, i] = [i * 50, 0, i * 50 + 40, 40]
    _, emit = run_block(cfg, init_tracker(cfg), t(bx),
                        torch.ones((1, 4), dtype=torch.bool),
                        torch.zeros((1,), dtype=torch.bool), 0)
    assert int(emit.overflow[0]) == 2
