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

from facerec_torch.ops import _build, assignment
from facerec_torch.track import (TrackerConfig, TrajectoryAssembler,
                                 init_tracker, run_block)
from facerec_torch.track import streams
from facerec_torch.track import tracker as trk

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


def test_cpu_tensors_take_the_plain_loop_and_load_no_kernel():
    """run_block on CPU tensors is run_block_plain, bit for bit; it
    neither builds nor loads the tracker_scan library, nor counts a
    launch."""
    rng = np.random.default_rng(4)
    det_stream, cuts = simulate_stream(rng, n_frames=24, p_cut=0.05)
    bx, valid = _stream_arrays(det_stream, 8)
    cfg = TrackerConfig(max_tracks=16, max_detections=8)
    before = dict(trk.launches)
    args = (t(bx), t(valid), t(cuts), 5)
    state, emit = run_block(cfg, init_tracker(cfg), *args)
    p_state, p_emit = trk.run_block_plain(cfg, init_tracker(cfg), *args)
    for got, want in zip(list(emit) + list(state[1:]),
                         list(p_emit) + list(p_state[1:])):
        assert torch.equal(got, want)
    assert torch.equal(state.kf.x, p_state.kf.x)
    assert torch.equal(state.kf.p, p_state.kf.p)
    assert trk.launches == before
    assert trk._lib is None and "tracker" not in _build._loaded


@pytest.mark.parametrize("t_slots,d,ok", [
    (32, 16, True), (33, 16, True), (64, 48, True), (128, 128, True),
    (1, 1, True), (129, 16, False), (32, 129, False), (0, 8, False)])
def test_kernel_shape_limits(t_slots, d, ok):
    """tracker_scan takes 1..128 slots and detections (8 threads a slot,
    1,024 at most); the wrapper refuses the rest before any launch."""
    cfg = TrackerConfig(max_tracks=t_slots, max_detections=d)
    boxes = torch.zeros((4, d, 4))
    if ok:
        trk.check_scan_shapes(cfg, boxes)
    else:
        with pytest.raises(ValueError, match="1..128"):
            trk.check_scan_shapes(cfg, boxes)


@pytest.mark.parametrize("b,t_slots,d", [(128, 32, 16), (7, 3, 8),
                                         (64, 128, 128)])
def test_output_views_are_disjoint_contiguous_views(b, t_slots, d):
    """The kernel's outputs are views of one float32 and one int32
    buffer (what the card path allocates, built here on CPU tensors):
    each of the right shape and dtype, contiguous, and no two views
    overlapping each other or the inputs."""
    cfg = TrackerConfig(max_tracks=t_slots, max_detections=d)
    state_in = init_tracker(cfg)
    ins = [torch.zeros((b, d, 4)), torch.zeros((b, d), dtype=torch.bool),
           torch.zeros((b,), dtype=torch.bool), *state_in.kf,
           *state_in[1:]]
    new, emit = trk.output_views(b, t_slots, d, torch.device("cpu"))
    want = {"x": ((t_slots, 8), torch.float32),
            "p": ((t_slots, 8, 8), torch.float32),
            "active": ((t_slots,), torch.bool),
            **{n: ((t_slots,), torch.int32) for n in trk._STATE_I32},
            "next_uid": ((), torch.int32),
            "box": ((b, t_slots, 4), torch.float32),
            "emit": ((b, t_slots), torch.bool),
            "detected": ((b, t_slots), torch.bool),
            "uid_e": ((b, t_slots), torch.int32),
            "first_frame_e": ((b, t_slots), torch.int32),
            "det_slot": ((b, d), torch.int32),
            "overflow": ((b,), torch.int32)}
    outs = [*new.kf, *new[1:], *emit]
    assert len(outs) == len(want)
    for x, (name, (shape, dtype)) in zip(outs, want.items()):
        assert tuple(x.shape) == shape and x.dtype == dtype, name
        assert x.is_contiguous(), name
    assert len({x.untyped_storage().data_ptr() for x in outs}) == 2
    spans = sorted((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size())
                   for x in outs + ins)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    # the kernel stores the box emissions as 16-byte groups
    assert emit.box.data_ptr() % 16 == 0 and new.kf.p.data_ptr() % 16 == 0


@pytest.mark.parametrize("max_tracks", [64, 40])
def test_crowd_matches_jax(max_tracks):
    """crowd48 (48 objects at 768x576, a cut at frame 48) at D = 48: at
    T = 64 more than 32 slots follow a track at once; at T = 40, D > T
    sends every frame to the JV solve on K = 48 > 32, and detections
    overflow.  Integers exact, boxes within BOX_ATOL of the JAX
    package's run_block on the same numpy stream."""
    d, block = 48, 48
    det_stream, cuts = streams.crowd_stream(np.random.default_rng(0),
                                            **streams.CROWDS["crowd48"])
    bx, valid = streams.stream_arrays(det_stream, d)
    jcfg = JaxTrackerConfig(max_tracks=max_tracks, max_detections=d)
    cfg = TrackerConfig(max_tracks=max_tracks, max_detections=d)
    jstate, state = jax_init_tracker(jcfg), init_tracker(cfg)
    assignment.solves["jv"] = 0
    most, overflow = 0, 0
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
        most = max(most, int(emit.emit.sum(dim=1).max()))
        overflow += int(emit.overflow.sum())
    if max_tracks == 64:
        assert most > 32 and overflow == 0
    else:
        assert assignment.solves["jv"] == len(det_stream) and overflow > 0


def test_port_stream_is_the_jax_tests_stream():
    """chip_smoke.py replays the CPU tests' stream from the port's copy
    of ``simulate_stream``."""
    for seed in range(4):
        want = simulate_stream(np.random.default_rng(seed), n_frames=60,
                               p_cut=0.05)
        got = streams.simulate_stream(np.random.default_rng(seed),
                                      n_frames=60, p_cut=0.05)
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[0]) == len(want[0])
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("stream,max_tracks,d,least", [
    ("crossing", 32, 16, 40),       # collisions and ties at T = 32
    ("simulate", 3, 8, 60),         # D > T: every frame solves
])
def test_streams_reach_the_solver(stream, max_tracks, d, least):
    """The streams that chip_smoke.py holds the kernel to its plain
    version on send frames to the JV solve in the plain version."""
    if stream == "crossing":
        det_stream, cuts = streams.crossing_stream(np.random.default_rng(0))
    else:
        det_stream, cuts = streams.simulate_stream(
            np.random.default_rng(3), n_frames=60, p_cut=0.05)
    bx, valid = streams.stream_arrays(det_stream, d)
    cfg = TrackerConfig(max_tracks=max_tracks, max_detections=d)
    assignment.solves["jv"] = 0
    state = init_tracker(cfg)
    for f0 in range(0, len(det_stream), 128):
        sl = slice(f0, f0 + 128)
        state, emit = trk.run_block_plain(cfg, state, t(bx[sl]),
                                          t(valid[sl]), t(cuts[sl]), f0)
    assert assignment.solves["jv"] >= least
    assert int(state.next_uid) > 0
