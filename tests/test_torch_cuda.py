"""Checks that need the card (marker ``cuda``; they skip without one).

Run on a machine with a GPU: ``python -m pytest tests/test_torch_cuda.py
-m cuda -q`` (add ``--noconftest`` where JAX is not installed: the
repo's conftest imports it, these tests do not).  ``chip_smoke.py``
covers the same ground at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from facerec_torch.ops import equalize as eqm
from facerec_torch.ops import scene
from facerec_torch.video.synth import make_frames

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,real_rows", [((4, 64, 96), 64),
                                             ((3, 48, 130), 41)])
def test_kernels_bit_equal_to_plain(card, shape, real_rows):
    rng = np.random.default_rng(0)
    y = np.full(shape, -1.0, np.float32)
    y[:, :real_rows] = rng.uniform(-0.5, 260, (shape[0], real_rows,
                                               shape[2]))
    y[:, 0, ::5] = np.floor(y[:, 0, ::5])
    yc = torch.from_numpy(y).to(card)
    before = dict(eqm.launches)
    eq, cum = eqm.equalize_stats(yc)
    assert eqm.launches["hist256"] == before["hist256"] + 1
    assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 1
    eq_p, cum_p = eqm.equalize_stats_plain(yc)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)


def _rgb(kind, shape, seed=0):
    """(B, H, W, 3) uint8: noise, black, white or a dark scene."""
    if kind == "black":
        return np.zeros((*shape, 3), np.uint8)
    if kind == "white":
        return np.full((*shape, 3), 255, np.uint8)
    high = 8 if kind == "dark" else 256
    return np.random.default_rng(seed).integers(
        0, high, (*shape, 3)).astype(np.uint8)


@pytest.mark.parametrize("grayscale", [False, True])
@pytest.mark.parametrize("kind", ["noisy", "black", "white", "dark"])
@pytest.mark.parametrize("shape,crop", [
    ((4, 72, 96), True),        # W % 16 == 0: staged loads, crop to 48 rows
    ((2, 90, 192), False),      # staged, 6 padding rows
    ((3, 41, 130), False),      # ragged width: byte loads, 7 padding rows
])
def test_rgb_entry_bit_equal_to_plain(card, shape, crop, kind, grayscale):
    """hist256 from uint8 frames, and both entry points on its plane,
    bit-equal to the plain versions; one launch counted per call, under
    the entry point's own key.  The white frames in grayscale are the
    constant bin-255 case."""
    frames = torch.from_numpy(_rgb(kind, shape)).to(card)
    lo, hi = scene.crop_bounds(shape[1], shape[2], crop)
    before = dict(eqm.launches)
    y, hist = eqm.hist256_rgb(frames, lo, hi, grayscale)
    assert eqm.launches == {**before, "hist256_rgb": before["hist256_rgb"] + 1}
    hist_plane = eqm.hist256(y)
    assert eqm.launches["hist256"] == before["hist256"] + 1
    eq, cum = eqm.cum_lookup(y, hist)
    y_p, hist_p = eqm.hist256_rgb_plain(frames, lo, hi, grayscale)
    eq_p, cum_p = eqm.cum_lookup_plain(y_p, hist_p)
    torch.cuda.synchronize()
    assert torch.equal(y, y_p)
    assert torch.equal(hist, hist_p) and torch.equal(hist_plane, hist_p)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)
    if kind == "white" and grayscale:
        assert int(hist[:, 255].min()) == (hi - lo) * shape[2]


@pytest.mark.parametrize("value", [0.0, 255.0, 255.5, "dark"])
def test_plane_entry_on_constant_and_dark_planes(card, value):
    shape = (3, 48, 130)
    if value == "dark":
        y = np.random.default_rng(1).uniform(0, 8, shape)
    else:
        y = np.full(shape, value)
    yc = torch.from_numpy(y.astype(np.float32)).to(card)
    before = dict(eqm.launches)
    eq, cum = eqm.equalize_stats(yc)
    assert eqm.launches["hist256"] == before["hist256"] + 1
    assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 1
    eq_p, cum_p = eqm.equalize_stats_plain(yc)
    assert torch.equal(eq, eq_p) and torch.equal(cum, cum_p)


def test_rgb_entry_on_unaligned_frames(card):
    """Frames that do not start on a 16-byte boundary take byte loads
    and give the same result."""
    b, h, w = 2, 40, 96
    flat = torch.from_numpy(_rgb("noisy", (b, h, w))).reshape(-1).to(card)
    buf = torch.zeros(flat.numel() + 1, dtype=torch.uint8, device=card)
    buf[1:] = flat
    frames = buf[1:].view(b, h, w, 3)
    assert frames.data_ptr() % 16 and frames.is_contiguous()
    y, hist = eqm.hist256_rgb(frames, 4, 36)
    y_p, hist_p = eqm.hist256_rgb_plain(frames, 4, 36)
    assert torch.equal(y, y_p) and torch.equal(hist, hist_p)


def test_plane_entry_refuses_unaligned_plane(card):
    buf = torch.zeros(2 * 8 * 16 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        eqm.hist256(buf[1:].view(2, 8, 16))


def test_detect_block_card_equals_cpu(card):
    clip = make_frames(32, seed=4, cuts=(9, 20))
    flags = []
    for dev in (card, torch.device("cpu")):
        state = scene.initial_state(144, 192, device=dev)
        f, state = scene.detect_block(
            torch.from_numpy(clip.frames).to(dev), state)
        flags.append(f.cpu().numpy())
    np.testing.assert_array_equal(flags[0], flags[1])
    assert np.nonzero(flags[0])[0].tolist() == [9, 20]


@pytest.mark.parametrize("n", [40, 300])
def test_linkage_loop_card_equals_cpu_on_the_cards_matrix(card, n):
    """The merge loop on the card records what the CPU loop records on
    the card's own distance matrix, duplicates (exact ties) included."""
    from facerec_torch.ops import linkage

    rng = np.random.default_rng(n)
    base = rng.normal(size=(n // 2, 16)).astype(np.float32)
    x = np.concatenate([base, base[: n - n // 2]])
    dist = linkage.pairwise_distances(torch.from_numpy(x).to(card))
    got = linkage.complete_linkage_merges(dist).cpu()
    want = linkage.complete_linkage_merges(dist.cpu())
    assert torch.equal(got, want)


def test_knn_selection_card_equals_cpu_on_the_cards_matrix(card):
    """The stable sort on the card picks the CPU's neighbours, ties
    (repeated training rows) to the lower index."""
    from facerec_torch.ops import knn

    rng = np.random.default_rng(0)
    train = np.repeat(rng.normal(size=(30, 16)), 4, axis=0)
    query = np.concatenate([train[::7], rng.normal(size=(200, 16))])
    d2 = knn.squared_distances(
        torch.from_numpy(query.astype(np.float32)).to(card),
        torch.from_numpy(train.astype(np.float32)).to(card))
    for k in (1, 4, 10):
        assert torch.equal(knn.nearest(d2, k).cpu(),
                           knn.nearest(d2.cpu(), k))


def test_train_step_card_equals_cpu(card):
    """One detector step (width 16, 64², batch 4) and one FaceNet step (2
    identities × 2 crops) from one initial state: the card's loss,
    gradients, batch statistics and Adam update against the CPU's, at
    the tolerances and dtypes of ``chip_smoke.py``'s ``train`` phase."""
    import chip_smoke as cs

    cases = cs.train_cases(size=64, batch=4, n_ids=2, per_id=2, width=16)
    for name, (make, batch) in cases.items():
        row, failed = cs.step_parity_row(name, make, batch, card)
        assert not failed, (failed, row)


@pytest.mark.parametrize("b,h,w", [(4, 144, 192), (2, 576, 768)])
def test_delta_i420_to_rgb_card_equals_cpu(card, b, h, w):
    """The wire decode is the same float64 code on both devices: bit
    for bit, wraparound deltas included."""
    from facerec_torch.ops import yuv

    rng = np.random.default_rng(h)
    wire = torch.from_numpy(rng.integers(0, 256, (b, yuv.i420_rows(h), w),
                                         dtype=np.uint8))
    got = yuv.delta_i420_to_rgb(wire.to(card), h).cpu()
    assert torch.equal(got, yuv.delta_i420_to_rgb(wire, h))
    assert torch.equal(yuv.delta_decode(wire.to(card)).cpu(),
                       yuv.delta_decode(wire))


def test_grouped_rgb_delta_extract_card_equals_cpu(card, tmp_path):
    """rgb-delta with fetch groups of 3 and checkpoints: the card's
    trajectories, scene changes and features are the CPU's (features
    within 1e-5), the scene kernels ran once per block, and the native
    writer wrote every feature line on the card."""
    import json
    import os

    from facerec_torch.config import ExtractConfig
    from facerec_torch.pipeline.extract import run_extract
    from facerec_torch.tools.soak import StubBank
    from facerec_torch.video.synth import ScriptedDetector

    clip = make_frames(70, width=192, height=144, seed=3, cuts=(30,),
                       path="125261-Card.mp4")
    cfg = ExtractConfig(block_frames=16, save_images=False, resume=False,
                        wire_format="rgb-delta", fetch_every_blocks=3,
                        checkpoint_every_blocks=3)
    outs = {}
    for dev in (card, torch.device("cpu")):
        before = dict(eqm.launches)
        run_extract(clip, cfg, str(tmp_path / dev.type),
                    detector=ScriptedDetector(clip),
                    embedders=StubBank(device=dev), device=dev)
        if dev.type == "cuda":
            assert eqm.launches["hist256_rgb"] == before["hist256_rgb"] + 5
            assert eqm.launches["cum_lookup"] == before["cum_lookup"] + 5
        outs[dev.type] = os.path.join(str(tmp_path / dev.type),
                                      "125261-data")
    for sub in ("trajectories", "scene_changes"):
        for name in os.listdir(os.path.join(outs["cpu"], sub)):
            a, b = (open(os.path.join(outs[k], sub, name), "rb").read()
                    for k in ("cuda", "cpu"))
            assert a == b, (sub, name)
    (name,) = os.listdir(os.path.join(outs["cpu"], "features"))
    recs = [[json.loads(l) for l in open(os.path.join(outs[k], "features",
                                                      name))]
            for k in ("cuda", "cpu")]
    assert recs[1] and len(recs[0]) == len(recs[1])
    for a, b in zip(*recs):
        ea, eb = a.pop("embeddings"), b.pop("embeddings")
        assert a == b
        for k in ea:
            np.testing.assert_allclose(ea[k], eb[k], rtol=0, atol=1e-5)
    with open(os.path.join(outs["cuda"], "run_report.json")) as f:
        c = json.load(f)["extract_0-70"]["counters"]
    assert c["feature_records_native"] == c["feature_records"] == len(recs[0])
    assert c["feature_bytes"] == os.path.getsize(
        os.path.join(outs["cuda"], "features", name))
    # every block on the card went through the pinned ring
    assert c["upload_pinned_blocks"] == c["blocks"] == 5


def test_block_upload_overlaps_queued_kernels(card):
    """The pinned ring's uploads return while the compute stream still
    sleeps (the copies wait on nothing of it), no slot is refilled
    before its copy has ended (each block is its own byte, a shorter
    last one included), and a reduction queued on the compute stream
    right after each upload reads the uploaded bytes."""
    import time

    from facerec_torch.pipeline.extract import UPLOAD_RING, _BlockUpload

    shape = (16, 540, 960, 3)
    blocks = [np.full(shape, 11 * k + 1, np.uint8) for k in range(6)]
    blocks.append(np.full((5,) + shape[1:], 250, np.uint8))
    up = _BlockUpload(card)
    compute = torch.cuda.current_stream(card)

    def upload_all():
        devs, sums = [], []
        for b in blocks:
            devs.append(up(b))
            sums.append(devs[-1].sum(dtype=torch.int64))
        return devs, sums

    def check(devs, sums):
        torch.cuda.synchronize(card)
        for b, d, s in zip(blocks, devs, sums):
            assert d.shape == b.shape
            assert torch.equal(d.cpu(), torch.from_numpy(b))
            assert int(s) == int(b.sum(dtype=np.int64))

    check(*upload_all())       # pins the slots, starts the copy stream
    assert len(up.slots) == UPLOAD_RING
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(compute)
    torch.cuda._sleep(400_000_000)     # ~0.2 s at the H100's clocks
    t0 = time.perf_counter()
    devs, sums = upload_all()
    host_ms = 1e3 * (time.perf_counter() - t0)
    end.record(compute)
    check(devs, sums)
    sleep_ms = start.elapsed_time(end)
    assert sleep_ms > 100, sleep_ms
    assert host_ms < sleep_ms / 4, (host_ms, sleep_ms)


@pytest.mark.parametrize("stream,max_tracks,d", [
    ("crossing", 32, 16),          # collisions and ties: the JV solve
    ("simulate", 3, 8),            # D > T: overflow, every frame solves
    ("simulate", 16, 8),           # the fast path, scene cuts
    ("crowd48", 64, 48),           # more than 32 slots followed at once
    ("crowd48", 40, 48),           # D > T: the JV solve on K = 48
    ("crowd120", 128, 128)])       # the kernel's limit, 1,024 threads
def test_tracker_kernel_equals_plain(card, stream, max_tracks, d):
    """tracker_scan launches once per block and equals run_block_plain
    on the card: integer emissions and state exact, and boxes and the
    Kalman state bit for bit (both round every float operation alike)."""
    from facerec_torch.track import TrackerConfig, init_tracker
    from facerec_torch.track import streams
    from facerec_torch.track import tracker as trk

    rng = np.random.default_rng(0)
    if stream == "crossing":
        det_stream, cuts = streams.crossing_stream(rng)
    elif stream == "simulate":
        det_stream, cuts = streams.simulate_stream(rng, n_frames=60,
                                                   p_cut=0.05)
    else:
        det_stream, cuts = streams.crowd_stream(rng, **streams.CROWDS[stream])
    bx, valid = streams.stream_arrays(det_stream, d)
    cfg = TrackerConfig(max_tracks=max_tracks, max_detections=d)
    state, plain = init_tracker(cfg, card), init_tracker(cfg, card)
    for f0 in range(0, len(det_stream), 40):
        args = [torch.from_numpy(np.ascontiguousarray(a[f0:f0 + 40])).to(card)
                for a in (bx, valid, cuts)]
        before = trk.launches["tracker"]
        state, emit = trk.run_block(cfg, state, *args, f0)
        assert trk.launches["tracker"] == before + 1
        plain, want = trk.run_block_plain(cfg, plain, *args, f0)
        for k in ("emit", "detected", "uid", "first_frame", "det_slot",
                  "overflow"):
            assert torch.equal(getattr(emit, k), getattr(want, k)), k
        for k in ("active", "uid", "first_frame", "hist_len", "tsu", "hits",
                  "initial_hits", "next_uid"):
            assert torch.equal(getattr(state, k), getattr(plain, k)), k
        for a, b in ((emit.box, want.box), (state.kf.x, plain.kf.x),
                     (state.kf.p, plain.kf.p)):
            assert torch.equal(a, b)


def test_device_step_replay_equals_eager(card):
    """A small make_device_step captured as one CUDA graph: a replay
    equals an eager step on the same inputs and launches each kernel
    once."""
    from facerec_torch.benchdev import make_device_step
    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.pipeline.extract import EmbedderBank

    bank = EmbedderBank({"a": FaceNetEmbedder("a", 128, card,
                                              dtype=torch.bfloat16)})
    step, args = make_device_step((64, 96), 8, 96, 128, 4, bank=bank,
                                  device=card)
    want = step.eager(*args)
    got = step(*args)
    assert step.replays == 1
    assert step.captured_launches == {"hist256": 0, "hist256_rgb": 1,
                                      "cum_lookup": 1, "tracker": 1,
                                      "align_warp": 0}
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    assert torch.equal(got[2].uid, want[2].uid)


@pytest.mark.parametrize("n,b,h,w", [(64, 8, 576, 768), (7, 3, 41, 130)])
def test_align_warp_equals_plain(card, n, b, h, w):
    """The alignment kernel against its plain version on the CPU, bit for
    bit (the kernel is built without fused multiply-adds): faces of 10 to
    60 px across the frame and off its edges, turned and jittered, and a
    degenerate set."""
    from facerec_torch.ops import align

    rng = np.random.default_rng(n)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                           dtype=np.uint8))
    th = rng.uniform(-0.6, 0.6, n)
    rot = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)],
                   1).reshape(n, 2, 2)
    tpl = np.asarray(align.TEMPLATE) - 56.0
    ldm = np.float32(np.einsum("pj,nij->npi", tpl, rot)
                     * rng.uniform(0.15, 0.6, (n, 1, 1))
                     + rng.uniform([-10, -10], [w + 10, h + 10], (n, 1, 2))
                     + rng.normal(0, 1.5, (n, 5, 2)))
    ldm[0] = ldm[0, :1]                           # no spread
    idx = torch.from_numpy(rng.integers(0, b, n))
    before = align.launches["align_warp"]
    got = align.align_warp(frames.to(card), idx.to(card),
                           torch.from_numpy(ldm).to(card))
    torch.cuda.synchronize()
    assert align.launches["align_warp"] == before + 1
    want = align.align_plain(frames, idx, torch.from_numpy(ldm))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [192, 130])
@pytest.mark.parametrize("family", ["facenet", "arcface"])
def test_bank_replays_full_chunks_as_eager(card, family, n):
    """The seeded FaceNet bank and the seeded ArcFace bank: every full
    chunk of 64 crops replays the bank's one captured CUDA graph, equal
    to the eager chunk bit for bit, and a shorter chunk runs eagerly;
    the second of two dispatches leaves the first's result as it was
    (the graph's output is copied out before the next replay)."""
    from facerec_torch.config import ARCFACE_NAME
    from facerec_torch.models.iresnet import ArcFaceEmbedder
    from facerec_torch.pipeline.extract import EMBED_BATCH, EmbedderBank
    from facerec_torch.runtime.metrics import Spans

    g = torch.Generator(card).manual_seed(n)
    if family == "facenet":
        bank = EmbedderBank.create_default(card)
        shape, scale, shift = (n, 160, 160, 3), 255.0, 0.0
    else:
        bank = EmbedderBank({ARCFACE_NAME: ArcFaceEmbedder(
            ARCFACE_NAME, card, seed=1)})
        shape, scale, shift = (n, 3, 112, 112), 2.0, -1.0
    batches = [torch.rand(shape, generator=g, device=card) * scale + shift
               for _ in range(2)]
    with torch.inference_mode():
        want = [torch.cat([bank._embed_chunk(c)
                           for c in x.split(EMBED_BATCH)])
                for x in batches]
    spans = [Spans("t", (), bank.counter_names) for _ in batches]
    got = [bank.dispatch_packed(x, sp) for x, sp in zip(batches, spans)]
    torch.cuda.synchronize()
    assert bank.captures == 1
    full, tail = divmod(n, EMBED_BATCH)
    for buf, ref, sp in zip(got, want, spans):
        emb = buf.view(torch.float32).reshape(n, bank.total_dim)
        gap = float((emb - ref).abs().max())
        assert torch.equal(emb, ref), gap
        assert sp.counters["embed_graph_replays"] == full
        assert sp.counters["embed_eager_chunks"] == (tail > 0)


def test_bank_graph_follows_the_launch_settings(card):
    """A graph keeps the kernels of its capture: a chunk under other TF32
    settings is captured anew and equals the eager chunk under those
    settings, which differ from the float32 ones."""
    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.pipeline.extract import EMBED_BATCH, EmbedderBank

    bank = EmbedderBank({"a": FaceNetEmbedder("a", 128, card, seed=2)})
    g = torch.Generator(card).manual_seed(3)
    crops = torch.rand((EMBED_BATCH, 160, 160, 3), generator=g,
                       device=card) * 255
    got = {}
    for tf32 in (True, False, True):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            emb = bank.dispatch_packed(crops).view(torch.float32)
            want = bank._embed_chunk(crops).reshape(-1)
        assert torch.equal(emb, want), tf32
        got[tf32] = emb
    assert bank.captures == 3
    assert not torch.equal(got[True], got[False])


def test_replayed_kernels_fall_under_the_callers_range(card):
    """In a profile the graph's kernels belong to the bank's
    ``embed_replay`` span, inside a user range around the dispatch: the
    range's device time holds all the device work of the dispatch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from facerec_torch.models.facenet import FaceNetEmbedder
    from facerec_torch.pipeline.extract import EMBED_BATCH, EmbedderBank
    from facerec_torch.runtime.metrics import Spans

    bank = EmbedderBank({"a": FaceNetEmbedder("a", 128, card, seed=2)})
    g = torch.Generator(card).manual_seed(4)
    crops = torch.rand((2 * EMBED_BATCH, 160, 160, 3), generator=g,
                       device=card) * 255
    sp = Spans("t", bank.span_names, bank.counter_names)
    bank.dispatch_packed(crops, sp)          # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("caller"):
            bank.dispatch_packed(crops, sp)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == cuda and e.name != "caller")
    caller = [e for e in prof.events()
              if e.name == "caller" and e.device_type != cuda]
    assert sp.counters["embed_graph_replays"] == 4 and device_us > 0
    assert len(caller) == 1
    assert caller[0].device_time_total >= 0.99 * device_us, (
        caller[0].device_time_total, device_us)
