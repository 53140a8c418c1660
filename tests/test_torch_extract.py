"""The port's extract stage against the JAX package's, end to end.

Both packages run the same synthetic mp4 with scripted detections (the
ground truth) and the same stub embedding projection (pooled crop
pixels, as ``tests/test_extract_e2e.py:StubEmbedderBank``), on the CPU.
The port's stub, :class:`StubBank`, is the one the port's other tests
hold against the JAX package; the mesh tests' worker processes unpickle
it by import path, so this module imports JAX only inside its
functions.
Trajectories, scene changes and JPEG images must be byte-identical;
feature records too, except the embedding floats: the port's
``crop_resize`` sums its two products in another order than XLA, so
crop pixels differ by float32 rounding and the unit embeddings agree
within 1e-5.
"""
import json
import os

import numpy as np
import pytest
import torch

from facerec_torch.config import ExtractConfig
from facerec_torch.pipeline.extract import run_extract
from facerec_torch.tools import soak
from facerec_torch.video.synth import ScriptedDetector, make_frames

EMB_ATOL = 1e-5
MOVIE = "125261"


class StubBank(soak.StubBank):
    """The JAX tests' stub projection (``StubEmbedderBank`` and
    ``DeferredStubBank`` of ``tests/test_extract_e2e.py``: ``m1`` and
    ``m2`` × 16, drawn from ``default_rng(seed)``, unscaled) on the
    port's crops, through the soak stub's chunk forward and the bank's
    own dispatch, fetch and unpack."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.names, self.dims = ["m1", "m2"], [16, 16]
        self.total_dim = 32
        self.proj = torch.from_numpy(np.concatenate(
            [rng.normal(size=(75, 16)) for _ in self.names],
            axis=1).astype(np.float32))


class CrashingDetector(ScriptedDetector):
    def __init__(self, clip, crash_at_frame, **kw):
        super().__init__(clip, **kw)
        self.crash_at_frame = crash_at_frame

    def __call__(self, frames):
        if self._frame0 >= self.crash_at_frame:
            raise RuntimeError("injected crash")
        return super().__call__(frames)


KW = dict(block_frames=16, max_detections=8, max_tracks=16)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from facerec_tpu.video.synth import make_clip as jax_make_clip

    path = str(tmp_path_factory.mktemp("clips") / f"{MOVIE}-TestFilm-1955.mp4")
    return jax_make_clip(path, n_frames=60, cuts=(30,), seed=3)


def run_jax(clip, out, n_shards, save_images=True):
    from facerec_tpu.config import ExtractConfig as JaxExtractConfig
    from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
    from facerec_tpu.video.synth import ScriptedDetector as JaxScriptedDetector
    from tests.test_extract_e2e import StubEmbedderBank as JaxStubBank

    for i in range(n_shards):
        jax_run_extract(
            clip.path, JaxExtractConfig(n_shards=n_shards, shard_i=i,
                                        save_images=save_images, **KW),
            out, detector=JaxScriptedDetector(clip, max_detections=8),
            embedders=JaxStubBank())


def run_port(clip, out, n_shards, save_images=True, **kw):
    for i in range(n_shards):
        run_extract(
            clip.path, ExtractConfig(n_shards=n_shards, shard_i=i,
                                     save_images=save_images, **KW, **kw),
            out, detector=ScriptedDetector(clip, max_detections=8),
            embedders=StubBank(), device="cpu")


def read_dir(root, sub):
    d = os.path.join(root, f"{MOVIE}-data", sub)
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def assert_same_outputs(want_root, got_root, images=True):
    for sub in ("trajectories", "scene_changes"):
        assert read_dir(got_root, sub) == read_dir(want_root, sub), sub
    if images:
        want_img, got_img = (read_dir(want_root, "images"),
                             read_dir(got_root, "images"))
        assert want_img and got_img == want_img
    want_f, got_f = (read_dir(want_root, "features"),
                     read_dir(got_root, "features"))
    assert sorted(got_f) == sorted(want_f)
    n_records = 0
    for name in want_f:
        want_l = want_f[name].decode().splitlines()
        got_l = got_f[name].decode().splitlines()
        assert len(got_l) == len(want_l)
        for w, g in zip(want_l, got_l):
            w, g = json.loads(w), json.loads(g)
            w_emb, g_emb = w.pop("embeddings"), g.pop("embeddings")
            assert g == w
            assert list(g_emb) == list(w_emb)
            for k in w_emb:
                np.testing.assert_allclose(g_emb[k], w_emb[k], rtol=0,
                                           atol=EMB_ATOL)
            n_records += 1
    assert n_records > 0


@pytest.mark.parametrize("n_shards", [1, 2])
def test_port_matches_jax(clip, tmp_path, n_shards):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax(clip, want, n_shards)
    run_port(clip, got, n_shards)
    assert_same_outputs(want, got)
    sc = json.loads(read_dir(got, "scene_changes")[
        f"scene_changes_{MOVIE}_0-{60 // n_shards}.json"])
    assert sc["frame_indices"] == [30]


def test_crash_resume_matches_uninterrupted_and_jax(clip, tmp_path):
    want = str(tmp_path / "jax")
    run_jax(clip, want, 1, save_images=False)
    crashed = str(tmp_path / "crashed")
    # one block per fetch: a checkpoint lands before the crash at block
    # 3 (the grouped case is tests/test_torch_wire.py's)
    cfg = ExtractConfig(save_images=False, checkpoint_every_blocks=2,
                        fetch_every_blocks=1, **KW)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_extract(clip.path, cfg, crashed,
                    detector=CrashingDetector(clip, 48, max_detections=8),
                    embedders=StubBank(), device="cpu")
    assert any(f.endswith(".ckpt")
               for f in os.listdir(f"{crashed}/{MOVIE}-data"))
    run_extract(clip.path, cfg, crashed,
                detector=ScriptedDetector(clip, max_detections=8),
                embedders=StubBank(), device="cpu")
    clean = str(tmp_path / "clean")
    run_port(clip, clean, 1, save_images=False)
    assert read_dir(crashed, "features") == read_dir(clean, "features")
    assert_same_outputs(want, crashed, images=False)


def test_synth_paints_the_jax_clip(clip, tmp_path):
    """The port's numpy painter draws the clip the JAX package writes:
    the same truth, and an mp4 that decodes to the same frames."""
    import cv2

    from facerec_torch.video.synth import make_clip

    mine = make_clip(str(tmp_path / f"{MOVIE}-Port.mp4"), n_frames=60,
                     cuts=(30,), seed=3)
    assert mine.scene_cuts == clip.scene_cuts
    assert sorted(mine.truth) == sorted(clip.truth)
    for f in clip.truth:
        for (wb, wl), (gb, gl) in zip(clip.truth[f], mine.truth[f]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gl, wl)
    caps = [cv2.VideoCapture(p) for p in (clip.path, mine.path)]
    n = 0
    while True:
        (ok_a, a), (ok_b, b) = (c.read() for c in caps)
        assert ok_a == ok_b
        if not ok_a:
            break
        np.testing.assert_array_equal(a, b)
        n += 1
    for c in caps:
        c.release()
    assert n == 60


def test_in_memory_clip_runs_through_extract(tmp_path):
    mem = make_frames(40, cuts=(20,), seed=5,
                      path=f"{MOVIE}-TestFilm-1955.mp4")
    counters = run_extract(
        mem, ExtractConfig(save_images=False, **KW), str(tmp_path),
        detector=ScriptedDetector(mem, max_detections=8),
        embedders=StubBank(), device="cpu")
    assert counters.frames_processed == 40
    assert counters.saved_trajectories >= 2
    sc = json.loads(read_dir(str(tmp_path), "scene_changes")[
        f"scene_changes_{MOVIE}_0-40.json"])
    assert sc["frame_indices"] == [20]


def test_run_extract_refuses_an_unported_wire_format(clip, tmp_path):
    """Every wire format of the JAX package is ported; any other name
    raises before the film is opened."""
    with pytest.raises(ValueError, match="unknown wire_format"):
        run_extract(clip.path, ExtractConfig(wire_format="yuv444-delta"),
                    str(tmp_path), device="cpu")


def test_run_extract_needs_a_device_choice_without_a_card(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_extract(clip.path, ExtractConfig(), str(tmp_path))


def test_crop_resize_matches_jax():
    """Two float32 products in another summation order than XLA's:
    pixels agree within 1e-3 on the 0..255 scale."""
    import jax.numpy as jnp

    from facerec_tpu.ops.crops import crop_resize as jax_crop_resize
    from facerec_torch.ops.crops import crop_resize

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (3, 72, 96, 3)).astype(np.uint8)
    idx = np.array([0, 2, 1, 2], np.int32)
    boxes = np.array([[0, 0, 96, 72], [10.5, 3.2, 40.7, 50.1],
                      [-4, -4, 20, 20], [60, 30, 95.9, 71.9]], np.float32)
    want = np.asarray(jax_crop_resize(jnp.asarray(frames), jnp.asarray(idx),
                                      jnp.asarray(boxes), 40))
    got = crop_resize(torch.from_numpy(frames), torch.from_numpy(idx),
                      torch.from_numpy(boxes), 40).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("wire", ["rgb", "yuv420-delta"])
def test_phase_log_prints_the_jax_phase_lines(tmp_path, monkeypatch, capsys,
                                              wire):
    """FACEREC_PHASE_LOG=1: the JAX package's per-block [phase] lines
    on stderr, one decode_wait per block plus the end-of-stream wait."""
    mem = make_frames(40, cuts=(20,), seed=5,
                      path=f"{MOVIE}-TestFilm-1955.mp4")
    monkeypatch.setenv("FACEREC_PHASE_LOG", "1")
    run_extract(mem, ExtractConfig(save_images=False, fetch_every_blocks=2,
                                   wire_format=wire, **KW), str(tmp_path),
                detector=ScriptedDetector(mem, max_detections=8),
                embedders=StubBank(), device="cpu")
    lines = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith("[phase] ")]
    kinds = [line.split()[1] for line in lines]
    assert kinds.count("decode_wait") == 3 + 1        # 40 frames, 16/block
    assert kinds.count("block") == 3
    block = [line for line in lines if line.split()[1] == "block"]
    if wire == "rgb":
        assert all(" upload " in line and "f0=" in line for line in block)
    else:
        assert all("encode=" in line and "enqueue=" in line
                   for line in block)
    assert kinds.count("start_fetch") >= 2
    assert kinds.count("collect_fetch") == kinds.count("start_fetch")
    assert all("compute_wait=" in line and "transfer=" in line
               for line in lines if line.split()[1] == "collect_fetch")
