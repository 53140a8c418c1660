"""The port's wire formats and grouped fetches against the JAX package's
extract, on the ``tests/test_extract_e2e.py`` clip with scripted
detections and a deferred stub bank, on the CPU.

* ``rgb-delta`` files are byte-identical to the port's ``rgb`` files
  (images included); against JAX's ``rgb``, trajectories, scene changes
  and images byte-identical, features within 1e-5 (the stub-embedding
  tolerance of ``test_torch_extract.py``: the crops' summation order).
* ``yuv420-delta`` trajectories and scene changes byte-identical to
  JAX's ``yuv420-delta``, features within 1e-5, and with images on the
  JPEG files and bytes equal (the JAX side needs its pure scripted
  detector, since its wire runs only in the fused step).
* Files identical across fetch groups 1, 3 and 64, and after a grouped
  crash and resume; crop+embed dispatches ≤ ⌈blocks/group⌉ + 1.
"""
import json
import os

import numpy as np
import pytest
import torch

from facerec_tpu.config import ExtractConfig as JaxExtractConfig
from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
from facerec_tpu.video.synth import PureScriptedDetector
from facerec_tpu.video.synth import ScriptedDetector as JaxScriptedDetector
from facerec_tpu.video.synth import make_clip as jax_make_clip
from tests.test_extract_e2e import DeferredStubBank as JaxDeferredBank
from tests.test_torch_extract import (CrashingDetector, assert_same_outputs,
                                      read_dir)

from facerec_torch.config import ExtractConfig
from facerec_torch.pipeline import extract as ex
from facerec_torch.tools.soak import StubBank
from facerec_torch.video.synth import ScriptedDetector

MOVIE = "125261"
KW = dict(max_detections=8, max_tracks=16)


class DeferredStubBank(StubBank):
    """The JAX tests' DeferredStubBank (``m1``, ``m2`` × 16, unscaled
    projections), deferred in torch as the soak's stub."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.names, self.dims = ["m1", "m2"], [16, 16]
        self.total_dim = 32
        self.supports_deferred = True
        self.proj = torch.from_numpy(np.concatenate(
            [rng.normal(size=(75, 16)) for _ in self.names],
            axis=1).astype(np.float32))


def deferred_bank():
    return DeferredStubBank()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / f"{MOVIE}-TestFilm-1955.mp4")
    return jax_make_clip(path, n_frames=60, cuts=(30,), seed=3)


def run_port(clip, out, wire="rgb", group=3, block_frames=16, images=False,
             bank=None, detector=None, **kw):
    cfg = ExtractConfig(block_frames=block_frames, save_images=images,
                        fetch_every_blocks=group, wire_format=wire, **KW,
                        **kw)
    return ex.run_extract(
        clip.path, cfg, out,
        detector=detector or ScriptedDetector(clip, max_detections=8),
        embedders=bank or deferred_bank(), device="cpu")


def run_jax(clip, out, wire="rgb", group=3, images=False, pure=False):
    cfg = JaxExtractConfig(block_frames=16, save_images=images,
                           fetch_every_blocks=group, wire_format=wire, **KW)
    det = (PureScriptedDetector if pure else JaxScriptedDetector)(
        clip, max_detections=8)
    jax_run_extract(clip.path, cfg, out, detector=det,
                    embedders=JaxDeferredBank())


def assert_identical(a, b, subs=("trajectories", "scene_changes",
                                 "features")):
    for sub in subs:
        want = read_dir(a, sub)
        assert want and read_dir(b, sub) == want, sub


def report(root):
    with open(os.path.join(root, f"{MOVIE}-data", "run_report.json")) as f:
        return json.load(f)[f"extract_0-60"]["counters"]


def test_rgb_delta_byte_identical_to_rgb_and_to_jax(clip, tmp_path):
    roots = {k: str(tmp_path / k) for k in ("rgb", "delta", "jax")}
    run_port(clip, roots["rgb"], "rgb", images=True)
    run_port(clip, roots["delta"], "rgb-delta", images=True)
    run_jax(clip, roots["jax"], "rgb", images=True)
    assert_identical(roots["rgb"], roots["delta"],
                     ("trajectories", "scene_changes", "features", "images"))
    assert_same_outputs(roots["jax"], roots["delta"])
    rep = report(roots["delta"])
    assert rep["wire_format"] == "rgb-delta"
    assert rep["encode_path"] in ("native", "numpy")
    assert report(roots["rgb"])["encode_path"] is None


def test_yuv420_delta_matches_jax_yuv420_delta(clip, tmp_path):
    """Images on: the host window holds I420 planes, faces convert with
    the numpy copy of OpenCV's conversion, JPEGs equal JAX's."""
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax(clip, want, "yuv420-delta", images=True, pure=True)
    run_port(clip, got, "yuv420-delta", images=True)
    assert_same_outputs(want, got)
    assert report(got)["wire_format"] == "yuv420-delta"
    sc = json.loads(read_dir(got, "scene_changes")[
        f"scene_changes_{MOVIE}_0-60.json"])
    assert sc["frame_indices"] == [30]


def test_yuv420_delta_group_invariant_and_covers_rgb_faces(clip, tmp_path):
    """Port only: yuv files identical at groups 1 and 4; against the rgb
    wire, trajectories and cuts identical and features at the same
    (frame, box) pairs."""
    roots = {k: str(tmp_path / k) for k in ("rgb", "yuv1", "yuv4")}
    run_port(clip, roots["rgb"], "rgb")
    run_port(clip, roots["yuv1"], "yuv420-delta", group=1)
    run_port(clip, roots["yuv4"], "yuv420-delta", group=4)
    assert_identical(roots["yuv1"], roots["yuv4"])
    assert_identical(roots["rgb"], roots["yuv1"],
                     ("trajectories", "scene_changes"))
    pairs = []
    for r in (roots["rgb"], roots["yuv1"]):
        (name, data), = read_dir(r, "features").items()
        pairs.append([(rec["frame"], rec["box"]) for rec in map(
            json.loads, data.decode().splitlines())])
    assert pairs[0] and pairs[0] == pairs[1]


def test_yuv420_delta_falls_back_to_rgb_on_odd_sizes(tmp_path, capsys):
    from facerec_torch.video.synth import make_frames

    mem = make_frames(20, width=97, height=72, seed=1,
                      path=f"{MOVIE}-Odd.mp4")
    ex.run_extract(mem, ExtractConfig(block_frames=8, save_images=False,
                                      wire_format="yuv420-delta", **KW),
                   str(tmp_path), detector=ScriptedDetector(mem),
                   embedders=deferred_bank(), device="cpu")
    assert "falling back to rgb" in capsys.readouterr().err
    with open(tmp_path / f"{MOVIE}-data" / "run_report.json") as f:
        assert json.load(f)["extract_0-20"]["counters"][
            "wire_format"] == "rgb"


@pytest.mark.parametrize("wire", ["rgb", "rgb-delta"])
def test_fetch_grouping_invariance(clip, tmp_path, wire):
    outs = {}
    for g in (1, 3, 64):
        outs[g] = str(tmp_path / f"g{g}")
        run_port(clip, outs[g], wire, group=g)
        assert report(outs[g])["fetch_group"] == min(g, 4)   # 4 blocks
    assert_identical(outs[1], outs[3])
    assert_identical(outs[1], outs[64])


@pytest.mark.parametrize("wire", ["rgb", "yuv420-delta"])
def test_grouped_crash_resume_byte_identical(clip, tmp_path, wire):
    """A crash two groups in resumes from the checkpoint of the last
    consumed block (not the loop's state, a group ahead) to the clean
    run's bytes."""
    kw = dict(block_frames=8, group=4)
    clean = str(tmp_path / "clean")
    run_port(clip, clean, wire, **kw)
    crashed = str(tmp_path / "crashed")
    with pytest.raises(RuntimeError, match="injected crash"):
        run_port(clip, crashed, wire, checkpoint_every_blocks=2,
                 detector=CrashingDetector(clip, 40, max_detections=8), **kw)
    assert any(f.endswith(".ckpt")
               for f in os.listdir(f"{crashed}/{MOVIE}-data"))
    run_port(clip, crashed, wire, checkpoint_every_blocks=2, **kw)
    assert_identical(clean, crashed)


def test_one_crop_embed_dispatch_per_fetch_group(clip, tmp_path):
    class CountingBank(DeferredStubBank):
        def __init__(self):
            super().__init__()
            self.crop_embed_calls = self.packed_calls = 0

        def dispatch_crop_embed(self, stack, frame_idx, crop_boxes):
            self.crop_embed_calls += 1
            return super().dispatch_crop_embed(stack, frame_idx, crop_boxes)

        def dispatch_packed(self, crops):
            self.packed_calls += 1
            return super().dispatch_packed(crops)

    bank, group = CountingBank(), 4
    run_port(clip, str(tmp_path / "out"), block_frames=8, group=group,
             bank=bank)
    n_blocks = -(-65 // 8)   # 60 frames + 5 overlap, blocks of 8
    max_groups = -(-n_blocks // group) + 1
    assert 0 < bank.crop_embed_calls <= max_groups
    assert bank.packed_calls == bank.crop_embed_calls


def test_transfer_pack_roundtrip():
    from facerec_torch.runtime.transfer import (pack_tree, tree_spec,
                                                unpack_tree)
    from facerec_torch.track import TrackEmit

    rng = np.random.default_rng(0)
    tree = (torch.from_numpy(rng.random(5) > 0.5),
            TrackEmit(*(torch.from_numpy(a) for a in (
                rng.random((3, 4)).astype(np.float32),
                rng.random(3) > 0.5, rng.random(3) > 0.5,
                rng.integers(0, 9, 3).astype(np.int32),
                rng.integers(0, 9, 3).astype(np.int32),
                rng.integers(-1, 3, 2).astype(np.int32),
                np.array(4, np.int32)))),
            torch.from_numpy(rng.random((2, 5, 2)).astype(np.float32)))
    buf = pack_tree(tree).numpy()
    back = unpack_tree(buf, *tree_spec(tree))
    assert isinstance(back[1], TrackEmit)
    flat = [back[0], *back[1], back[2]]
    for got, want in zip(flat, [tree[0], *tree[1], tree[2]]):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError):
        unpack_tree(buf[:-1], *tree_spec(tree))


@pytest.mark.parametrize("workers", [0, 2])
def test_i420_reader_blocks_equal_jax(clip, workers):
    """The port's reader in i420 (native decoder, sequential or with
    parallel workers after the seek probe) gives the JAX reader's bytes;
    an in-memory clip converts with OpenCV's integer conversion."""
    from facerec_torch.ops.yuv import rgb_to_i420
    from facerec_torch.video.reader import (MemoryReader, open_reader,
                                            source_info)
    from facerec_tpu.video.reader import open_block_reader, probe_video

    info = probe_video(clip.path)
    want = open_block_reader(clip.path, info, 16, decode_workers=workers,
                             pixel_format="i420")
    _, port_info = source_info(clip.path, None)
    got = open_reader(clip.path, port_info, 16, decode_workers=workers,
                      pixel_format="i420")
    pairs = list(zip(got.blocks(0, 60, 16), want.blocks(0, 60, 16)))
    got.close()
    want.close()
    assert len(pairs) == 4
    for (fa, a), (fb, b) in pairs:
        assert fa == fb and a.shape == (len(a), 216, 192)
        np.testing.assert_array_equal(a, b)
    frames = np.random.default_rng(0).integers(
        0, 256, (5, 8, 12, 3)).astype(np.uint8)
    (f0, block), = MemoryReader(frames, "i420").blocks(0, 5, 8)
    np.testing.assert_array_equal(block, rgb_to_i420(frames))
    with pytest.raises(ValueError, match="even"):
        MemoryReader(frames[:, :7], "i420")
