"""The port's multi-device extract against the serial loops.

``run_extract_mesh`` runs n spans of a film at once, one process per
device (here n CPU processes).  Its shard files must be byte-identical
to the port's own serial ``--n-shards n`` loop, and to the JAX
package's serial loop up to the embedding floats (the port's crop
sums its products in another order: ``tests/test_torch_extract.py``),
on the rgb and yuv420-delta wires; merged, they equal the serial merge
byte for byte and an unsharded run in content.  This mirrors
``tests/test_parallel_mesh.py``.

The worker processes unpickle the stubs below by import path, so this
module imports nothing of JAX at its top.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from facerec_torch.config import ExtractConfig, MergeConfig
from facerec_torch.parallel.extract_mesh import plan_spans, run_extract_mesh
from facerec_torch.pipeline.extract import EmbedderBank, run_extract
from facerec_torch.pipeline.merge import run_merge
from facerec_torch.video.synth import ScriptedDetector, paint_frames

N = 4
MOVIE = "125261"
KW = dict(block_frames=16, max_detections=8, max_tracks=16)
CPUS = ["cpu"] * N


class StubBank(EmbedderBank):
    """The JAX tests' stub projection (pooled crop pixels), on the
    port's crops."""

    def __init__(self, names=("m1", "m2"), dim=16, seed=0):
        rng = np.random.default_rng(seed)
        self.proj = {n: rng.normal(size=(75, dim)).astype(np.float32)
                     for n in names}

    def __call__(self, crops):
        x = crops.cpu().numpy().astype(np.float32)
        n = x.shape[0]
        flat = x.reshape(n, 5, 32, 5, 32, 3).mean(axis=(2, 4)).reshape(
            n, -1) / 255.0
        out = {}
        for name, p in self.proj.items():
            e = flat @ p
            e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-9)
            out[name] = e
        return out


class CrashingDetector(ScriptedDetector):
    """Raises at one block start: inside the worker of the span that
    reaches it."""

    def __init__(self, clip, crash_at_frame, **kw):
        super().__init__(clip, **kw)
        self.crash_at_frame = crash_at_frame

    def __call__(self, frames):
        if self._frame0 == self.crash_at_frame:
            raise RuntimeError("injected crash")
        return super().__call__(frames)


def tree_bytes(root, sub):
    d = os.path.join(root, f"{MOVIE}-data", sub)
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def assert_identical(a, b, subs=("trajectories", "features",
                                 "scene_changes", "images")):
    for sub in subs:
        want, got = tree_bytes(a, sub), tree_bytes(b, sub)
        assert set(got) == set(want), (sub, set(got) ^ set(want))
        for name in want:
            assert got[name] == want[name], f"{sub}/{name} differs"


def port_serial(clip, out, **kw):
    for i in range(N):
        run_extract(clip.path, ExtractConfig(n_shards=N, shard_i=i, **KW,
                                             **kw), out,
                    detector=ScriptedDetector(clip, max_detections=8),
                    embedders=StubBank(), device="cpu")


def jax_serial(clip, out, **kw):
    from facerec_tpu.config import ExtractConfig as JaxExtractConfig
    from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
    from facerec_tpu.video.synth import PureScriptedDetector
    from tests.test_extract_e2e import StubEmbedderBank

    for i in range(N):
        jax_run_extract(
            clip.path, JaxExtractConfig(n_shards=N, shard_i=i, **KW, **kw),
            out, detector=PureScriptedDetector(clip, max_detections=8),
            embedders=StubEmbedderBank())


def port_mesh(clip, out, detector=None, **kw):
    return run_extract_mesh(
        clip.path, ExtractConfig(**KW, **kw), out, devices=CPUS,
        detector=detector or ScriptedDetector(clip, max_detections=8),
        embedders=StubBank())


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from facerec_tpu.video.synth import make_clip

    path = str(tmp_path_factory.mktemp("mesh") / f"{MOVIE}-MeshFilm.mp4")
    return make_clip(path, n_frames=70, cuts=(30,), seed=21)


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    """rgb: the JAX serial loop, the port's serial loop, the port's
    mesh."""
    tmp = tmp_path_factory.mktemp("runs")
    out = {k: str(tmp / k) for k in ("jax", "serial", "mesh")}
    jax_serial(clip, out["jax"])
    port_serial(clip, out["serial"])
    counters = port_mesh(clip, out["mesh"])
    return out, counters


def test_mesh_shard_files_equal_the_serial_loops(runs):
    from tests.test_torch_extract import assert_same_outputs

    out, counters = runs
    assert len(counters) == N
    assert sum(c.frames_processed for c in counters) >= 70
    assert_identical(out["serial"], out["mesh"])
    assert_same_outputs(out["jax"], out["mesh"])


def test_mesh_report(runs):
    out, counters = runs
    rep = json.load(open(os.path.join(out["mesh"], f"{MOVIE}-data",
                                      "run_report.json")))
    assert [k for k in rep if k.startswith("extract")] == [
        f"extract_mesh_{N}"]
    c = rep[f"extract_mesh_{N}"]["counters"]
    assert c["spans"] == N
    # spans of 18 frames + 5 overlap at 16-frame blocks: 2, 2, 2, 1
    assert c["steps"] == 7
    for field in ("saved_boxes", "saved_frames", "saved_trajectories",
                  "frames_processed", "overflow"):
        assert c[field] == sum(getattr(x, field) for x in counters), field
    for p in ("decode", "encode", "upload", "dispatch", "fetch", "consume",
              "flush_dispatch"):
        assert c[f"{p}_seconds"] >= 0, p
    assert c["dispatch_seconds"] > 0


def test_mesh_merge_matches_serial_and_unsharded(runs, clip, tmp_path):
    out, _ = runs
    cfg = MergeConfig(min_face_size=20)
    for k in ("serial", "mesh"):
        run_merge(os.path.join(out[k], f"{MOVIE}-data"), int(MOVIE), cfg)
    for name in ("trajectories.jsonl", "features.jsonl",
                 "scene_changes.json"):
        want, got = (open(os.path.join(out[k], f"{MOVIE}-data", name),
                          "rb").read() for k in ("serial", "mesh"))
        assert got == want, name

    one = str(tmp_path / "one")
    run_extract(clip.path, ExtractConfig(**KW), one,
                detector=ScriptedDetector(clip, max_detections=8),
                embedders=StubBank(), device="cpu")
    run_merge(os.path.join(one, f"{MOVIE}-data"), int(MOVIE), cfg)

    def trajs(root):
        recs = [json.loads(line) for line in open(
            os.path.join(root, f"{MOVIE}-data", "trajectories.jsonl"))]
        assert recs
        return sorted(recs, key=lambda t: (t["start"], t["len"]))

    got, want = trajs(out["mesh"]), trajs(one)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["start"], a["len"]) == (b["start"], b["len"])
        # Kalman re-initialisation at the stitched span boundaries moves
        # posterior boxes by a pixel or two (test_parallel_mesh.py)
        np.testing.assert_allclose(a["bbs"], b["bbs"], atol=2)
    sc = [json.load(open(os.path.join(r, f"{MOVIE}-data",
                                      "scene_changes.json")))
          for r in (out["mesh"], one)]
    assert sc[0] == sc[1] == {"frame_indices": [30],
                              "movie_id": int(MOVIE)}


def test_mesh_crash_resumes_to_identical_files(clip, tmp_path):
    """Span 1 (frames 18-36, read to 41) crashes in its worker at the
    block at 34, after a checkpoint at 26; the other spans finish.  The
    re-run resumes it to the serial loop's bytes."""
    kw = dict(block_frames=8, checkpoint_every_blocks=1,
              fetch_every_blocks=1, save_images=False)
    cfg = dataclasses.replace(ExtractConfig(**KW), **kw)
    out = str(tmp_path / "crashed")
    with pytest.raises(RuntimeError, match="injected crash"):
        run_extract_mesh(clip.path, cfg, out, devices=CPUS,
                         detector=CrashingDetector(clip, 34,
                                                   max_detections=8),
                         embedders=StubBank())
    files = os.listdir(os.path.join(out, f"{MOVIE}-data"))
    assert f".extract_{MOVIE}_18-36.ckpt" in files
    assert sorted(f for f in files if f.endswith(".done")) == [
        f".extract_{MOVIE}_{b}-{e}.done"
        for b, e in ((0, 18), (36, 54), (54, 70))]

    counters = run_extract_mesh(clip.path, cfg, out, devices=CPUS,
                                detector=ScriptedDetector(clip,
                                                          max_detections=8),
                                embedders=StubBank())
    assert len(counters) == 1            # only the crashed span re-ran
    clean = str(tmp_path / "clean")
    for i in range(N):
        run_extract(clip.path, dataclasses.replace(cfg, n_shards=N,
                                                   shard_i=i), clean,
                    detector=ScriptedDetector(clip, max_detections=8),
                    embedders=StubBank(), device="cpu")
    assert_identical(clean, out, subs=("trajectories", "features",
                                       "scene_changes"))
    files = os.listdir(os.path.join(out, f"{MOVIE}-data"))
    assert not any(f.endswith(".ckpt") for f in files)
    assert sum(f.endswith(".done") for f in files) == N
    # a third run finds every span done
    assert run_extract_mesh(clip.path, cfg, out, devices=CPUS,
                            detector=ScriptedDetector(clip,
                                                      max_detections=8),
                            embedders=StubBank()) == []


def test_mesh_more_devices_than_frames(tmp_path):
    """3 frames over 4 spans: the last span is empty and writes nothing,
    no shard name is inverted; the clip reaches the workers painted."""
    assert plan_spans(3, 4, 5) == [(0, 1, 3), (1, 2, 3), (2, 3, 3),
                                   (3, 3, 3)]
    tiny = paint_frames(3, seed=2, path="5-Tiny.mp4")
    counters = run_extract_mesh(
        tiny, ExtractConfig(save_images=False, **KW), str(tmp_path),
        devices=CPUS, detector=ScriptedDetector(tiny, max_detections=8),
        embedders=StubBank())
    assert len(counters) == 3
    assert sum(c.frames_processed for c in counters) >= 3
    names = os.listdir(os.path.join(tmp_path, "5-data", "trajectories"))
    assert len(names) == 3
    for name in names:
        beg, end = name.rsplit("_", 1)[1].split(".")[0].split("-")
        assert int(beg) < int(end), name


def test_mesh_refuses_pixel_arrays(tmp_path):
    from facerec_torch.video.synth import make_frames

    mem = make_frames(8, path=f"{MOVIE}-Mem.mp4")
    with pytest.raises(ValueError, match="paint_frames"):
        run_extract_mesh(mem, ExtractConfig(**KW), str(tmp_path),
                         devices=["cpu"] * 2,
                         detector=ScriptedDetector(mem), embedders=StubBank())


def test_mesh_yuv420_delta_wire(clip, tmp_path):
    """The delta-I420 wire on the mesh: the port's serial loop's bytes,
    and the JAX serial loop's up to the embedding floats."""
    from tests.test_torch_extract import assert_same_outputs

    out = {k: str(tmp_path / k) for k in ("jax", "serial", "mesh")}
    jax_serial(clip, out["jax"], wire_format="yuv420-delta")
    port_serial(clip, out["serial"], wire_format="yuv420-delta")
    assert len(port_mesh(clip, out["mesh"],
                         wire_format="yuv420-delta")) == N
    assert_identical(out["serial"], out["mesh"])
    assert_same_outputs(out["jax"], out["mesh"])


def test_extract_cli_runs_a_cpu_mesh(monkeypatch, tmp_path):
    """``--device cpu --mesh 2`` takes the mesh path on two CPU
    processes; ``--mesh 2`` on the card needs two cards."""
    import torch

    import facerec_torch.parallel.extract_mesh as em
    from facerec_torch.pipeline import extract

    seen = {}
    monkeypatch.setattr(em, "run_extract_mesh",
                        lambda *a, **kw: seen.update(kw))
    extract.main(["--device", "cpu", "--mesh", "2", "--out-path",
                  str(tmp_path), f"{MOVIE}-x.mp4"])
    assert [str(d) for d in seen["devices"]] == ["cpu", "cpu"]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="needs 2 devices"):
            extract.main(["--mesh", "2", f"{MOVIE}-x.mp4"])


def test_backend_and_device_rules():
    """nccl on distinct cards, gloo on the CPU; ranks sharing a card
    must ask for gloo; explicit device lists may repeat a device."""
    import torch

    from facerec_torch.parallel.mesh import choose_backend, mesh_devices

    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert choose_backend([cpu, cpu]) == "gloo"
    assert choose_backend([c0, c1]) == "nccl"
    assert choose_backend([c0, c0], "gloo") == "gloo"
    with pytest.raises(ValueError, match="backend='gloo'"):
        choose_backend([c0, c0])
    with pytest.raises(ValueError, match="backend='gloo'"):
        choose_backend([c0, c0], "nccl")
    assert mesh_devices(3, "cpu") == [cpu] * 3
    assert mesh_devices(devices=["cpu", "cpu"]) == [cpu, cpu]
    with pytest.raises(ValueError, match="3 devices given"):
        mesh_devices(2, devices=["cpu"] * 3)
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="needs 1 devices; found 0"):
            mesh_devices(1, "cuda")
