"""The port's orchestrated pipeline and actor DB against the JAX
package's, on the CPU, and the probe-quality replay in the port.

* ``build_stages`` + ``run_pipeline`` (extract → merge → cluster →
  classify, ``device="cpu"``, scripted detections, the stub embedder)
  against the JAX package's four stages on the same clip and actor zip:
  ``trajectories.jsonl``, ``scene_changes.json``, ``clusters.json`` and
  ``predictions.json`` byte-identical, ``features.jsonl`` identical but
  for the embeddings (within 1e-5, as ``test_torch_extract.py``).
* ``prepare_one_actor`` with injected SPARQL, fetch and decode, a
  scripted detector and the stub embedder: the same zip members and
  JSON, embeddings within 1e-5.
* The replay of ``tests/test_probe_quality.py`` at its pinned budget
  through the port's extract, merge and ``score_detections``.
"""
import dataclasses
import json
import os
import shutil
import types
import zipfile

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_tpu.config import ClassifyConfig as JaxClassifyConfig
from facerec_tpu.config import ClusterConfig as JaxClusterConfig
from facerec_tpu.config import ExtractConfig as JaxExtractConfig
from facerec_tpu.config import MergeConfig as JaxMergeConfig
from facerec_tpu.pipeline import actors as jax_actors
from facerec_tpu.pipeline import classify as jax_classify
from facerec_tpu.pipeline.cluster import run_cluster as jax_run_cluster
from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
from facerec_tpu.pipeline.merge import run_merge as jax_run_merge
from facerec_tpu.tools.selfcheck import score_detections as jax_score
from facerec_tpu.video.synth import ScriptedDetector as JaxScriptedDetector
from facerec_tpu.video.synth import make_clip as jax_make_clip
from tests.test_extract_e2e import StubEmbedderBank as JaxStubBank
from tests.test_torch_classify import write_actor_zip
from tests.test_torch_extract import StubBank

from facerec_torch.config import (ClassifyConfig, ClusterConfig,
                                  ExtractConfig, MergeConfig, PipelineConfig)
from facerec_torch.models.detector import DetectorHarness
from facerec_torch.pipeline import actors, merge, orchestrate
from facerec_torch.pipeline.extract import run_extract
from facerec_torch.tools.selfcheck import score_detections
from facerec_torch.video.synth import (ScriptedDetector, make_clip, make_frames,
                                       paint_frames)

EMB_ATOL = 1e-5
MOVIE = 125261
KW = dict(block_frames=16, max_detections=8, max_tracks=16)
CLUSTER_KW = dict(size=2, min_size=1, max_size=4, emb_name="m1")
CLASSIFY_KW = dict(k=3, emb_name="m1", min_samples=3)
BYTE_IDENTICAL = ("trajectories.jsonl", "scene_changes.json",
                  "clusters.json", "predictions.json")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / f"{MOVIE}-TestFilm-1955.mp4")
    return jax_make_clip(path, n_frames=60, cuts=(30,), seed=3)


@pytest.fixture(scope="module")
def jax_run(clip, tmp_path_factory):
    """The JAX package's four stages; the actor zip is made from its
    merged features (the recipe of tests/test_extract_e2e.py)."""
    root = tmp_path_factory.mktemp("jax")
    jax_run_extract(clip.path, JaxExtractConfig(**KW), str(root),
                    detector=JaxScriptedDetector(clip, max_detections=8),
                    embedders=JaxStubBank())
    d = str(root / f"{MOVIE}-data")
    jax_run_merge(d, MOVIE, JaxMergeConfig(min_face_size=10))
    actors_dir = root / "actors"
    actors_dir.mkdir()
    write_actor_zip(actors_dir / "actor-images.zip",
                    os.path.join(d, "features.jsonl"), "m1")
    jax_run_cluster(d, JaxClusterConfig(**CLUSTER_KW))
    emb, _ = jax_classify.read_actor_embeddings(
        str(actors_dir / "actor-images.zip"), "m1")
    x, y = jax_classify.build_training_set(emb, CLASSIFY_KW["min_samples"])
    jax_classify.run_classify(d, x, y, JaxClassifyConfig(**CLASSIFY_KW))
    return d, str(actors_dir)


def pipeline_config():
    return PipelineConfig(extract=ExtractConfig(**KW),
                          merge=MergeConfig(min_face_size=10),
                          cluster=ClusterConfig(**CLUSTER_KW),
                          classify=ClassifyConfig(**CLASSIFY_KW))


def test_orchestrated_pipeline_matches_jax_stages(clip, jax_run, tmp_path):
    want, actors_dir = jax_run
    out = str(tmp_path / "port")
    stages = orchestrate.build_stages(
        clip.path, out, pipeline_config(), actors_dir=actors_dir,
        device="cpu", detector=ScriptedDetector(clip, max_detections=8),
        embedders=StubBank())
    assert [s.name for s in stages if not s.skip] == [
        "extract", "merge", "cluster", "classify"]
    got = os.path.join(out, f"{MOVIE}-data")
    assert orchestrate.run_pipeline(stages, data_dir=got, device="cpu")

    for name in BYTE_IDENTICAL:
        a = open(os.path.join(want, name), "rb").read()
        b = open(os.path.join(got, name), "rb").read()
        assert b == a, name
    want_f = [json.loads(l) for l in open(os.path.join(want, "features.jsonl"))]
    got_f = [json.loads(l) for l in open(os.path.join(got, "features.jsonl"))]
    assert len(got_f) == len(want_f) > 0
    for w, g in zip(want_f, got_f):
        w_emb, g_emb = w.pop("embeddings"), g.pop("embeddings")
        assert g == w and list(g_emb) == list(w_emb)
        for k in w_emb:
            np.testing.assert_allclose(g_emb[k], w_emb[k], rtol=0,
                                       atol=EMB_ATOL)
    preds = json.load(open(os.path.join(got, "predictions.json")))
    assert preds["predictions"]
    report = json.load(open(os.path.join(got, "run_report.json")))
    assert {"merge", "cluster", "classify", "pipeline"} <= set(report)
    assert set(report["pipeline"]["counters"]) == {
        f"{s}_seconds" for s in ("extract", "merge", "cluster", "classify")}
    assert jax_score(want, clip.truth) == score_detections(got, clip.truth)


def test_run_pipeline_aborts_at_the_first_failure(tmp_path):
    ran = []

    def fail():
        raise RuntimeError("injected")

    stages = [orchestrate.Stage("a", lambda: ran.append("a")),
              orchestrate.Stage("b", fail),
              orchestrate.Stage("c", lambda: ran.append("c"))]
    assert not orchestrate.run_pipeline(stages, data_dir=str(tmp_path),
                                        device="cpu")
    assert ran == ["a"]
    report = json.load(open(tmp_path / "run_report.json"))["pipeline"]
    assert report["counters"]["failed_stage"] == "b"
    assert "c_seconds" not in report["counters"]


def test_orchestrate_takes_the_jax_extract_flags(monkeypatch):
    """A JAX orchestrate command line with --fetch-every-blocks and
    --decode-workers parses in the port and reaches the same
    ExtractConfig."""
    from facerec_tpu.pipeline import orchestrate as jax_orchestrate

    argv = ["--filmfile", "125261-x.mp4", "--out-path", "out",
            "--fetch-every-blocks", "8", "--decode-workers", "3",
            "--wire-format", "rgb-delta", "--mesh", "2", "--shard-procs",
            "0", "--skip", "classify"]
    seen = {}
    for name, mod in (("jax", jax_orchestrate), ("port", orchestrate)):
        monkeypatch.setattr(mod, "build_stages",
                            lambda f, o, cfg, _n=name, **kw: seen.update(
                                {_n: (f, o, cfg, kw["mesh"])}) or [])
        monkeypatch.setattr(mod, "run_pipeline", lambda *a, **kw: True)
        assert mod.main(argv) == 0
    (f, o, jcfg, jmesh), (g, p, pcfg, pmesh) = seen["jax"], seen["port"]
    assert (f, o, jmesh) == (g, p, pmesh) == ("125261-x.mp4", "out", 2)
    assert dataclasses.asdict(pcfg.extract) == dataclasses.asdict(
        jcfg.extract)
    assert (pcfg.extract.fetch_every_blocks, pcfg.extract.decode_workers,
            pcfg.extract.wire_format) == (8, 3, "rgb-delta")


def test_build_stages_in_memory_and_refusals(tmp_path):
    mem = make_frames(8, path=f"{MOVIE}-Mem.mp4")
    cfg = PipelineConfig()
    stages = orchestrate.build_stages(mem, str(tmp_path), cfg, device="cpu")
    assert stages[0].name == "download" and stages[0].skip
    assert stages[-1].name == "classify" and stages[-1].skip  # no actors
    with pytest.raises(ValueError, match="film file"):
        orchestrate.build_stages(mem, str(tmp_path), cfg, shard_procs=2,
                                 device="cpu")
    # --mesh: two CPU processes with --device cpu; the first two cards
    # otherwise, which a host with fewer lacks
    from tests.test_torch_mesh import StubBank as MeshStub

    paint = paint_frames(8, path=f"{MOVIE}-Mem.mp4")
    stages = orchestrate.build_stages(
        paint, str(tmp_path), cfg, mesh=2, device="cpu",
        detector=ScriptedDetector(paint), embedders=MeshStub())
    assert [s.name for s in stages if not s.skip] == [
        "extract", "merge", "cluster"]
    counters = stages[1].run()
    assert len(counters) == 2
    report = json.load(open(tmp_path / f"{MOVIE}-data" / "run_report.json"))
    assert report["extract_mesh_2"]["counters"]["spans"] == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="needs 2 devices"):
            orchestrate.main(["--filmfile", "125261-x.mp4", "--mesh", "2"])
    # every wire format is ported: the stages build without a refusal
    wire = dataclasses.replace(cfg, extract=dataclasses.replace(
        cfg.extract, wire_format="rgb-delta"))
    stages = orchestrate.build_stages(mem, str(tmp_path), wire,
                                      device="cpu")
    assert [s.name for s in stages if not s.skip] == [
        "extract", "merge", "cluster"]


# --- the actor DB ---------------------------------------------------------

IMG_W, IMG_H = 100, 120
# per image: its faces (x1, y1, x2, y2); one face passes the gate
IMAGES = {
    "a1.jpg": [(20, 25, 62, 75)],
    "a2.jpg": [(10, 10, 40, 45), (55, 60, 90, 100)],    # two faces
    "a3.jpg": [(35, 40, 80, 95)],
    "a4.jpg": [(5, 50, 45, 100)],
}


def paint_images():
    rng = np.random.default_rng(2)
    out = {}
    for k, (name, boxes) in enumerate(IMAGES.items()):
        img = rng.integers(20, 90, (IMG_H, IMG_W, 3)).astype(np.uint8)
        for x1, y1, x2, y2 in boxes:
            img[y1:y2, x1:x2] = rng.integers(150, 250, 3)
        img[0, 0] = k               # the scripted detector's key
        out[name] = img
    return out


def detections(img_key, n_det=8):
    """(valid (1, D), boxes (1, D, 4)) of one image."""
    boxes = np.zeros((1, n_det, 4), np.float32)
    valid = np.zeros((1, n_det), bool)
    for j, b in enumerate(list(IMAGES.values())[img_key]):
        boxes[0, j] = np.array(b, np.float32) + 0.3
        valid[0, j] = True
    return valid, boxes


def port_detector(frames):
    valid, boxes = detections(int(frames[0, 0, 0, 0]))
    return types.SimpleNamespace(valid=torch.from_numpy(valid),
                                 boxes=torch.from_numpy(boxes))


def jax_detector(frames):
    valid, boxes = detections(int(frames[0, 0, 0, 0]))
    return types.SimpleNamespace(valid=jnp.asarray(valid),
                                 boxes=jnp.asarray(boxes))


def actor_services(images):
    """SPARQL and fetch stand-ins: a1, a2 from this film, a3, a4 from
    another; a4's download fails."""
    encoded = {n: cv2.imencode(".png", img[..., ::-1])[1].tobytes()
               for n, img in images.items()}
    bindings = []
    for name in IMAGES:
        film = "111" if name in ("a1.jpg", "a2.jpg") else "222"
        row = {"filmID": film, "filmname": f"Film {film}",
               "actorID": "42", "actorname": "Actor",
               "image_url": f"http://images/{name}", "filename": name}
        bindings.append({k: {"value": v} for k, v in row.items()})

    def sparql(query):
        return {"results": {"bindings": bindings}}

    def fetch(url):
        name = url.rsplit("/", 1)[1]
        return None if name == "a4.jpg" else encoded[name]

    decoded = {encoded[n]: img for n, img in images.items()}
    return sparql, fetch, decoded.get


def test_prepare_one_actor_matches_jax(tmp_path):
    images = paint_images()
    sparql, fetch, decode = actor_services(images)
    actor = {"filmID": "111", "actorID": "42", "actorname": "Actor"}
    jax_zip, port_zip = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jax_embed = jax_actors.FaceEmbedderForImages(detector=jax_detector,
                                                 embedders=JaxStubBank())
    port_embed = actors.FaceEmbedderForImages(
        detector=port_detector, embedders=StubBank(), device="cpu",
        decode=decode)
    want = jax_actors.prepare_one_actor(actor, 5, jax_zip, jax_embed,
                                        sparql=sparql, fetch=fetch)
    got = actors.prepare_one_actor(actor, 5, port_zip, port_embed,
                                   sparql=sparql, fetch=fetch)
    assert len(got) == len(want) == 2          # a1 and a3 have one face

    def close(g, w):
        g, w = dict(g), dict(w)
        ge, we = g.pop("embeddings", {}), w.pop("embeddings", {})
        assert g == w and list(ge) == list(we)
        for k in we:
            np.testing.assert_allclose(ge[k], we[k], rtol=0, atol=EMB_ATOL)

    for g, w in zip(got, want):
        close(g, w)
    with zipfile.ZipFile(jax_zip) as zw, zipfile.ZipFile(port_zip) as zg:
        assert zg.namelist() == zw.namelist()
        for n in zw.namelist():
            if n.endswith(".json"):
                close(json.loads(zg.read(n)), json.loads(zw.read(n)))
            else:
                assert zg.read(n) == zw.read(n)
    # a second run resumes from the zip and embeds nothing again
    again = actors.prepare_one_actor(actor, 5, port_zip, None,
                                     sparql=sparql, fetch=fetch)
    assert again == [json.loads(json.dumps(f)) for f in got]


def test_default_decoder_needs_opencv(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        actors.default_decode(b"\x89PNG")


# --- the probe-quality replay ---------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "probe_detector_w96.npz")
# the pinned budget of tests/test_probe_quality.py
FILM_W, FILM_H, FRAMES, IDENTITIES, DET_SIZE = 384, 288, 180, 3, 384
MIN_PRECISION = 0.9
MIN_RECALL = 0.8


@pytest.mark.slow
def test_probe_quality_replay_in_the_port(tmp_path):
    harness = DetectorHarness.from_npz(
        FIXTURE, device=torch.device("cpu"), input_size=(DET_SIZE, DET_SIZE),
        max_detections=16, score_threshold=0.9, min_face_size=20)
    clip = make_clip(str(tmp_path / "777-Probe_Film.mp4"), n_frames=FRAMES,
                     width=FILM_W, height=FILM_H,
                     cuts=(FRAMES // 3, 2 * FRAMES // 3), n_faces=2,
                     identities=IDENTITIES)
    data_root = str(tmp_path / "data")
    run_extract(clip.path, ExtractConfig(face_threshold=0.9, resume=False,
                                         save_images=False),
                data_root, detector=harness, embedders=StubBank(),
                device="cpu")
    merge.main(["--path", os.path.join(data_root, "*-data"),
                "--min-face-size", "20"])
    data_dir = os.path.join(data_root, "777-data")
    det = score_detections(data_dir, clip.truth)
    cuts = json.load(open(os.path.join(
        data_dir, "scene_changes.json")))["frame_indices"]
    print(f"probe replay (port, CPU): {det} cuts={cuts} "
          f"truth={clip.scene_cuts}")
    assert det["precision"] >= MIN_PRECISION, det
    assert det["recall"] >= MIN_RECALL, det
    assert cuts == clip.scene_cuts
    shutil.rmtree(data_root)
