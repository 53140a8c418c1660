"""Extract with an ArcFace bank on the CPU (``pipeline/extract.py``):
each saved face's ``arcface-r100`` vector equals the plain reference's
on the crop aligned to its landmarks, a FaceNet bank writes the same
bytes as the bank before the alignment existed, a bank holds one of the
two, and the CLIs choose the family.
The network runs at one block a stage (its published depth: the
reference comparison of ``tests/test_torch_iresnet.py``)."""
import json
import os

import numpy as np
import pytest
import torch

from facerec_torch.config import (ARCFACE_NAME, EMB_NAME, ExtractConfig,
                                  PipelineConfig)
from facerec_torch.models.detector import Detections
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.models.iresnet import ArcFaceEmbedder
from facerec_torch.pipeline import actors, extract, orchestrate
from facerec_torch.runtime.transfer import pack_tree
from facerec_torch.video.synth import ScriptedDetector, make_frames
from tests import plain_arcface as plain
from tests.test_torch_iresnet import seeded_state

LAYERS = (1, 1, 1, 1)
MOVIE = "125261"
KW = dict(block_frames=16, max_detections=8, max_tracks=16,
          save_images=False, resume=False, fetch_every_blocks=2)


@pytest.fixture(scope="module")
def clip():
    return make_frames(40, cuts=(22,), seed=5, path=f"{MOVIE}-Arc.mp4")


@pytest.fixture(scope="module")
def state():
    return seeded_state(LAYERS, seed=8)


def arcface(sd):
    return ArcFaceEmbedder(ARCFACE_NAME, "cpu", state_dict=sd, layers=LAYERS)


def facenet():
    return FaceNetEmbedder("m", 128, "cpu", seed=3)


def run(clip, out, bank):
    """Extract of the whole clip → (feature lines, report counters)."""
    extract.run_extract(clip, ExtractConfig(**KW), str(out),
                        detector=ScriptedDetector(clip, max_detections=8),
                        embedders=bank, device="cpu")
    data = os.path.join(str(out), f"{MOVIE}-data")
    tag = f"{MOVIE}_0-{clip.n_frames}"
    with open(os.path.join(data, "features", f"features_{tag}.jsonl"),
              "rb") as f:
        lines = f.read()
    with open(os.path.join(data, "run_report.json")) as f:
        report = json.load(f)[f"extract_0-{clip.n_frames}"]["counters"]
    return lines, report


def records(lines):
    return [json.loads(l) for l in lines.splitlines()]


def test_arcface_vectors_equal_the_reference(clip, state, tmp_path):
    lines, report = run(clip, tmp_path, extract.EmbedderBank(
        {ARCFACE_NAME: arcface(state)}))
    recs = records(lines)
    assert recs and all(list(r["embeddings"]) == [ARCFACE_NAME]
                        for r in recs)
    faces = []
    for r in recs:
        # the scripted detection that made the record: its rounded
        # landmarks are the record's keypoints
        marks = [m for _, m in clip.truth[r["frame"]]
                 if np.array_equal(np.round(m).astype(int),
                                   list(r["keypoints"].values()))]
        assert len(marks) == 1, r["frame"]
        faces.append({"frame": r["frame"], "landmarks": marks[0]})
    frames = torch.from_numpy(np.asarray(clip.frames))
    want = plain.Embedder(state, torch.device("cpu"), LAYERS)(frames, faces)
    got = np.array([r["embeddings"][ARCFACE_NAME] for r in recs])
    assert got.shape == (len(recs), 512)
    assert np.abs(got - want).max() <= 1e-5
    assert report["aligned_crops"] == report["embed_crops"] == len(recs)
    assert report["align_degenerate"] == 0
    assert report["flush_align_seconds"] > 0


class ParentBank(extract.EmbedderBank):
    """The FaceNet bank's embedding as it was before the alignment: every
    checkpoint on the box crops, 64 at a time."""

    def dispatch_packed(self, crops, spans=None):
        return pack_tree(torch.cat([
            torch.cat(self.pooled(chunk), dim=-1).float()
            for chunk in crops.split(extract.EMBED_BATCH)]))


def test_facenet_bank_writes_the_same_bytes(clip, tmp_path):
    now, report = run(clip, tmp_path / "now",
                      extract.EmbedderBank({"m": facenet()}))
    before, _ = run(clip, tmp_path / "before", ParentBank({"m": facenet()}))
    assert now and now == before
    # a bank that aligns nothing reports no alignment
    assert not {"flush_align_seconds", "aligned_crops",
                "align_degenerate"} & set(report)


def test_a_bank_holds_one_kind_of_crop(state):
    with pytest.raises(ValueError, match="not both"):
        extract.EmbedderBank({"m": facenet(), ARCFACE_NAME: arcface(state)})


def test_a_bank_that_aligns_needs_landmarks(clip, state):
    bank = extract.EmbedderBank({ARCFACE_NAME: arcface(state)})
    stack = torch.from_numpy(np.asarray(clip.frames[:2]))
    with pytest.raises(ValueError, match="landmarks"):
        bank.dispatch_crop_embed(stack, np.zeros(1, np.int64),
                                 np.float32([[0, 0, 40, 40]]))
    with pytest.raises(IndexError):
        bank.dispatch_crop_embed(stack, np.array([2]),
                                 np.float32([[0, 0, 40, 40]]),
                                 np.zeros((1, 5, 2), np.float32))
    # one set a real face, at most one a slot
    with pytest.raises(ValueError, match="2 landmark sets for 1 slots"):
        bank.dispatch_crop_embed(stack, np.zeros(1, np.int64),
                                 np.float32([[0, 0, 40, 40]]),
                                 np.zeros((2, 5, 2), np.float32))


def test_the_clis_choose_the_family(monkeypatch):
    monkeypatch.setenv("FACEREC_ALLOW_RANDOM", "1")
    seen = {}
    monkeypatch.setattr(extract, "run_extract",
                        lambda *a, **kw: seen.update(kw))
    extract.main(["--device", "cpu", "--embedder", ARCFACE_NAME,
                  "--arcface-weights", "/w/backbone.pth", f"{MOVIE}-x.mp4"])
    assert seen["embedder"] == ARCFACE_NAME
    assert seen["arcface_weights"] == "/w/backbone.pth"

    stages = {}
    monkeypatch.setattr(orchestrate, "build_stages",
                        lambda *a, **kw: stages.update(kw) or [])
    orchestrate.main(["--device", "cpu", "--filmfile", f"{MOVIE}-x.mp4",
                      "--embedder", ARCFACE_NAME])
    assert stages["embedder"] == ARCFACE_NAME

    cfg = PipelineConfig().for_embedder(ARCFACE_NAME)
    assert cfg.cluster.emb_name == cfg.classify.emb_name == ARCFACE_NAME
    assert PipelineConfig().for_embedder("facenet").cluster.emb_name \
        == EMB_NAME
    with pytest.raises(ValueError):
        PipelineConfig().for_embedder("r50")
    with pytest.raises(ValueError):
        extract.build_embedders(None, torch.device("cpu"), "r50")

    bank = extract.build_embedders(None, torch.device("cpu"), ARCFACE_NAME)
    assert bank.names == [ARCFACE_NAME] and bank.takes_landmarks
    assert bank.pooled is None


class OneFace:
    """A detector of one face: the clip's first truth at frame 0."""

    def __init__(self, clip):
        self.box, self.marks = clip.truth[0][0]

    def __call__(self, frames):
        def pad(a, shape):
            out = torch.zeros(shape)
            out[0, 0] = torch.as_tensor(a)
            return out
        return Detections(pad(self.box, (1, 8, 4)), pad(0.99, (1, 8)),
                          pad(self.marks, (1, 8, 5, 2)),
                          pad(True, (1, 8)).bool())


def test_actor_images_embed_on_the_aligned_crop(clip, state):
    frame = np.asarray(clip.frames[0])
    embed = actors.FaceEmbedderForImages(
        detector=OneFace(clip), device="cpu", decode=lambda b: frame,
        embedders=extract.EmbedderBank({ARCFACE_NAME: arcface(state)}))
    got = embed(b"image")
    want = plain.Embedder(state, torch.device("cpu"), LAYERS)(
        torch.from_numpy(frame[None]),
        [{"frame": 0, "landmarks": clip.truth[0][0][1]}])
    assert list(got["embeddings"]) == [ARCFACE_NAME]
    assert np.abs(np.array(got["embeddings"][ARCFACE_NAME])
                  - want[0]).max() <= 1e-5


def test_actor_images_embed_the_facenet_box_crop(clip):
    """A FaceNet bank gets the face's landmarks too, and embeds the box
    crop as it did before."""
    frame = np.asarray(clip.frames[0])
    bank = extract.EmbedderBank({"m": facenet()})
    embed = actors.FaceEmbedderForImages(
        detector=OneFace(clip), device="cpu", decode=lambda b: frame,
        embedders=bank)
    got = embed(b"image")
    crop_box = actors.embed_crop_box(got["box"], frame.shape[1],
                                     frame.shape[0])
    want = bank(extract.crops_of(torch.from_numpy(frame[None]),
                                 np.zeros(1, np.int64), crop_box[None]))
    assert list(got["embeddings"]) == ["m"]
    assert got["embeddings"]["m"] == want["m"][0].tolist()
