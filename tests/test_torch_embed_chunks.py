"""The embedder bank's chunks on the CPU (``pipeline/extract.py``
``EmbedderBank.dispatch_packed``): nothing is captured, every chunk of
``EMBED_BATCH`` crops runs eagerly and is counted so, and the bytes are
the chunk-by-chunk composition of the embedders.  On a card the full
chunks replay a captured CUDA graph instead (``tests/test_torch_cuda.py``
``test_bank_replays_full_chunks_as_eager``)."""
import json
import os

import pytest
import torch

from facerec_torch.config import ARCFACE_NAME, ExtractConfig
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.models.iresnet import ArcFaceEmbedder
from facerec_torch.pipeline import extract
from facerec_torch.runtime.metrics import Spans
from facerec_torch.runtime.transfer import pack_tree
from facerec_torch.video.synth import ScriptedDetector, make_frames

MOVIE = "125261"
CHUNK_COUNTERS = ("embed_graph_replays", "embed_eager_chunks")


def facenet_bank():
    return extract.EmbedderBank({"m": FaceNetEmbedder("m", 128, "cpu",
                                                      seed=3)})


def arcface_bank():
    return extract.EmbedderBank({ARCFACE_NAME: ArcFaceEmbedder(
        ARCFACE_NAME, "cpu", seed=1, layers=(1, 1, 1, 1))})


def crops_for(bank, n):
    """``n`` crops of the bank's kind, seeded."""
    g = torch.Generator().manual_seed(n)
    if bank.takes_landmarks:
        return torch.rand((n, 3, 112, 112), generator=g) * 2 - 1
    return torch.rand((n, 160, 160, 3), generator=g) * 255


@pytest.mark.parametrize("n", [192, 130])
@pytest.mark.parametrize("make", [facenet_bank, arcface_bank])
def test_cpu_chunks_run_eagerly_as_composed(make, n):
    bank = make()
    crops = crops_for(bank, n)
    sp = Spans("t", (), bank.counter_names)
    got = bank.dispatch_packed(crops, sp)
    want = pack_tree(torch.cat([
        torch.cat(bank._embed(chunk), dim=-1).float()
        for chunk in crops.split(extract.EMBED_BATCH)]))
    assert torch.equal(got, want)
    assert bank.graph is None and bank.captures == 0
    assert sp.counters["embed_graph_replays"] == 0
    assert sp.counters["embed_eager_chunks"] == -(-n // extract.EMBED_BATCH)


def test_report_lists_the_chunk_counters(tmp_path):
    """The window report holds both chunk counters and the replay span,
    which the CPU never opens."""
    clip = make_frames(40, cuts=(22,), seed=5, path=f"{MOVIE}-Chunks.mp4")
    cfg = ExtractConfig(block_frames=16, max_detections=8, max_tracks=16,
                        save_images=False, resume=False,
                        fetch_every_blocks=2)
    extract.run_extract(clip, cfg, str(tmp_path),
                        detector=ScriptedDetector(clip, max_detections=8),
                        embedders=facenet_bank(), device="cpu")
    with open(os.path.join(str(tmp_path), f"{MOVIE}-data",
                           "run_report.json")) as f:
        report = json.load(f)[f"extract_0-{clip.n_frames}"]["counters"]
    assert set(CHUNK_COUNTERS) <= set(report)
    assert report["embed_graph_replays"] == 0
    assert report["embed_replay_seconds"] == 0
    # the CPU pads a flush to a power of two: this clip's fit one chunk
    assert report["embed_slots"] <= (extract.EMBED_BATCH
                                     * report["embed_dispatches"])
    assert report["embed_eager_chunks"] == report["embed_dispatches"] > 0
