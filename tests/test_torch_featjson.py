"""The native feature-line writer (``contract/featjson.py``,
``csrc/featjson.cpp``) against ``json``.

Values: byte for byte ``json.dumps(a.tolist(), separators=(",", ":"))``
on float32 bit patterns (NaN, infinities, zeros and subnormals among
them), every power of two in float32's range, the values around
``repr``'s switches between fixed and exponent notation, unit vectors
like embeddings, and float64 bit patterns.  Flushes: the native path of
``ShardConsumer.complete_flush`` writes the bytes of the plain path
(``feature_record_for`` + ``records.write_feature``) on the same
``PendingEmbed``, from a slice of a group fetch and from the buffer
pulled alone; a machine that cannot build the library writes through
the plain path; and ``run_report.json`` counts the lines and bytes of
the files.
"""
import io
import json
import os

import numpy as np
import pytest
import torch

from facerec_torch.config import FACENET_DIMS, FACENET_MODELS, ExtractConfig
from facerec_torch.contract import MovieDirs, featjson, records
from facerec_torch.ops.boxes import round_clip_box
from facerec_torch.pipeline import extract as ex
from facerec_torch.pipeline import faces as faces_mod
from facerec_torch.runtime.metrics import Spans
from facerec_torch.tools.soak import StubBank
from facerec_torch.video.synth import ScriptedDetector, make_frames

MOVIE = "125261"
W, H = 768, 576


@pytest.fixture(scope="module")
def lib():
    return featjson.load_library()


def assert_same_text(got, want):
    """``got == want``, shown at the first difference (pytest's diff of
    megabytes of text would run for minutes)."""
    if got != want:
        i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        assert (len(got), got[max(0, i - 80):i + 80]) == \
            (len(want), want[max(0, i - 80):i + 80])


def f32_bits(rng):
    bits = rng.integers(0, 1 << 32, size=2_000_000, dtype=np.uint64)
    special = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00001, 0x00000001, 0x807FFFFF,
                        0x00800000, 0x7F7FFFFF], np.uint64)
    return np.concatenate([special, bits]).astype(np.uint32).view(np.float32)


def f32_powers_of_two(rng):
    p = np.ldexp(np.float32(1), np.arange(-149, 128)).astype(np.float32)
    return np.concatenate([p, -p])


def switch_points(rng):
    """Around 1e-4 / 1e-5 and 1e15 / 1e16, in float64 and float32."""
    centre = np.array([1e-5, 1e-4, 1e15, 1e16])
    steps = np.arange(-64, 65)
    f64 = np.concatenate([c + steps * np.spacing(c) for c in centre])
    f32 = np.concatenate([
        np.float32(c) + steps.astype(np.float32) * np.spacing(np.float32(c))
        for c in centre]).astype(np.float32)
    return np.concatenate([f64, -f64, f32.astype(np.float64),
                           [9.999999e-5, 0.0001, 1e16 - 2, 1e16 + 2]])


def unit_vectors(rng):
    v = rng.normal(size=(800, 512)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def f64_bits(rng):
    return rng.integers(0, 1 << 64, size=500_000,
                        dtype=np.uint64).view(np.float64)


@pytest.mark.parametrize("make", [f32_bits, f32_powers_of_two, switch_points,
                                  unit_vectors, f64_bits],
                         ids=lambda f: f.__name__)
def test_values_match_json(lib, make):
    a = make(np.random.default_rng(14)).reshape(-1)
    got = featjson.format_lines(lib, a[None], ["v"], [a.size], ["<"], [">"],
                                n_threads=3)
    assert_same_text(got, "<" + json.dumps({"v": a.tolist()},
                                           separators=(",", ":")) + ">")


class FetchedBank(ex.EmbedderBank):
    """The four checkpoints' names and widths, for ``unpack`` alone."""

    def __init__(self):
        self.names = list(FACENET_MODELS)
        self.dims = [FACENET_DIMS[n] for n in self.names]
        self.total_dim = sum(self.dims)


def consumer(root, bank, device="cpu"):
    cfg = ExtractConfig(save_images=False)
    dirs = MovieDirs.create(str(root), int(MOVIE))
    return ex.ShardConsumer(dirs, int(MOVIE), cfg, 0, 1000, W, H, bank,
                            torch.device(device), Spans("extract", ex.SPANS,
                                                        ex.COUNTERS))


def flush(n, rng):
    """A flush of ``n`` faces and its (n, 1280) float32 embeddings:
    unit vectors, and in the first face NaN, ±inf, ±0 and a
    subnormal."""
    ready, tight = [], []
    for i in range(n):
        x, y = rng.uniform(0, W - 60), rng.uniform(0, H - 60)
        box = np.float32([x, y, x + rng.uniform(20, 60),
                          y + rng.uniform(20, 60)])
        ready.append(faces_mod.PendingFace(
            frame=int(rng.integers(0, 1000)), uid=i, posterior_box=box,
            landmarks=rng.uniform(0, W, size=(5, 2)).astype(np.float32)))
        tight.append(round_clip_box(box, W, H))
    emb = rng.normal(size=(n, sum(FACENET_DIMS.values()))).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[0, :6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45]
    return ready, tight, emb


def plain_text(c, pe, embeddings):
    out = io.StringIO()
    for i, p in enumerate(pe.ready):
        records.write_feature(out, faces_mod.feature_record_for(
            c.movie_id, p.frame, pe.tight_boxes[i],
            {k: v[i].tolist() for k, v in embeddings.items()},
            p.landmarks, c.d_w, c.d_h))
    return out.getvalue()


def written(c):
    c.features_file.flush()
    with open(c.features_path) as f:
        return f.read()


@pytest.mark.parametrize("path", ["fetched", "pulled"])
@pytest.mark.parametrize("n", [1, 7, 190])
def test_complete_flush_native_equals_plain(tmp_path, n, path):
    """The flush's bytes as a slice of a group fetch, or pulled alone
    from ``dev_packed`` (as at a checkpoint and at the end)."""
    rng = np.random.default_rng(n)
    ready, tight, emb = flush(n, rng)
    bank = FetchedBank()
    c = consumer(tmp_path, bank)
    assert c.feature_writer.lib is not None
    # the batch's padded slots follow the real crops
    buf = np.concatenate([emb, np.full((3, emb.shape[1]), 7.0,
                                       np.float32)]).view(np.uint8).reshape(-1)
    pe = ex.PendingEmbed(ready, tight, torch.from_numpy(buf))
    c.complete_flush(pe, buf if path == "fetched" else None)
    want = plain_text(c, pe, bank.unpack(buf, n))
    assert_same_text(written(c), want)
    assert c.spans.counters["fetch_bytes"] == (
        0 if path == "fetched" else buf.size)
    assert c.spans.counters["feature_records"] == n
    assert c.spans.counters["feature_records_native"] == n
    assert c.spans.counters["feature_bytes"] == len(want)
    assert c.counters.saved_boxes == n
    assert c.counters.saved_frames == len({p.frame for p in ready})


def test_without_the_library_json_writes(tmp_path, monkeypatch):
    """Where the library cannot be built, a CPU run writes through the
    plain path; a card run raises."""
    def refuse():
        raise RuntimeError("no host C++ compiler")

    monkeypatch.setattr(featjson, "load_library", refuse)
    rng = np.random.default_rng(3)
    ready, tight, emb = flush(7, rng)
    bank = FetchedBank()
    c = consumer(tmp_path, bank)
    assert c.feature_writer.lib is None
    buf = emb.view(np.uint8).reshape(-1)
    pe = ex.PendingEmbed(ready, tight, torch.from_numpy(buf))
    c.complete_flush(pe, buf)
    assert_same_text(written(c), plain_text(c, pe, bank.unpack(buf, 7)))
    assert c.spans.counters["feature_records"] == 7
    assert c.spans.counters["feature_records_native"] == 0
    with pytest.raises(RuntimeError, match="no host C"):
        featjson.FeatureWriter(required=True)


def test_writer_leaves_other_dtypes_to_json(lib):
    w = featjson.FeatureWriter(required=False)
    rec = {"frame": 1, "embeddings": {}, "w": 2}
    assert w.lines(1, lambda i, e: rec, {"m": np.ones((1, 3), np.int32)}) \
        is None
    got = w.lines(2, lambda i, e: dict(rec, frame=i), {
        "a": np.float32([[0.5], [1e-5]]), "b": np.float64([[1e16], [-0.0]])})
    assert got == ('{"frame":0,"embeddings":{"a":[0.5],"b":[1e+16]},"w":2}\n'
                   '{"frame":1,"embeddings":{"a":[9.999999747378752e-06],'
                   '"b":[-0.0]},"w":2}\n')


@pytest.mark.parametrize("group", [1, 2])
def test_report_counts_the_feature_files(tmp_path, group):
    mem = make_frames(48, cuts=(20,), seed=5,
                      path=f"{MOVIE}-TestFilm-1955.mp4")
    cfg = ExtractConfig(save_images=False, block_frames=16, max_detections=8,
                        max_tracks=16, fetch_every_blocks=group)
    counters = ex.run_extract(
        mem, cfg, str(tmp_path), detector=ScriptedDetector(mem,
                                                           max_detections=8),
        embedders=StubBank(), device="cpu")
    data = tmp_path / f"{MOVIE}-data"
    with open(data / "run_report.json") as f:
        rep = json.load(f)["extract_0-48"]["counters"]
    files = [data / "features" / n for n in os.listdir(data / "features")]
    lines = sum(len(p.read_bytes().splitlines()) for p in files)
    assert rep["feature_records"] == lines == counters.saved_boxes > 0
    assert rep["feature_records_native"] == lines
    assert rep["feature_bytes"] == sum(os.path.getsize(p) for p in files)
