"""The extract loop's spans and counters (``runtime/metrics.py:Spans``).

The recorder's nesting and totals; on a scripted extract of a tiny
in-memory clip on the CPU, the seven phases against the loop's wall
time, each child inside its parent, the counters against what the
detector, the bank and the packed buffers saw; the CPU's block upload
(the plain copy, the same files); and the spans as host
ranges of the torch profiler, including a profiler that starts and
stops inside a span, as the benchmark's probe does at a block boundary.
"""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from facerec_torch.config import ExtractConfig
from facerec_torch.contract import MovieDirs
from facerec_torch.contract.naming import movie_id_from_filename
from facerec_torch.pipeline import extract as ex
from facerec_torch.runtime.metrics import Spans
from facerec_torch.tools.soak import StubBank
from facerec_torch.video.synth import ScriptedDetector, make_frames

MOVIE = "125261"
KW = dict(block_frames=16, max_detections=8, max_tracks=16,
          save_images=False, fetch_every_blocks=2)
CHILDREN = {"dispatch": ("dispatch_scene", "dispatch_detector",
                         "dispatch_tracker", "dispatch_pack"),
            "consume": ("consume_unpack", "consume_assemble",
                        "consume_plan", "consume_write"),
            "flush_dispatch": ("flush_embed",)}


class RecordingBank(StubBank):
    """The soak's stub bank, recording each batch's slots."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def dispatch_packed(self, crops, spans=None):
        self.batches.append(int(crops.shape[0]))
        return super().dispatch_packed(crops, spans)


class CountingDetector(ScriptedDetector):
    """The scripted detector, counting the valid detections it gave."""

    def __init__(self, clip, **kw):
        super().__init__(clip, **kw)
        self.valid = 0

    def __call__(self, frames):
        det = super().__call__(frames)
        self.valid += int(det.valid.sum())
        return det


@pytest.fixture(scope="module")
def clip():
    return make_frames(56, cuts=(24,), seed=7,
                       path=f"{MOVIE}-SpanFilm-1955.mp4")


def count_payloads(monkeypatch):
    """The bytes of each block's packed payload, as the loop packs them
    (the bank packs its embeddings through the same function: those are
    left out)."""
    sizes = []
    pack = ex.pack_tree

    def counting_pack(tree):
        buf = pack(tree)
        if not isinstance(tree, torch.Tensor):
            sizes.append(int(buf.numel()))
        return buf

    monkeypatch.setattr(ex, "pack_tree", counting_pack)
    return sizes


def run_loop(clip, out, bank, detector=None, **kw):
    """``run_span`` over the whole clip → (SpanRun, its wall seconds)."""
    cfg = ExtractConfig(**KW, **kw)
    name, info = ex.film_info(clip, cfg, "aspect_ratios.csv")
    dirs = MovieDirs.create(out, movie_id_from_filename(name))
    detector = detector or ScriptedDetector(clip, max_detections=8)
    t0 = time.perf_counter()
    run = ex.run_span(clip, info, cfg, dirs, int(MOVIE), 0, info.n_frames,
                      info.n_frames, detector, bank, torch.device("cpu"))
    return run, time.perf_counter() - t0


def test_recorder_nests_and_totals():
    sp = Spans("t", spans=("idle",), counters=("n",))
    with sp.span("outer", frame0=3):
        time.sleep(0.002)
        with sp.span("inner"):
            time.sleep(0.004)
        with sp.span("inner"):
            time.sleep(0.001)
    sp.count("n", 5)
    sp.count("n", 2)
    assert sp.parent == {"outer": None, "inner": "outer"}
    assert sp.seconds["idle"] == 0.0
    assert sp.seconds["inner"] >= 0.005
    # the parent covers its children: its self time is at least its own
    # sleep
    assert sp.seconds["outer"] - sp.seconds["inner"] >= 0.002
    assert sp.last["inner"] < sp.seconds["inner"]      # two calls summed
    assert sp.totals() == {"idle_seconds": 0.0,
                           "outer_seconds": sp.seconds["outer"],
                           "inner_seconds": sp.seconds["inner"], "n": 7}
    with pytest.raises(ValueError, match="'inner' opened under None"):
        with sp.span("inner"):
            pass


def test_span_counts_through_an_exception():
    sp = Spans("t")
    with pytest.raises(RuntimeError):
        with sp.span("outer"):
            with sp.span("inner"):
                raise RuntimeError("in the span")
    assert set(sp.seconds) == set(sp.last) == {"outer", "inner"}
    with sp.span("outer"):     # the stack unwound
        pass
    assert sp.parent["outer"] is None


def test_phases_children_and_counters(clip, tmp_path, monkeypatch):
    packed = count_payloads(monkeypatch)
    bank = RecordingBank()
    detector = CountingDetector(clip, max_detections=8)
    run, wall = run_loop(clip, str(tmp_path), bank, detector)
    sp = run.spans

    assert set(sp.seconds) >= set(ex.SPANS)
    assert sum(sp.seconds[p] for p in ex.PHASES) <= wall
    assert {p: sp.parent[p] for p in ex.PHASES} == dict.fromkeys(ex.PHASES)
    for parent, children in CHILDREN.items():
        for child in children:
            assert sp.parent[child] == parent, child
            assert 0 < sp.seconds[child] <= sp.seconds[parent], child
        assert sp.seconds[parent] - sum(
            sp.seconds[child] for child in children) >= 0, parent
    assert run.blocks == 4     # 56 frames, 16/block

    c = sp.counters
    assert c["embed_crops"] == run.counters.saved_boxes > 0
    assert c["embed_slots"] == sum(bank.batches) > c["embed_crops"]
    assert c["embed_dispatches"] == len(bank.batches)
    assert c["detections"] == detector.valid > 0
    assert c["fetch_bytes"] == sum(packed) + \
        c["embed_slots"] * bank.total_dim * 4
    # two groups of two blocks, then the embeddings of the flushes that
    # the second group's blocks made
    assert c["fetch_groups"] == 3
    assert c["upload_bytes"] == clip.frames.nbytes


def test_deferred_bank_fetches_the_embeddings(clip, tmp_path, monkeypatch):
    """The bank's embeddings ride the group fetches (and the last flush
    is pulled alone): their bytes count in ``fetch_bytes``."""
    payload = count_payloads(monkeypatch)
    bank = StubBank()
    run, _ = run_loop(clip, str(tmp_path), bank)
    c = run.spans.counters
    assert c["embed_crops"] == run.counters.saved_boxes > 0
    assert c["fetch_bytes"] == sum(payload) + \
        c["embed_slots"] * bank.total_dim * 4


def test_report_holds_every_span_and_counter(clip, tmp_path):
    cfg = ExtractConfig(**KW)
    ex.run_extract(clip, cfg, str(tmp_path),
                   detector=ScriptedDetector(clip, max_detections=8),
                   embedders=RecordingBank(), device="cpu")
    with open(tmp_path / f"{MOVIE}-data" / "run_report.json") as f:
        rep = json.load(f)[f"extract_0-{clip.n_frames}"]["counters"]
    for name in ex.SPANS:
        assert rep[f"{name}_seconds"] >= 0, name
    for name in ex.COUNTERS:
        # the CPU's blocks take the plain copy, not the pinned ring
        if name == "upload_pinned_blocks":
            assert rep[name] == 0
        else:
            assert rep[name] > 0, name
    assert rep["consume_write_seconds"] <= rep["consume_seconds"]


def extract_files(root):
    """{relative path: bytes} of an extract's files, its run report
    (which holds timings) left out."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name != "run_report.json":
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def test_cpu_upload_is_the_plain_copy(clip, tmp_path, monkeypatch):
    """On the CPU every block takes the plain copy: no copy stream,
    ``upload_pinned_blocks`` 0, and the files byte for byte those of the
    loop whose upload is ``torch.from_numpy(block).to(device)``."""
    cfg = ExtractConfig(**KW)

    def no_stream(device):
        raise AssertionError("a copy stream on the CPU")

    def extract(out):
        ex.run_extract(clip, cfg, str(out),
                       detector=ScriptedDetector(clip, max_detections=8),
                       embedders=StubBank(), device="cpu")
        data = out / f"{MOVIE}-data"
        with open(data / "run_report.json") as f:
            rep = json.load(f)[f"extract_0-{clip.n_frames}"]["counters"]
        return extract_files(str(data)), rep

    with monkeypatch.context() as m:
        m.setattr(ex, "_copy_stream", no_stream)
        files, rep = extract(tmp_path / "ring")
    assert rep["upload_pinned_blocks"] == 0 and rep["blocks"] == 4
    assert rep["upload_bytes"] == clip.frames.nbytes
    monkeypatch.setattr(ex._BlockUpload, "__call__",
                        lambda self, block: torch.from_numpy(block).to(
                            self.device))
    plain, _ = extract(tmp_path / "plain")
    assert any(k.startswith("features") for k in files)
    assert files == plain


@pytest.mark.parametrize("shape", [(16, 24, 32, 3),     # an RGB block
                                   (16, 36, 32),        # an I420 block
                                   (5, 24, 32, 3)])     # a short last one
def test_block_upload_on_the_cpu(shape):
    """The CPU's upload returns the block's bytes and pins nothing."""
    up = ex._BlockUpload(torch.device("cpu"))
    block = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    dev = up(block)
    assert dev.device.type == "cpu" and dev.dtype == torch.uint8
    assert np.array_equal(dev.numpy(), block)
    assert up.slots == [] and up.copied == []


def host_ranges(prof):
    """[(name, start, end, kwinputs)] of the program's host ranges."""
    return [(e.name[len("extract."):], e.time_range.start,
             e.time_range.end, e.kwinputs) for e in prof.events()
            if e.name.startswith("extract.")]


def check_nesting(ranges):
    """Each child range lies inside a range of its parent."""
    parents = {c: p for p, cs in CHILDREN.items() for c in cs}
    for name, a, b, _ in ranges:
        if name not in parents:
            continue
        assert any(p == parents[name] and pa <= a and b <= pb
                   for p, pa, pb, _ in ranges), name


def test_profiler_sees_the_spans(clip, tmp_path):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        ex.run_extract(clip, ExtractConfig(**KW), str(tmp_path),
                       detector=ScriptedDetector(clip, max_detections=8),
                       embedders=RecordingBank(), device="cpu")
    ranges = host_ranges(prof)
    names = {r[0] for r in ranges}
    assert names == set(ex.SPANS)
    check_nesting(ranges)
    frame0s = sorted(kw["frame0"] for name, _, _, kw in ranges
                     if name == "dispatch")
    assert frame0s == [0, 16, 32, 48]
    # children carry their parent's identifier
    assert sorted(kw["frame0"] for name, _, _, kw in ranges
                  if name == "dispatch_detector") == frame0s
    assert sorted(kw["group"] for name, _, _, kw in ranges
                  if name == "fetch") == [0, 1, 2]
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("extract."))


class ProfilingDetector(ScriptedDetector):
    """Starts the profiler at the block ``start`` and stops it two
    blocks later, from inside the detector's call, as the benchmark's
    probe does: spans are open at both ends."""

    def __init__(self, clip, start, **kw):
        super().__init__(clip, **kw)
        self.start, self.calls, self.prof = start, 0, None

    def __call__(self, frames):
        if self.calls == self.start:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
        elif self.calls == self.start + 2:
            self.prof.stop()
        self.calls += 1
        return super().__call__(frames)


def test_profiler_starting_and_stopping_inside_spans(clip, tmp_path):
    bank = RecordingBank()
    detector = ProfilingDetector(clip, 1, max_detections=8)
    run, _ = run_loop(clip, str(tmp_path / "profiled"), bank, detector)
    plain, _ = run_loop(clip, str(tmp_path / "plain"), RecordingBank())
    assert run.spans.parent == plain.spans.parent
    assert run.spans.counters == plain.spans.counters
    ranges = host_ranges(detector.prof)
    names = [r[0] for r in ranges]
    # block 1's dispatch opened before the profiler: its last children
    # come first, without a parent range.  Block 2's dispatch lies
    # inside the profile, and block 3's was open when it stopped.
    assert names[:2] == ["dispatch_tracker", "dispatch_pack"]
    assert names.count("dispatch") == names.count("dispatch_scene") == 2
    assert names.count("upload") == 2
    check_nesting(ranges[2:])
    with profile(activities=[ProfilerActivity.CPU]) as later:
        with run.spans.span("decode"):
            pass
    assert [r[0] for r in host_ranges(later)] == ["decode"]
    for got, want in ((tmp_path / "profiled", tmp_path / "plain"),):
        for sub in ("features", "trajectories"):
            d = os.path.join(got, f"{MOVIE}-data", sub)
            (fname,) = os.listdir(d)
            with open(os.path.join(d, fname), "rb") as f, \
                    open(os.path.join(want, f"{MOVIE}-data", sub,
                                      fname), "rb") as g:
                assert f.read() == g.read(), sub


def test_align_span_nests_under_flush_embed(clip, tmp_path):
    """An ArcFace bank's alignment is the span ``flush_align`` under
    ``flush_embed``, host range and all, and it aligns every real
    crop."""
    from facerec_torch.config import ARCFACE_NAME
    from facerec_torch.models.iresnet import ArcFaceEmbedder

    bank = ex.EmbedderBank({ARCFACE_NAME: ArcFaceEmbedder(
        ARCFACE_NAME, "cpu", seed=1, layers=(1, 1, 1, 1))})
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run, _ = run_loop(clip, str(tmp_path), bank)
    sp = run.spans
    assert sp.parent["flush_align"] == "flush_embed"
    assert 0 < sp.seconds["flush_align"] <= sp.seconds["flush_embed"]
    c = sp.counters
    assert c["aligned_crops"] == c["embed_crops"] == \
        run.counters.saved_boxes > 0
    assert c["align_degenerate"] == 0
    ranges = host_ranges(prof)
    assert {"flush_align", "flush_embed"} <= {r[0] for r in ranges}
    for name, a, b, _ in ranges:
        if name == "flush_align":
            assert any(p == "flush_embed" and pa <= a and b <= pb
                       for p, pa, pb, _ in ranges)
