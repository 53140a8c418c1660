"""The ``arcface`` embedder family (``portbench/embedders/arcface.py``):
its frozen FLOP count, a seeded draw whose scale stays bounded through
the 100 layers, whole tiny runs on the CPU (correct as the program is;
not correct, by ``emb_gap``, with a fault planted in the alignment or
the network), and the two readers it brings."""
import sys

import pytest
import torch
import torch.nn.functional as F

from facerec_torch.models import iresnet
from facerec_torch.ops import align as align_ops
from portbench import film, run
from portbench.reference import arcface

CPU = torch.device("cpu")
FLOPS = 24_179_212_288


@pytest.fixture(scope="module")
def family():
    return run.embedder_family({"embedder_family": "arcface"})


def test_flops_per_crop_is_frozen(family):
    config = film.load_json("configs", "pal576-r100")
    layers = tuple(config["arcface"]["layers"])
    states = {config["arcface"]["name"]: (512, dict.fromkeys(
        arcface.shapes(layers)))}
    assert family.flops_per_crop(states) == FLOPS == arcface.flops()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17])
def test_seeded_draw_keeps_every_stage_in_scale(family, seed):
    """At the published widths and depth, each stage's output RMS lies
    within 1e-2 to 1e2 of the stem's."""
    sd = family.draw(seed, CPU)
    x = torch.rand((1, 3, 112, 112), generator=torch.Generator()
                   .manual_seed(seed % 1000)) * 2 - 1
    with torch.no_grad():
        rms = [float(t.pow(2).mean().sqrt())
               for t in arcface.trunk(sd, x)]
    for r in rms[1:]:
        assert 1e-2 <= r / rms[0] <= 1e2, rms


def test_every_term_is_drawn(family):
    sd = family.draw(3, CPU, (1, 1, 1, 1))
    for key, v in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key == "features.weight":
            assert torch.equal(v, torch.ones(512))
        else:
            assert v.std() > 0, key
    assert sd["layer2.0.bn3.weight"].max() < 0.25


@pytest.fixture
def arcface_cell(tiny_cell):
    """The tiny cell with an ArcFace bank of one block a stage."""
    config = tiny_cell[1]
    del config["facenets"]
    config.update(embedder_family="arcface", arcface={
        "name": "arcface-r100", "features": 512, "layers": [1, 1, 1, 1]})
    return tiny_cell


def test_tiny_run_is_correct(arcface_cell, run_tiny):
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["checks"]["emb_gap"]["value"] <= 1e-5


def _eyes_swapped(monkeypatch):
    """The two eye landmarks trade places before the alignment."""
    inner = align_ops.align

    def call(frames, idx, ldm):
        return inner(frames, idx, ldm[:, [1, 0, 2, 3, 4]])
    monkeypatch.setattr(align_ops, "align", call)


def _half_pixel_offset(monkeypatch):
    """The warp samples half a pixel to the right."""
    inner = align_ops.inverse_maps

    def maps(ldm):
        m = inner(ldm).clone()
        m[:, 2] += 0.5
        return m
    monkeypatch.setattr(align_ops, "inverse_maps", maps)


def _prelu_as_relu(monkeypatch):
    monkeypatch.setattr(torch.nn.PReLU, "forward",
                        lambda self, x: F.relu(x))


def _nhwc_flatten(monkeypatch):
    """The head flattens the last map channel last."""
    def forward(self, x):
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        flat = self.bn2(x).permute(0, 2, 3, 1).flatten(1)
        return self.features(self.fc(flat))
    monkeypatch.setattr(iresnet.IResNet, "forward", forward)


def _features_dropped(monkeypatch):
    """The last batch norm is left out."""
    monkeypatch.setattr(torch.nn.BatchNorm1d, "forward",
                        lambda self, x: x)


@pytest.mark.parametrize("fault", [_eyes_swapped, _half_pixel_offset,
                                   _prelu_as_relu, _nhwc_flatten,
                                   _features_dropped])
def test_fault_fails_by_emb_gap(fault, arcface_cell, run_tiny, monkeypatch):
    fault(monkeypatch)
    checks = run_tiny()["checks"]
    assert checks["emb_gap"]["value"] > checks["emb_gap"]["limit"], checks
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if k != "emb_gap"), checks


def test_parent_fails_at_once(family, monkeypatch):
    """A program without the network raises as the bank is built."""
    monkeypatch.setitem(sys.modules, "facerec_torch.models.iresnet", None)
    with pytest.raises(ImportError):
        family.program_bank({"arcface-r100": (512, {})}, CPU, None)


def ctx(kernels, crops=200, report=None):
    return {"trace": {"kernels": kernels}, "window": {"crops": crops},
            "report": report or {}, "device_kind": "NVIDIA H100 80GB HBM3",
            "peaks": film.load_json(".", "peaks")}


NAMES = [("align_roofline", "%"), ("loop.align_ms_per_block", "ms")]


def test_readers_read_a_made_up_window():
    got = run.layer_metrics(NAMES, ctx(
        {"align_warp_kernel(unsigned char const*, ...)": 0.002,
         "sm90_xmma_fprop": 1.0},
        report={"blocks": 8, "flush_align_seconds": 0.04}))
    assert got["align_roofline"]["value"] == pytest.approx(
        100 * 200 * 150_568 / 3.35e12 / 0.002)
    assert got["loop.align_ms_per_block"] == {"value": pytest.approx(5.0),
                                              "unit": "ms"}


def test_readers_read_nothing_without_the_alignment():
    """A FaceNet bank's window: no align kernel, no span."""
    got = run.layer_metrics(NAMES, ctx(
        {"sm90_xmma_fprop": 1.0},
        report={"blocks": 8, "flush_embed_seconds": 0.5}))
    assert got == {}
    assert run.layer_metrics(NAMES, ctx({"align_warp_kernel": 0.001},
                                        crops=0)) == {}
