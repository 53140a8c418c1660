"""The check catches a broken timed path: a whole tiny run on the CPU
(the harness's look for a card skipped) with one fault planted in the
program underneath comes out not correct."""
import pytest
import torch

from facerec_torch.models.detector import DetectorHarness
from facerec_torch.models.facenet import FaceNet
from facerec_torch.pipeline import extract


def _state_unchanged(monkeypatch):
    """The tracker's step returns the state it was given: no track
    outlives its block."""
    inner = extract.run_block

    def step(cfg, state, *args):
        _, emit = inner(cfg, state, *args)
        return state, emit
    monkeypatch.setattr(extract, "run_block", step)


def _scene_state_unchanged(monkeypatch):
    """The scene step returns the state it was given."""
    inner = extract.scene_ops.detect_block

    def step(frames, state, *args, **kw):
        flags, _ = inner(frames, state, *args, **kw)
        return flags, state
    monkeypatch.setattr(extract.scene_ops, "detect_block", step)


def _half_the_block(monkeypatch):
    """The detector runs on the first half of each block only."""
    inner = DetectorHarness.__call__

    def call(self, frames):
        det = inner(self, frames)
        valid = det.valid.clone()
        valid[len(valid) // 2:] = False
        return det._replace(valid=valid)
    monkeypatch.setattr(DetectorHarness, "__call__", call)


def _box_altered(monkeypatch):
    """Each detection's box is moved by a third of a pixel."""
    inner = DetectorHarness.__call__

    def call(self, frames):
        det = inner(self, frames)
        return det._replace(boxes=det.boxes + 1.0 / 3.0)
    monkeypatch.setattr(DetectorHarness, "__call__", call)


def _embedding_altered(monkeypatch):
    """One element of every embedding is off by 1e-3."""
    inner = extract.EmbedderBank.unpack

    def unpack(self, buf, n):
        out = inner(self, buf, n)
        name = self.names[0]
        out[name] = out[name].copy()
        out[name][:, 0] += 1e-3
        return out
    monkeypatch.setattr(extract.EmbedderBank, "unpack", unpack)


def _bn_statistics_dropped(monkeypatch):
    """The embedding's batch norm leaves out its mean and offset, as a
    wrong fold of it into the dense kernel would."""
    def bottleneck(self, feats):
        bn = self.Bottleneck_BatchNorm
        return ((feats.float() @ self.Bottleneck.weight.T.float())
                * torch.rsqrt(bn.var.float() + 1e-3))
    monkeypatch.setattr(FaceNet, "bottleneck", bottleneck)


@pytest.mark.parametrize("fault", [_state_unchanged, _scene_state_unchanged,
                                   _half_the_block,
                                   _box_altered, _embedding_altered,
                                   _bn_statistics_dropped])
def test_fault_is_not_correct(fault, run_tiny, monkeypatch):
    fault(monkeypatch)
    result = run_tiny()
    assert not result["correct"], result["checks"]
