"""The frozen counts against the published figures and torch's own
FLOP counter on the port's modules."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts


def test_detector_flops():
    assert round(counts.detector_flops(576, 768) / 1e9, 2) == 16.61
    assert round(counts.detector_flops(1080, 1920) / 1e9, 2) == 78.43


def test_facenet_flops():
    assert round(counts.facenet_flops(512) / 1e9, 3) == 2.835
    assert round(counts.facenet_flops(128) / 1e9, 3) == 2.834


def test_scene_bytes():
    assert round(counts.scene_bytes(128, 576, 768) / 1e6) == 415


@pytest.mark.parametrize("hw", [(576, 768), (1080, 1920)])
def test_detector_flops_match_torch_counter(hw):
    from facerec_torch.models.detector import FaceDetector

    with torch.device("meta"):
        model = FaceDetector(96)
        x = torch.empty(1, 3, -(-hw[0] // 32) * 32, -(-hw[1] // 32) * 32)
    with FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == counts.detector_flops(*hw)


@pytest.mark.parametrize("dim", [512, 128])
def test_facenet_flops_match_torch_counter(dim):
    from facerec_torch.models.facenet import FaceNet

    with torch.device("meta"):
        model = FaceNet(dim)
        x = torch.empty(1, 3, 160, 160)
    with FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == counts.facenet_flops(dim)
