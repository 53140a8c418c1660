"""The plain reference against the port at a small size on the CPU,
layer by layer, and a whole tiny run of the harness."""
import numpy as np
import pytest
import torch

from facerec_torch.models.detector import DetectorHarness
from facerec_torch.models.facenet import FaceNetEmbedder, PooledEmbedders
from facerec_torch.ops import scene as port_scene
from facerec_torch.ops.crops import crop_resize
from portbench import film, painter
from portbench.reference import detect, embed, nets, scene
from portbench.weights import facenet_states

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frames():
    return painter.paint(48, 128, 96, 7, (20, 37), 2, 4)


def test_detector_matches_port(frames, tiny_cell):
    _, config, _, _ = tiny_cell
    path = film.detector_weights(config)
    ref = detect.Detector(nets.detector_state_from_npz(path), (96, 128), CPU)
    port = DetectorHarness.from_npz(path, device="cpu", input_size=(96, 128))
    want = ref(frames[:16])
    got = port(torch.from_numpy(frames[:16]))
    n = 0
    for i, w in enumerate(want):
        v = got.valid[i].numpy()
        assert v.sum() == len(w.boxes)
        np.testing.assert_allclose(got.boxes[i].numpy()[v], w.boxes,
                                   atol=1e-3)
        np.testing.assert_allclose(got.scores[i].numpy()[v], w.scores,
                                   atol=1e-5)
        np.testing.assert_allclose(got.landmarks[i].numpy()[v],
                                   w.landmarks, atol=1e-3)
        n += len(w.boxes)
    assert n > 0


def test_scene_flags_match_port(frames):
    first, later = scene.pool_flags(lambda a, b: frames[a:b], len(frames),
                                    CPU, chunk=10)
    film_frames = np.concatenate([frames, frames, frames])
    state = port_scene.initial_state(96, 128)
    flags = []
    for a in range(0, len(film_frames), 16):
        f, state = port_scene.detect_block(
            torch.from_numpy(film_frames[a:a + 16]), state)
        flags.extend(f.tolist())
    assert flags == first.tolist() + later.tolist() * 2
    assert first[20] and first[37] and later[0]


def test_crops_match_port(frames):
    boxes = torch.tensor([[0.0, 0.0, 40.0, 52.0], [60.5, 20.0, 128.0, 96.0],
                          [10.0, 30.0, 30.0, 70.0]])
    idx = torch.tensor([0, 5, 9])
    want = embed.crops(torch.from_numpy(frames[idx.numpy()]), boxes)
    got = crop_resize(torch.from_numpy(frames), idx, boxes, 160)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_facenets_match_port():
    dims = {"a": 512, "b": 128}
    states = facenet_states(dims, 5, CPU)
    crops = torch.rand(3, 160, 160, 3, generator=torch.Generator()
                       .manual_seed(0)) * 255
    want = embed.Embedders(states, CPU)(crops)
    port = PooledEmbedders([FaceNetEmbedder(n, d, device="cpu",
                                            state_dict=sd)
                            for n, (d, sd) in states.items()])
    got = port(crops)
    for name, g in zip(dims, got):
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5)


def test_tiny_run_is_correct(run_tiny):
    result = run_tiny()
    checks = result["checks"]
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert checks["emb_gap"]["value"] < 1e-5
    assert set(result["metrics"]) == {"extract_fps", "setup_s"}
    assert list(result)[-1] == "checks"
