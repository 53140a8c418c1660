"""Embedder families (``portbench/embedders/``): the FaceNet family is
the harness's earlier FaceNet code behind the family's functions, and a
new family, with its own program half, reference and configuration,
runs through the harness with no file of it edited."""
import math
import sys

import numpy as np
import pytest
import torch

from facerec_torch.pipeline import extract
from portbench import counts, film, painter, run, weights
from portbench.reference import embed

CPU = torch.device("cpu")

# A toy family: two small conv nets on a 24x24 crop warped by the
# similarity that takes the face's five landmarks to insightface's
# template.  The program half warps with grid_sample in float32; the
# reference half is a plain module of its own, in float64.
TOY_FAMILY = '''
"""A toy embedder family for the harness's tests."""
import math

import numpy as np
import torch

import toy_reference

FAULT = {fault}


def states(config, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    out = {{}}
    for name, dim in config["toy_nets"].items():
        sd = {{}}
        for key, shape in toy_reference.shapes(dim).items():
            v = torch.randn(shape, generator=gen, device=device)
            sd[key] = v * (math.prod(shape[1:]) ** -0.5 if len(shape) > 1
                           else 0.1)
        out[name] = (dim, sd)
    return out


def _aligned(stack, frame_idx, landmarks):
    """(N, 3, S, S) float32 crops: grid_sample at the template's points
    mapped back into each frame."""
    s = toy_reference.SIZE
    src = torch.as_tensor(landmarks, dtype=torch.float32,
                          device=stack.device)
    dst = torch.as_tensor(toy_reference.TEMPLATE, dtype=torch.float32,
                          device=stack.device)
    sc, dc = src - src.mean(1, keepdim=True), dst - dst.mean(0)
    norm = (sc ** 2).sum((1, 2))
    a = (sc * dc).sum((1, 2)) / norm
    b = (sc[..., 0] * dc[:, 1] - sc[..., 1] * dc[:, 0]).sum(1) / norm
    # the inverse of x -> [[a, -b], [b, a]] x + t, from the template's
    # pixel centres back into the frame
    g = torch.arange(s, dtype=torch.float32, device=stack.device)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    u = xx[None] - dst[:, 0].mean()
    v = yy[None] - dst[:, 1].mean()
    det = (a * a + b * b)[:, None, None]
    x = (a[:, None, None] * u + b[:, None, None] * v) / det \\
        + src[:, :, 0].mean(1)[:, None, None]
    y = (a[:, None, None] * v - b[:, None, None] * u) / det \\
        + src[:, :, 1].mean(1)[:, None, None]
    frames = stack[torch.as_tensor(frame_idx, device=stack.device)]
    h, w = frames.shape[1:3]
    grid = torch.stack([(2 * x + 1) / w - 1, (2 * y + 1) / h - 1], -1)
    return torch.nn.functional.grid_sample(
        frames.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
        padding_mode="zeros", align_corners=False)


def _forward(sd, crops):
    x = (crops - 127.5) / 127.5
    x = torch.relu(torch.nn.functional.conv2d(
        x, sd["conv1.weight"], sd["conv1.bias"], stride=2, padding=1))
    x = torch.relu(torch.nn.functional.conv2d(
        x, sd["conv2.weight"], sd["conv2.bias"], stride=2, padding=1))
    e = x.mean((2, 3)) @ sd["fc.weight"].T
    return e / torch.linalg.vector_norm(e, dim=1, keepdim=True)


def program_bank(states, device, probe):
    from facerec_torch.pipeline.extract import EmbedderBank
    from portbench.probe import make_bank

    class ToyBank(EmbedderBank):
        def __init__(self, nets):
            self.nets = nets
            self.names = list(nets)
            self.dims = [dim for dim, _ in nets.values()]
            self.total_dim = sum(self.dims)
            self.supports_deferred = True

        def dispatch_crop_embed(self, stack, frame_idx, crop_boxes,
                                landmarks):
            crops = _aligned(stack, frame_idx, landmarks)
            e = torch.cat([_forward(sd, crops)
                           for _, sd in self.nets.values()], 1)
            e[:, 0] += FAULT
            return e.contiguous().view(torch.uint8).reshape(-1)

    return make_bank(ToyBank, states, probe)


def warm(bank, stack, block, height, width):
    ldm = np.float32(toy_reference.TEMPLATE) + [width / 2, height / 2]
    bank.dispatch_crop_embed(stack, np.zeros(4, np.int64),
                             np.zeros((4, 4), np.float32),
                             np.repeat(ldm[None], 4, 0))


def reference(states, device):
    return lambda frames, faces: toy_reference.embed(states, frames, faces)


def flops_per_crop(states):
    return sum(toy_reference.flops(dim) for dim, _ in states.values())
'''

TOY_REFERENCE = '''
"""The toy family's reference: the least-squares similarity from the
five landmarks to the template, solved as a linear system, its inverse
applied to each crop pixel's centre, bilinear taps with zeros outside
the frame, and the two convolutions and the dense layer, in float64."""
import numpy as np
import torch

SIZE = 24
# insightface's 112-px five-point template, scaled to SIZE
TEMPLATE = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                     [56.0252, 71.7366], [41.5493, 92.3655],
                     [70.7299, 92.2041]]) * SIZE / 112


def shapes(dim):
    return {"conv1.weight": (8, 3, 3, 3), "conv1.bias": (8,),
            "conv2.weight": (16, 8, 3, 3), "conv2.bias": (16,),
            "fc.weight": (dim, 16)}


def flops(dim):
    h1, h2 = SIZE // 2, SIZE // 4
    return 2 * (h1 * h1 * 8 * 27 + h2 * h2 * 16 * 72 + dim * 16)


def similarity(src, dst):
    """(a, b, tx, ty) of x -> [[a, -b], [b, a]] x + t closest to dst."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src, dst):
        rows += [[x, -y, 1.0, 0.0], [y, x, 0.0, 1.0]]
        rhs += [u, v]
    return np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)[0]


def warp(frame, landmarks):
    """frame (H, W, 3) → the (3, SIZE, SIZE) aligned crop."""
    a, b, tx, ty = similarity(np.asarray(landmarks, np.float64), TEMPLATE)
    m = np.linalg.inv(np.array([[a, -b, tx], [b, a, ty], [0, 0, 1]]))
    h, w = frame.shape[:2]
    f = np.asarray(frame, np.float64)
    out = np.zeros((SIZE, SIZE, 3))
    for i in range(SIZE):
        for j in range(SIZE):
            x, y, _ = m @ [j, i, 1.0]
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            tx_, ty_ = x - x0, y - y0
            for yy, wy in ((y0, 1 - ty_), (y0 + 1, ty_)):
                for xx, wx in ((x0, 1 - tx_), (x0 + 1, tx_)):
                    if 0 <= yy < h and 0 <= xx < w:
                        out[i, j] += wy * wx * f[yy, xx]
    return out.transpose(2, 0, 1)


def embed(states, frames, faces):
    host = frames.cpu().numpy()
    x = torch.from_numpy(np.stack([warp(host[f["frame"]], f["landmarks"])
                                   for f in faces]))
    x = (x - 127.5) / 127.5
    out = {}
    for name, (dim, sd) in states.items():
        p = {k: v.cpu().double() for k, v in sd.items()}
        y = torch.relu(torch.nn.functional.conv2d(
            x, p["conv1.weight"], p["conv1.bias"], stride=2, padding=1))
        y = torch.relu(torch.nn.functional.conv2d(
            y, p["conv2.weight"], p["conv2.bias"], stride=2, padding=1))
        e = y.mean((2, 3)) @ p["fc.weight"].T
        e = e / torch.linalg.vector_norm(e, dim=1, keepdim=True)
        out[name] = e.numpy()
    return out
'''


def _write_toy(path, fault=0.0):
    (path / "toy.py").write_text(TOY_FAMILY.format(fault=fault))
    (path / "toy_reference.py").write_text(TOY_REFERENCE)


def _hand_landmarks(monkeypatch):
    """The extract loop hands each saved face's float landmarks to the
    bank after its crop boxes, padded as the boxes are: the program
    change an aligned family needs."""
    inner = extract.ShardConsumer.dispatch_flush_plans

    def dispatch(self):
        ldm = np.float32([p.landmarks for plan in self._plans
                          for p in plan.ready]).reshape(-1, 5, 2)
        bank = self.embedders
        call = type(bank).dispatch_crop_embed

        def with_landmarks(stack, frame_idx, crop_boxes):
            pad = np.repeat(ldm[-1:], len(frame_idx) - len(ldm), 0)
            return call(bank, stack, frame_idx, crop_boxes,
                        np.concatenate([ldm, pad]))
        bank.dispatch_crop_embed = with_landmarks
        try:
            return inner(self)
        finally:
            del bank.dispatch_crop_embed
    monkeypatch.setattr(extract.ShardConsumer, "dispatch_flush_plans",
                        dispatch)


@pytest.fixture
def toy_cell(tiny_cell, tmp_path, monkeypatch):
    """The tiny cell with the toy family in a directory of its own."""
    monkeypatch.setattr(run, "FAMILIES", str(tmp_path))
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "toy_reference", raising=False)
    _hand_landmarks(monkeypatch)
    config = tiny_cell[1]
    del config["facenets"]
    config.update(embedder_family="toy",
                  toy_nets={"toy-a": 32, "toy-b": 16})
    return tmp_path


def test_toy_family_runs_correct(toy_cell, run_tiny):
    _write_toy(toy_cell)
    result = run_tiny()
    checks = result["checks"]
    assert result["correct"], checks
    assert math.isfinite(checks["emb_gap"]["value"])
    assert result["attempted"] > 0 and result["failed"] == 0


def test_toy_family_fault_fails_by_emb_gap(toy_cell, run_tiny):
    _write_toy(toy_cell, fault=1e-3)
    result = run_tiny()
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks["emb_gap"]["value"] > checks["emb_gap"]["limit"]
    assert all(v["value"] <= v["limit"] for k, v in checks.items()
               if k != "emb_gap"), checks


@pytest.fixture(scope="module")
def facenet():
    return run.embedder_family({})


@pytest.mark.parametrize("seed", [0, 5])
def test_facenet_states_are_the_seeded_weights(facenet, seed):
    config = film.load_json("configs", "pal576")
    got = facenet.states(config, seed, CPU)
    want = weights.facenet_states(config["facenets"], seed, CPU)
    assert list(got) == list(want)
    for name, (dim, sd) in want.items():
        assert got[name][0] == dim
        assert list(got[name][1]) == list(sd)
        for key, v in sd.items():
            assert torch.equal(got[name][1][key], v), (name, key)


def test_facenet_flops_per_crop(facenet):
    dims = film.load_json("configs", "pal576")["facenets"]
    states = {name: (dim, {}) for name, dim in dims.items()}
    assert facenet.flops_per_crop(states) == 11_338_545_920
    assert facenet.flops_per_crop(states) == sum(
        map(counts.facenet_flops, dims.values()))


def test_facenet_reference_is_the_earlier_path(facenet):
    frames = painter.paint(12, 128, 96, 7, (5,), 2, 4)
    states = weights.facenet_states({"a": 512, "b": 128}, 5, CPU)
    faces = [{"frame": 0, "box": [10, 20, 50, 68]},
             {"frame": 2, "box": [0, 0, 30, 40]},
             {"frame": 2, "box": [90, 50, 128, 96]},
             {"frame": 1, "box": [40, 30, 76, 74]}]
    for f in faces:
        f["landmarks"] = np.zeros((5, 2))
    dev = torch.from_numpy(frames[[3, 8, 11]])
    got = facenet.reference(states, CPU)(dev, faces)
    boxes = torch.tensor([embed.crop_box(f["box"], 128, 96) for f in faces])
    want = embed.Embedders(states, CPU)(embed.crops(
        dev[[f["frame"] for f in faces]], boxes))
    assert list(got) == ["a", "b"]
    for name in want:
        assert np.array_equal(got[name], want[name])


def test_naming_the_facenet_family_changes_nothing(tiny_cell, run_tiny):
    without = run_tiny()["checks"]
    tiny_cell[1]["embedder_family"] = "facenet"
    assert run_tiny()["checks"] == without
