"""The port's frame-sharded block step against the JAX package's serial
pieces.

Four gloo processes on the CPU each take 8 frames of a 32-frame block
(``sharded_extract_step``).  Their flags must equal the JAX package's
serial ``detect_block`` on the whole block (also with the block starting
mid-film, where rank 0 warms up), their detections the detector's on
the whole block, and their tracker emissions JAX's ``run_block`` over
each rank's frames from its uid base: integer fields exactly, boxes
within ``BOX_ATOL`` (``tests/test_torch_tracker_block.py``).  This
mirrors ``tests/test_parallel.py``.

The worker processes import this module to find ``_rank``, so JAX is
imported only inside the fixtures.
"""
import numpy as np
import pytest
import torch

from facerec_torch.models.detector import Detections
from facerec_torch.parallel.extract_sharded import (UID_STRIDE,
                                                    sharded_extract_step)
from facerec_torch.parallel.mesh import run_ranks
from facerec_torch.track import TrackerConfig

N = 4
B = 32
BOX_ATOL = 1e-4
INT_FIELDS = ("emit", "detected", "uid", "first_frame", "det_slot",
              "overflow")


class BrightBoxDetector:
    """``tests/test_parallel.py``'s detector: one fixed box per frame,
    valid where the frame's mean brightness is above 0."""

    def __init__(self, d=4):
        self.d = d

    def __call__(self, frames):
        b = frames.shape[0]
        mean = frames.float().mean(dim=(1, 2, 3))
        boxes = torch.tensor([8.0, 8.0, 40.0, 40.0]).repeat(b, self.d, 1)
        valid = torch.zeros((b, self.d), dtype=torch.bool)
        valid[:, 0] = mean > 0
        scores = torch.where(valid, 0.99, 0.0)
        ldm = torch.zeros((b, self.d, 5, 2))
        return Detections(boxes, scores, ldm, valid)


def _rank(rank, device, frames, frame0s):
    """This rank's share of the block at each block start."""
    local = torch.from_numpy(frames[rank * (B // N):(rank + 1) * (B // N)])
    outs = []
    for frame0 in frame0s:
        out = sharded_extract_step(
            BrightBoxDetector(), TrackerConfig(max_tracks=4,
                                               max_detections=4),
            local.to(device), block_frame0=frame0)
        outs.append({
            "flags": out.flags.numpy(),
            "boxes": out.detections.boxes.numpy(),
            "valid": out.detections.valid.numpy(),
            **{k: getattr(out.emit, k).numpy()
               for k in ("box",) + INT_FIELDS}})
    return outs


@pytest.fixture(scope="module")
def frames():
    from tests.test_scene import make_clip

    return make_clip(np.random.default_rng(0), n=B, h=48, w=64, n_cuts=4)


@pytest.fixture(scope="module")
def sharded(frames):
    """Per block start (0, then 1000): the ranks' outputs."""
    per_rank = run_ranks(_rank, ["cpu"] * N, args=(frames, (0, 1000)))
    return [[r[i] for r in per_rank] for i in range(2)]


@pytest.fixture(scope="module")
def serial(frames):
    import jax.numpy as jnp

    from facerec_tpu.ops import scene as scene_ops
    from tests.test_parallel import BrightBoxDetector as JaxDetector

    flags, _ = scene_ops.detect_block(jnp.asarray(frames),
                                      scene_ops.initial_state(48, 64))
    det = JaxDetector()(jnp.asarray(frames))
    return np.asarray(flags), det


def test_sharded_scene_matches_serial(sharded, serial):
    got = np.concatenate([r["flags"] for r in sharded[0]])
    np.testing.assert_array_equal(got, serial[0])
    assert got.any()


def test_sharded_scene_mid_film_warmup(sharded, serial):
    """With the block at frame 1000 rank 0 has no left halo: its first
    two frames warm up, as a fresh serial shard's do."""
    got = np.concatenate([r["flags"] for r in sharded[1]])
    np.testing.assert_array_equal(got, serial[0])


def test_sharded_detections_match_serial(sharded, serial):
    det = serial[1]
    np.testing.assert_array_equal(
        np.concatenate([r["valid"] for r in sharded[0]]),
        np.asarray(det.valid))
    np.testing.assert_allclose(
        np.concatenate([r["boxes"] for r in sharded[0]]),
        np.asarray(det.boxes))


def test_sharded_tracker_uid_namespaces(sharded):
    for rank, r in enumerate(sharded[0]):
        uids = r["uid"][r["emit"]]
        assert uids.size
        assert (uids // UID_STRIDE == rank).all()


@pytest.mark.parametrize("start", [0, 1])
def test_sharded_emissions_match_jax_run_block(sharded, serial, start):
    """Each rank's tracker is JAX's run_block over its frames, from the
    serial flags and detections and the rank's uid base."""
    import jax.numpy as jnp

    from facerec_tpu.track import TrackerConfig as JaxTrackerConfig
    from facerec_tpu.track import init_tracker, run_block

    flags, det = serial
    block0 = (0, 1000)[start]
    cfg = JaxTrackerConfig(max_tracks=4, max_detections=4)
    local = B // N
    for rank, got in enumerate(sharded[start]):
        sl = slice(rank * local, (rank + 1) * local)
        state = init_tracker(cfg)._replace(
            next_uid=jnp.int32(rank * UID_STRIDE))
        _, want = run_block(cfg, state, det.boxes[sl], det.valid[sl],
                            jnp.asarray(flags[sl]),
                            jnp.int32(block0 + rank * local))
        for k in INT_FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(
                getattr(want, k)), err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["box"], np.asarray(want.box),
                                   rtol=0, atol=BOX_ATOL)
