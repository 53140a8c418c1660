"""Multi-device dry run: every multi-device path once, on tiny inputs.

Counterpart of ``__graft_entry__.py:dryrun_multichip``, over n processes
(one per device) in place of an n-device JAX mesh:

  1. the frame-axis sharded extract step (halo exchange, per-rank
     tracker with its uid namespace);
  2. two steps of the span step with carried scene and tracker state,
     as each process of a mesh extract runs them, then the
     4-checkpoint FaceNet bank over crops;
  3. a data-parallel detector training step;
  4. a data-parallel FaceNet triplet step.

Run: ``python -m facerec_torch.parallel.dryrun --n 2`` (the first two
cards), ``--device cpu`` for two CPU processes.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from facerec_torch.parallel.mesh import mesh_devices, run_ranks


def _rank(rank: int, device: torch.device, n: int) -> dict:
    import torch.distributed as dist

    from facerec_torch.models.detector import DetectorHarness, FaceDetector
    from facerec_torch.models.layers import init_weights
    from facerec_torch.ops import scene as scene_ops
    from facerec_torch.parallel.extract_sharded import (UID_STRIDE,
                                                        sharded_extract_step)
    from facerec_torch.parallel.mesh import gather_rows
    from facerec_torch.pipeline.extract import EmbedderBank, block_step
    from facerec_torch.track import TrackerConfig, init_tracker
    from facerec_torch.train import DetectorTrainer
    from facerec_torch.train.facenet_train import FaceNetTrainer

    world = dist.group.WORLD
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {}

    # 1. the sharded step: 2 frames per rank of one 2n-frame block
    det = DetectorHarness.create(input_size=(64, 64), max_detections=4,
                                 score_threshold=0.5, device=device)
    frames = np.random.default_rng(0).integers(
        0, 255, (2 * n, 48, 64, 3)).astype(np.uint8)
    tcfg = TrackerConfig(max_tracks=8, max_detections=4)
    with torch.inference_mode():
        step = sharded_extract_step(det, tcfg,
                                    on(frames[2 * rank:2 * rank + 2]))
        flags = gather_rows(step.flags.to(torch.int32), world)
    uids = step.emit.uid[step.emit.emit]
    if flags.shape != (2 * n,) or bool((uids // UID_STRIDE != rank).any()):
        raise AssertionError(f"sharded step: flags {tuple(flags.shape)}, "
                             f"uids {uids.tolist()}")

    # 2. two span steps with carried state, then the FaceNet bank
    scene_state = scene_ops.initial_state(48, 64, crop=True, device=device)
    tracker_state = init_tracker(tcfg, device)
    block = on(np.random.default_rng(2 + rank).integers(
        0, 255, (4, 48, 64, 3)).astype(np.uint8))
    with torch.inference_mode():
        for frame0 in (100 * rank, 100 * rank + 4):
            (flags, _, _, _), scene_state, tracker_state = block_step(
                det, tcfg, block, scene_state, tracker_state, frame0)
            if flags.shape != (4,):
                raise AssertionError(f"span step flags {flags.shape}")
        bank = EmbedderBank.create_default(device)
        embs = bank(on(np.random.default_rng(3).integers(
            0, 255, (2, 160, 160, 3)).astype(np.uint8)))
    if len(embs) != 4 or not all(np.isfinite(v).all() for v in embs.values()):
        raise AssertionError("the FaceNet bank gave non-finite embeddings")

    # 3. a data-parallel detector step: one image per rank
    rng = np.random.default_rng(1)
    images = rng.integers(0, 255, (n, 64, 64, 3)).astype(np.uint8)
    boxes = rng.uniform(0, 32, (n, 2, 4)).astype(np.float32)
    boxes[..., 2:] += 16.0
    valid = np.ones((n, 2), bool)
    ldm = np.zeros((n, 2, 5, 2), np.float32)
    model = FaceDetector(fpn_features=16)
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = DetectorTrainer(model, (64, 64), device=device, group=world)
    mine = slice(rank, rank + 1)
    out["det_loss"] = float(trainer.step(images[mine], boxes[mine],
                                         valid[mine], ldm[mine]))
    out["det_replicas_identical"] = trainer.replicas_identical()

    # 4. a data-parallel FaceNet triplet step: two crops per rank
    crops = rng.integers(0, 255, (2 * n, 160, 160, 3)).astype(np.uint8)
    labels = np.arange(2 * n) % n
    ft = FaceNetTrainer(embedding_dim=16, device=device, group=world)
    mine = slice(2 * rank, 2 * rank + 2)
    out["facenet_loss"] = float(ft.step(crops[mine], labels[mine]))
    out["facenet_replicas_identical"] = ft.replicas_identical()
    return out


def dryrun_multichip(n: int, devices: Optional[Sequence] = None,
                     backend: Optional[str] = None) -> dict:
    """The four multi-device paths over n processes: on ``devices`` (one
    per rank, a card may repeat with ``backend="gloo"``), else the
    first n cards.  Raises on any failed check; prints one closing
    line and returns rank 0's losses."""
    devs = mesh_devices(n, devices=devices)
    if any(d.type == "cuda" for d in devs):
        from facerec_torch.ops import _build

        _build.build_all()     # once, before n workers would race on it
    outs = run_ranks(_rank, devs, args=(n,), backend=backend)
    for key in ("det", "facenet"):
        losses = {o[f"{key}_loss"] for o in outs}
        if len(losses) != 1 or not np.isfinite(losses.pop()):
            raise AssertionError(f"{key} losses differ or are not finite: "
                                 f"{[o[f'{key}_loss'] for o in outs]}")
        if not all(o[f"{key}_replicas_identical"] for o in outs):
            raise AssertionError(f"{key}: the ranks' replicas differ")
    print(f"dryrun_multichip({n}): extract+train OK, "
          f"det_loss={outs[0]['det_loss']:.3f} "
          f"facenet_loss={outs[0]['facenet_loss']:.3f}", flush=True)
    return outs[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--n", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the first n cards) or cpu (n CPU "
                             "processes)")
    parser.add_argument("--backend", default=None,
                        help="process-group backend (default: nccl on "
                             "distinct cards, gloo on the CPU)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, devices=mesh_devices(args.n, args.device),
                     backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
