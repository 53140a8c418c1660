"""The block step as one device program, and the e2e bench's detector:
the counterpart of ``facerec_tpu/benchdev.py``.

- :class:`HybridDetector`: the real detector's forward runs, its
  outputs replaced by scripted truth.
- :func:`make_device_step`: scene statistics, the detector, the tracker
  scan, crop and the pooled FaceNets of one frame block.  On a card it
  is ONE CUDA graph, captured once and replayed per block (the
  counterpart of the JAX package's one ``jax.jit``); on the CPU it runs
  eagerly, the plain version the tests hold against the JAX package.

Nothing here reads configuration from the environment; everything
arrives as arguments.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from facerec_torch.models.detector import DetectorHarness
from facerec_torch.ops import scene as scene_ops
from facerec_torch.ops.crops import crop_resize
from facerec_torch.pipeline.extract import EmbedderBank
from facerec_torch.runtime import graphs
from facerec_torch.runtime import launches as kernel_launches
from facerec_torch.runtime.device import resolve_device, use_full_float32
from facerec_torch.track import TrackerConfig, init_tracker, run_block


class HybridDetector:
    """Real detector FLOPs, scripted ground-truth detections.

    The harness's whole forward runs (the e2e bench pays the real conv
    cost), but its detections are replaced by the scripted detector's,
    plus a zero-valued dependency on the real scores, which keeps the
    forward in the program and gives the tracker, crop and embed stages
    a deterministic load.  Follows the harness's call contract
    (``set_block_start`` then a call on the block's frames)."""

    def __init__(self, harness: DetectorHarness, scripted):
        self.harness = harness
        self.scripted = scripted

    def set_block_start(self, frame0: int) -> None:
        self.scripted.set_block_start(frame0)

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor):
        real = self.harness(frames)
        truth = self.scripted(frames)
        anchor = real.scores.to(torch.float32).sum() * 0.0
        return type(real)(truth.boxes + anchor, truth.scores + anchor,
                          truth.landmarks + anchor, truth.valid)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class DeviceStep:
    """``step(*args)`` → ``(fingerprint, scene_state, tracker_state)``
    of one frame block; callers thread the two states back in through
    ``args[1]`` / ``args[2]``.

    On a card the block step is captured once into a CUDA graph over
    static copies of ``args``: a call copies its arguments into them
    (unless it passes the static tensors themselves) and replays the
    graph, and returns the graph's static outputs, which the next call
    overwrites.  ``eager`` runs the same step without the graph; on the
    CPU the call is ``eager``.  ``captured_launches`` counts each kernel
    launched per replay (the modules' counters count at capture, not at
    replay); ``replays`` counts the replays."""

    def __init__(self, detector, bank, tracker_cfg: TrackerConfig,
                 device: torch.device):
        self.detector = detector
        self.bank = bank
        self.tracker_cfg = tracker_cfg
        self.device = device
        # the block's first frame as a device scalar: a replay reads it
        # on the card
        self.frame0 = torch.zeros((), dtype=torch.int32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured_launches: Dict[str, int] = {}
        self.replays = 0
        self._static_in = None
        self._static_out = None

    @torch.no_grad()
    def components(self, frames, scene_state, tracker_state, crop_boxes,
                   crop_frames) -> dict:
        """The step's parts: scene flags, detections, tracker emissions,
        crops, embeddings, the fingerprint and the new states."""
        flags, scene_state = scene_ops.detect_block(frames, scene_state)
        det = self.detector(frames)
        tracker_state, emit = run_block(self.tracker_cfg, tracker_state,
                                        det.boxes, det.valid, flags,
                                        self.frame0)
        crops = crop_resize(frames, crop_frames, crop_boxes, 160)
        embs = self.bank.pooled(crops)
        emb_sum = sum(e.sum().to(torch.float32) for e in embs)
        fp = flags.sum().to(torch.float32) + emit.box.sum() + emb_sum
        return {"flags": flags, "detections": det, "emit": emit,
                "crops": crops, "embeddings": embs, "fingerprint": fp,
                "scene_state": scene_state, "tracker_state": tracker_state}

    def eager(self, *args):
        c = self.components(*args)
        return c["fingerprint"], c["scene_state"], c["tracker_state"]

    def capture(self, args, warmup: int = 2) -> None:
        """Warm up (:func:`facerec_torch.runtime.graphs.warm_up`), then
        capture one step over ``args`` as the static inputs."""
        graphs.warm_up(lambda: self.eager(*args), self.device, warmup)
        self._static_in = _leaves(args)
        before = kernel_launches.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = self.eager(*args)
        after = kernel_launches.snapshot()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    def __call__(self, *args):
        if self.graph is None:
            return self.eager(*args)
        leaves = _leaves(args)
        if len(leaves) != len(self._static_in):
            raise ValueError("the step takes the arguments it was "
                             "captured with")
        for static, given in zip(self._static_in, leaves):
            if given is not static:
                static.copy_(given)
        self.graph.replay()
        self.replays += 1
        return self._static_out


def make_device_step(detector_size, block: int, height: int, width: int,
                     crops_per_block: int,
                     bank: Optional[EmbedderBank] = None, device=None,
                     dtype: torch.dtype = torch.bfloat16):
    """Build the block-step program and its inputs.

    Returns ``(step, args)``: ``step(*args)`` runs scene statistics +
    detection (``max_detections=16``, ``score_threshold=0.95``, random
    weights from seed 0, in ``dtype``) + the tracker scan + crop to 160
    + the pooled FaceNets of one block and returns ``(fingerprint,
    scene_state, tracker_state)``, the fingerprint being ``flags.sum() +
    emit.box.sum() + Σ emb.sum()``.  ``args`` = (frames, scene_state,
    tracker_state, crop_boxes, crop_frames), drawn from
    ``np.random.default_rng(0)`` as the JAX package draws them.

    ``bank`` (an :class:`EmbedderBank`) may be passed in so that a
    second configuration reuses the four FaceNets; by default the four
    reference checkpoints, random from seeds 0..3, in ``dtype``.  On
    the card (the default) the step is a captured CUDA graph
    (:class:`DeviceStep`); ``device="cpu"`` runs it eagerly.  TF32
    stays off."""
    dev = resolve_device(device)
    use_full_float32()
    detector = DetectorHarness.create(
        input_size=tuple(detector_size), max_detections=16,
        score_threshold=0.95, device=dev, dtype=dtype)
    if bank is None:
        bank = EmbedderBank.create_default(dev, dtype=dtype)
    tracker_cfg = TrackerConfig(max_tracks=32, max_detections=16)
    step = DeviceStep(detector, bank, tracker_cfg, dev)

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(
        0, 255, (block, height, width, 3)).astype(np.uint8)).to(dev)
    crop_boxes = torch.from_numpy(np.stack(
        [rng.uniform(0, 300, crops_per_block),
         rng.uniform(0, 300, crops_per_block),
         rng.uniform(360, 700, crops_per_block),
         rng.uniform(360, 560, crops_per_block)],
        axis=1).astype(np.float32)).to(dev)
    crop_frames = torch.from_numpy(rng.integers(
        0, block, crops_per_block).astype(np.int32)).to(dev)
    args = (frames, scene_ops.initial_state(height, width, device=dev),
            init_tracker(tracker_cfg, dev), crop_boxes, crop_frames)
    if dev.type == "cuda":
        step.capture(args)
    return step, args
