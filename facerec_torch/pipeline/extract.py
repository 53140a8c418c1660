"""Extract stage: decode → scene → detect → track → embed → contract files.

Port of ``facerec_tpu/pipeline/extract.py`` on one device.  The film
streams through the device in frame blocks:

  host    decode block (B, H, W, 3) RGB or (B, H·3/2, W) I420
  host    wire encode: temporal delta (rgb-delta, yuv420-delta)
  device  wire decode (exact delta undo; BT.601 I420 → RGB)
  device  scene statistics (CUDA kernels hist256 + cum_lookup on a card)
  device  detector forward + decode + top-k + greedy NMS
  device  tracker over the block's frames
  device  pack the block's flags, emissions and detections into bytes
  host    every ``fetch_every_blocks`` blocks: one copy of the group's
          payloads and its deferred embeddings (runtime/transfer.py)
  host    trajectory assembly + the deferred face buffer
  device  crop + resize + all four FaceNet checkpoints, once per group
  host    trajectory/feature/scene-change writers

Cross-block carry is the scene state and the tracker table, both on the
device.  Output bytes are the same at any fetch grouping and on the
``rgb`` and ``rgb-delta`` wires; ``yuv420-delta`` requantizes chroma.
:func:`run_span` is that loop over one span of the film; ``--mesh N``
runs N spans at once, one process per device
(:mod:`facerec_torch.parallel.extract_mesh`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from facerec_torch.config import (FACENET_DIMS, FACENET_MODELS,
                                  FACE_IMAGE_SIZE, ExtractConfig)
from facerec_torch.contract import MovieDirs, records
from facerec_torch.contract.naming import box_tag, movie_id_from_filename, \
    shard_file_name
from facerec_torch.models.facenet import FaceNetEmbedder, PooledEmbedders
from facerec_torch.models.load import load_facenet_embedders, warn_random_init
from facerec_torch.ops import scene as scene_ops
from facerec_torch.ops import yuv as yuv_ops
from facerec_torch.ops.boxes import round_clip_box
from facerec_torch.ops.crops import crop_resize
from facerec_torch.pipeline import faces as faces_mod
from facerec_torch.runtime import checkpoint as ckpt
from facerec_torch.runtime.device import resolve_device, use_full_float32
from facerec_torch.runtime.metrics import StageReport
from facerec_torch.runtime.transfer import pack_tree, tree_spec, unpack_tree
from facerec_torch.track import (TrackEmit, TrackerConfig,
                                 TrajectoryAssembler, init_tracker,
                                 run_block)
from facerec_torch.video.reader import (fetch_ring_blocks,
                                        load_aspect_ratio_csv, open_reader,
                                        source_info)

WIRE_FORMATS = ("rgb", "rgb-delta", "yuv420-delta")
# crops per FaceNet forward.  On a card the crop batch is padded to a
# multiple of it, so every crop is embedded in a batch of one shape
# whatever the fetch grouping (cuDNN and cuBLAS pick kernels by shape,
# and with them the rounding)
EMBED_BATCH = 64


@dataclasses.dataclass
class FlushPlan:
    """One block-flush's face selection, before any device work."""

    ready: List["faces_mod.PendingFace"]
    tight_boxes: List[np.ndarray]
    crop_boxes: np.ndarray


@dataclasses.dataclass
class PendingEmbed:
    """A dispatched crop+embed batch of one or more flushes.

    A deferred bank leaves ``dev_packed``, a uint8 device buffer of
    ``nbytes`` bytes that rides the next group fetch and comes back to
    :meth:`ShardConsumer.complete_flush`; a host bank (test stubs) fills
    ``host_embeddings`` at once."""

    ready: List["faces_mod.PendingFace"]
    tight_boxes: List[np.ndarray]
    dev_packed: Optional[torch.Tensor] = None
    nbytes: int = 0
    host_embeddings: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class ExtractCounters:
    saved_boxes: int = 0
    saved_frames: int = 0
    saved_trajectories: int = 0
    frames_processed: int = 0
    overflow: int = 0


def block_step(detector, tracker_cfg: TrackerConfig, frames: torch.Tensor,
               scene_state, tracker_state, frame0: int):
    """Scene statistics → detector → tracker over one block of frames,
    every tensor on the frames' device.

    Returns ((flags, emit, det_valid, landmarks), scene_state,
    tracker_state)."""
    flags, scene_state = scene_ops.detect_block(frames, scene_state)
    if hasattr(detector, "set_block_start"):
        detector.set_block_start(frame0)
    det = detector(frames)
    tracker_state, emit = run_block(tracker_cfg, tracker_state, det.boxes,
                                    det.valid, flags, frame0)
    return (flags, emit, det.valid, det.landmarks), scene_state, \
        tracker_state


class EmbedderBank:
    """All FaceNet checkpoints over one crop batch.

    Real banks support deferred fetches: :meth:`dispatch_crop_embed`
    leaves the embeddings on the device as one uint8 buffer, which the
    extract loop fetches with its group and restores with
    :meth:`unpack`.  Test stubs subclass it and override ``__call__``
    only (host embeddings at once)."""

    supports_deferred = False

    def __init__(self, embedders: Dict[str, FaceNetEmbedder]):
        self.embedders = embedders
        self.pooled = PooledEmbedders(list(embedders.values()))
        self.names = list(self.pooled.names)
        self.dims = [int(e.embedding_dim) for e in embedders.values()]
        self.total_dim = sum(self.dims)
        self.supports_deferred = True

    @classmethod
    def create_default(cls, device: torch.device) -> "EmbedderBank":
        """The four reference checkpoints, random-initialised from
        seeds 0..3 (no weight files ship with the repo)."""
        return cls({
            name: FaceNetEmbedder(name, FACENET_DIMS[name], device=device,
                                  seed=i)
            for i, name in enumerate(FACENET_MODELS)})

    @classmethod
    def from_weights(cls, weights_dir: str,
                     device: torch.device) -> "EmbedderBank":
        """The four checkpoints from a weights directory
        (:func:`facerec_torch.models.load.load_facenet_embedders`)."""
        return cls(load_facenet_embedders(weights_dir, device=device))

    def dispatch_packed(self, crops: torch.Tensor) -> torch.Tensor:
        """Embed a crop batch with every checkpoint, ``EMBED_BATCH``
        crops at a time, leaving the (N·total_dim·4,) uint8 buffer of
        float32 embeddings on the device."""
        return pack_tree(torch.cat([
            torch.cat(self.pooled(chunk), dim=-1).float()
            for chunk in crops.split(EMBED_BATCH)]))

    def dispatch_crop_embed(self, stack: torch.Tensor, frame_idx: np.ndarray,
                            crop_boxes: np.ndarray) -> torch.Tensor:
        """Crop + resize on the stack's device, then
        :meth:`dispatch_packed`; ``frame_idx`` and ``crop_boxes`` are
        host arrays."""
        return self.dispatch_packed(crops_of(stack, frame_idx, crop_boxes))

    def unpack(self, buf: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        """Fetched bytes → {checkpoint: (n, dim) float32}."""
        flat = np.asarray(buf).view(np.float32).reshape(-1, self.total_dim)
        split = np.split(flat[:n], np.cumsum(self.dims)[:-1], axis=-1)
        return dict(zip(self.names, split))

    def __call__(self, crops: torch.Tensor) -> Dict[str, np.ndarray]:
        """(N, 160, 160, 3) crops → {checkpoint: (N, dim) float32}, in
        one pull."""
        return self.unpack(self.dispatch_packed(crops).cpu().numpy(),
                           int(crops.shape[0]))


def crops_of(stack: torch.Tensor, frame_idx: np.ndarray,
             crop_boxes: np.ndarray) -> torch.Tensor:
    """Face crops at the embedder's input size from a device stack of
    frames; ``frame_idx`` and ``crop_boxes`` are host arrays."""
    dev = stack.device
    return crop_resize(
        stack, torch.from_numpy(np.asarray(frame_idx, np.int64)).to(dev),
        torch.from_numpy(np.asarray(crop_boxes, np.float32)).to(dev),
        FACE_IMAGE_SIZE)


class ShardConsumer:
    """Host-side state and writers of one extract shard: trajectory
    assembly, the deferred face buffer with its validity watermark, the
    pixel window for crops, batched crop+embed, and the
    feature/image/scene-change writers.  On the yuv420-delta wire the
    host window holds absolute I420 planes and the device window the
    reconstructed RGB."""

    def __init__(self, dirs: MovieDirs, movie_id: int, cfg: ExtractConfig,
                 beg: int, end: int, d_w: int, d_h: int,
                 embedders: EmbedderBank, device: torch.device,
                 jpeg_writer=None, resume_state: Optional[dict] = None):
        self.dirs = dirs
        self.movie_id = movie_id
        self.cfg = cfg
        self.beg, self.end = beg, end
        self.d_w, self.d_h = d_w, d_h
        self.embedders = embedders
        self.device = device
        self.jpeg_writer = jpeg_writer

        self.features_path = os.path.join(
            dirs.features, shard_file_name("features", movie_id, beg, end))
        self.traj_path = os.path.join(
            dirs.trajectories,
            shard_file_name("trajectories", movie_id, beg, end))
        self.sc_path = os.path.join(
            dirs.scene_changes,
            shard_file_name("scene_changes", movie_id, beg, end))

        if resume_state is None:
            self.features_file = open(self.features_path, "w")
            self.traj_file = open(self.traj_path, "w")
            self.assembler = TrajectoryAssembler(
                d_w, d_h, min_hits=cfg.min_trajectory,
                expiry_age=2 * cfg.min_trajectory)
            self.pending: List[faces_mod.PendingFace] = []
            self.pixel_window: Dict[int, np.ndarray] = {}
            self.counters = ExtractCounters()
            self.scene_changes: List[int] = []
        else:
            self.features_file = open(self.features_path, "r+")
            self.features_file.truncate(resume_state["feat_offset"])
            self.features_file.seek(resume_state["feat_offset"])
            self.traj_file = open(self.traj_path, "r+")
            self.traj_file.truncate(resume_state["traj_offset"])
            self.traj_file.seek(resume_state["traj_offset"])
            self.assembler = resume_state["assembler"]
            self.pending = resume_state["pending"]
            self.pixel_window = resume_state["pixel_window"]
            self.counters = resume_state["counters"]
            self.scene_changes = resume_state["scene_changes"]
        # device copies of the pixel window's blocks (the block step
        # already uploaded them); not checkpointed — a resumed run
        # uploads from the host window
        self.dev_window: Dict[int, torch.Tensor] = {}
        self._plans: List[FlushPlan] = []

    def feed_block(self, frame0: int, frames: np.ndarray,
                   flags: np.ndarray, emit_host: TrackEmit,
                   det_valid: np.ndarray, landmarks: np.ndarray,
                   dev_frames: Optional[torch.Tensor] = None) -> None:
        """Consume one block's pulled results."""
        det_slot, slot_uid, slot_box = (emit_host.det_slot, emit_host.uid,
                                        emit_host.box)
        self.scene_changes.extend((frame0 + np.nonzero(flags)[0]).tolist())

        for rec in self.assembler.feed(emit_host, frame0):
            records.write_trajectory(self.traj_file, rec)
            self.counters.saved_trajectories += 1
        # (frame, detection) pairs that joined a track, in frame then
        # detection order
        rows, dets = np.nonzero(det_valid[:len(frames)] & (det_slot >= 0))
        slots = det_slot[rows, dets]
        for i, d, s in zip(rows.tolist(), dets.tolist(), slots.tolist()):
            self.pending.append(faces_mod.PendingFace(
                frame=frame0 + i, uid=int(slot_uid[i, s]),
                posterior_box=slot_box[i, s].copy(),
                landmarks=landmarks[i, d]))

        self.pixel_window[frame0] = frames
        if dev_frames is not None:
            self.dev_window[frame0] = dev_frames
        self.counters.frames_processed += len(frames)

    def block_watermark(self, frame0: int, n_frames: int) -> int:
        """Faces at frames ≤ this are flushed after the block — the
        deferred-validity horizon (min_trajectory - 1 frames)."""
        return frame0 + n_frames - 1 - (self.cfg.min_trajectory - 1)

    def flush_faces(self, watermark: Optional[int]) -> None:
        """Emit features/images for pending faces with frame ≤
        watermark (None = all), in frame order."""
        self.plan_flush(watermark)
        pe = self.dispatch_flush_plans()
        if pe is not None:
            self.complete_flush(pe)

    def plan_flush(self, watermark: Optional[int]) -> Optional[FlushPlan]:
        """Select the faces ready at ``watermark`` and write their JPEG
        images — no device work; the plan queues until
        :meth:`dispatch_flush_plans`."""
        cfg = self.cfg
        due = [p for p in self.pending
               if watermark is None or p.frame <= watermark]
        later = [p for p in self.pending
                 if not (watermark is None or p.frame <= watermark)]
        # undecided tracks stay pending, ahead of later blocks' faces,
        # so features.jsonl stays in frame order
        undecided = [p for p in due
                     if self.assembler.track_valid(p.uid) is None]
        self.pending = (undecided if watermark is not None else []) + later
        ready = [p for p in due
                 if p.frame % cfg.save_every == 0
                 and self.assembler.track_valid(p.uid)]
        if not ready:
            self._trim_window()
            return None

        d_w, d_h = self.d_w, self.d_h
        tight_boxes = [round_clip_box(p.posterior_box, d_w, d_h)
                       for p in ready]
        crop_boxes = np.stack([
            faces_mod.embed_crop_box(tb, d_w, d_h) for tb in tight_boxes])

        if cfg.save_images:
            rgb_memo: Dict[int, np.ndarray] = {}
            for i, p in enumerate(ready):
                b = self._block_of(p.frame)
                frame_px = self.pixel_window[b][p.frame - b]
                if frame_px.ndim == 2:
                    # yuv420-delta: convert only the frames that save a
                    # face, with OpenCV's integer conversion
                    if p.frame not in rgb_memo:
                        rgb_memo[p.frame] = yuv_ops.i420_frame_to_rgb(
                            frame_px)
                    frame_px = rgb_memo[p.frame]
                faces_mod.save_face_image(
                    frame_px, p.posterior_box, d_w, d_h, self.dirs.images,
                    box_tag(self.movie_id, p.frame, tight_boxes[i]),
                    jpeg_writer=self.jpeg_writer)

        plan = FlushPlan(ready, tight_boxes, crop_boxes)
        self._plans.append(plan)
        self._trim_window()
        return plan

    def dispatch_flush_plans(self) -> Optional[PendingEmbed]:
        """One batched crop+embed over every queued plan, in selection
        order: one device call per fetch group."""
        plans, self._plans = self._plans, []
        if not plans:
            return None
        ready = [p for plan in plans for p in plan.ready]
        tight_boxes = [tb for plan in plans for tb in plan.tight_boxes]
        crop_boxes = np.concatenate([plan.crop_boxes for plan in plans])

        # device stack of exactly the blocks the crops reference; they
        # are on the device already unless the run resumed
        needed = sorted({self._block_of(p.frame) for p in ready})
        dev_stack = [self.dev_window[b] if b in self.dev_window
                     else self._upload(self.pixel_window[b])
                     for b in needed]
        lens = [int(d.shape[0]) for d in dev_stack]
        dev_stack = (dev_stack[0] if len(dev_stack) == 1
                     else torch.cat(dev_stack))
        offsets = {b: sum(lens[:i]) for i, b in enumerate(needed)}
        frame_idx = np.array(
            [offsets[self._block_of(p.frame)]
             + (p.frame - self._block_of(p.frame)) for p in ready], np.int64)

        # pad the crop batch to a power of two (min 16): a bounded set
        # of embed shapes; on a card to a multiple of EMBED_BATCH
        n_real = len(ready)
        if self.device.type == "cuda":
            bucket = -(-n_real // EMBED_BATCH) * EMBED_BATCH
        else:
            bucket = max(16, 1 << (n_real - 1).bit_length())
        if bucket != n_real:
            crop_boxes = np.concatenate(
                [crop_boxes, np.tile(crop_boxes[-1:], (bucket - n_real, 1))])
            frame_idx = np.concatenate(
                [frame_idx, np.full(bucket - n_real, frame_idx[-1])])

        if getattr(self.embedders, "supports_deferred", False):
            buf = self.embedders.dispatch_crop_embed(dev_stack, frame_idx,
                                                     crop_boxes)
            pe = PendingEmbed(ready, tight_boxes, dev_packed=buf,
                              nbytes=int(buf.shape[0]))
        else:
            emb = self.embedders(crops_of(dev_stack, frame_idx, crop_boxes))
            pe = PendingEmbed(ready, tight_boxes, host_embeddings={
                name: v[:n_real] for name, v in emb.items()})
        self._trim_window()
        return pe

    def _upload(self, block: np.ndarray) -> torch.Tensor:
        """A host window block as device RGB (I420 blocks are converted
        as the wire decode converts them)."""
        dev = torch.from_numpy(block).to(self.device)
        return yuv_ops.i420_to_rgb(dev, self.d_h) if block.ndim == 3 \
            else dev

    def complete_flush(self, pe: PendingEmbed,
                       buf: Optional[np.ndarray] = None) -> None:
        """Write the feature records of a dispatched flush.  ``buf`` is
        its fetched bytes (a slice of a group fetch); None pulls
        ``pe.dev_packed`` alone."""
        if pe.host_embeddings is not None:
            embeddings = pe.host_embeddings
        else:
            if buf is None:
                buf = pe.dev_packed.cpu().numpy()
            embeddings = self.embedders.unpack(buf, len(pe.ready))
        frames_seen = set()
        for i, p in enumerate(pe.ready):
            emb = {name: vecs[i].tolist()
                   for name, vecs in embeddings.items()}
            rec = faces_mod.feature_record_for(
                self.movie_id, p.frame, pe.tight_boxes[i], emb,
                p.landmarks, self.d_w, self.d_h)
            records.write_feature(self.features_file, rec)
            self.counters.saved_boxes += 1
            frames_seen.add(p.frame)
        self.counters.saved_frames += len(frames_seen)

    def _block_of(self, frame: int) -> int:
        for b in sorted(self.pixel_window, reverse=True):
            if frame >= b:
                return b
        raise KeyError(f"frame {frame} left the pixel window")

    def _trim_window(self) -> None:
        """Drop pixel-window blocks no pending face or queued plan can
        reference any more (always keeping the newest block)."""
        if not self.pixel_window:
            return
        last = max(self.pixel_window)
        refs = [p.frame for p in self.pending]
        refs.extend(p.frame for plan in self._plans for p in plan.ready)
        min_keep = min(refs, default=last)
        for b in sorted(self.pixel_window):
            if b >= last:
                break
            if b + len(self.pixel_window[b]) <= min_keep:
                del self.pixel_window[b]
                self.dev_window.pop(b, None)
            else:
                break

    def finish(self) -> ExtractCounters:
        """Final trajectories + faces, scene-change file, close files,
        mark the shard done."""
        for rec in self.assembler.finish():
            records.write_trajectory(self.traj_file, rec)
            self.counters.saved_trajectories += 1
        self.flush_faces(None)
        self.counters.overflow = self.assembler.overflow
        # cuts found in the overlap window are kept too, so the merge
        # union recovers cuts in the next shard's statistics warm-up
        records.write_shard_scene_changes(
            self.sc_path, [f for f in self.scene_changes if f >= self.beg])
        self.features_file.close()
        self.traj_file.close()
        ckpt.mark_shard_done(self.dirs.root, "extract", self.movie_id,
                             self.beg, self.end)
        return self.counters

    def snapshot(self) -> dict:
        """Checkpointable host state (file offsets after a flush)."""
        self.features_file.flush()
        self.traj_file.flush()
        return dict(assembler=self.assembler, pending=self.pending,
                    counters=self.counters,
                    scene_changes=self.scene_changes,
                    pixel_window=self.pixel_window,
                    feat_offset=self.features_file.tell(),
                    traj_offset=self.traj_file.tell())


def make_jpeg_writer(cfg: ExtractConfig):
    """The repo's native async JPEG writer (``native/libfacerec_jpeg.so``,
    the same writer the JAX package uses, so images compare byte for
    byte); None when images are off or the library does not load."""
    if not cfg.save_images:
        return None
    try:
        from facerec_torch.runtime.native import NativeJpegWriter

        return NativeJpegWriter(n_threads=2, quality=65)
    except (RuntimeError, OSError):
        return None


def build_detector(cfg: ExtractConfig, d_h: int, d_w: int,
                   detector_weights: Optional[str], device: torch.device):
    """The detector harness at native display resolution (unless the
    config asks for another input size); weights from a single-file
    Flax ``.npz`` checkpoint, else random-initialised."""
    from facerec_torch.models.detector import DetectorHarness, fit_input_size

    long_side = cfg.detector_long_side or max(d_h, d_w)
    kwargs = dict(
        input_size=(cfg.detector_size
                    or fit_input_size(d_h, d_w, long_side=long_side)),
        max_detections=cfg.max_detections,
        score_threshold=cfg.face_threshold,
        min_face_size=cfg.min_face_size)
    if detector_weights is not None:
        return DetectorHarness.from_npz(detector_weights, device=device,
                                        **kwargs)
    warn_random_init("The face detector", "--detector-weights")
    return DetectorHarness.create(backbone_width=cfg.backbone_width,
                                  device=device, **kwargs)


def build_embedders(facenet_weights: Optional[str],
                    device: torch.device) -> EmbedderBank:
    if facenet_weights is not None:
        return EmbedderBank.from_weights(facenet_weights, device)
    warn_random_init("The FaceNet embedder bank", "--facenet-weights")
    return EmbedderBank.create_default(device)


class _HostCopy:
    """One device→host copy of a uint8 buffer: on a card into pinned
    memory, started without waiting and marked by a CUDA event; on the
    CPU a plain copy."""

    def __init__(self, buf: torch.Tensor):
        self.event = self.ready = None
        if buf.device.type == "cuda":
            self.host = torch.empty(buf.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.ready = torch.cuda.Event()   # the buffer is computed
            self.ready.record()
            self.host.copy_(buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = buf.clone()

    def wait_ready(self) -> None:
        """Wait until the device has computed the buffer (not copied)."""
        if self.ready is not None:
            self.ready.synchronize()

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def fetch_group_size(cfg: ExtractConfig, n_frames: int, d_h: int,
                     d_w: int, spans: int = 1) -> int:
    """Blocks per device→host fetch: ``fetch_every_blocks``, at most
    ``checkpoint_every_blocks`` (a checkpoint waits for a collect), the
    blocks left to run, and 3 GiB of frames over the ``spans`` that run
    at once."""
    group = max(1, cfg.fetch_every_blocks)
    if cfg.checkpoint_every_blocks > 0:
        group = min(group, cfg.checkpoint_every_blocks)
    n_blocks = -(-n_frames // cfg.block_frames)
    group = max(1, min(group, n_blocks))
    step_bytes = spans * cfg.block_frames * d_h * d_w * 3
    return max(1, min(group, (3 << 30) // max(1, step_bytes)))


@dataclasses.dataclass
class SpanRun:
    """What the loop over one span reports: its counters, the blocks it
    ran, its fetch group and wire, and its per-phase wall seconds."""

    counters: ExtractCounters
    blocks: int
    group: int
    wire_format: str
    phase: Dict[str, float]


def run_span(file, info, cfg: ExtractConfig, dirs: MovieDirs, movie_id: int,
             beg: int, end: int, stop: int, detector, embedders: EmbedderBank,
             device: torch.device, spans: int = 1) -> SpanRun:
    """The serial extract loop over one span of a film on one device:
    frames [beg, end) are the span's, [end, stop) the tracker overlap
    read after it.  Resumes the span's checkpoint when ``cfg`` asks for
    it, writes its shard files and marks it done; writes no report.
    ``spans`` is how many spans run at once (they share the host's
    decode ring and the device's frame memory)."""
    d_w, d_h = info.display_width, info.display_height
    ckpt_path = os.path.join(dirs.root,
                             f".extract_{movie_id}_{beg}-{end}.ckpt")
    tracker_cfg = TrackerConfig(
        max_tracks=cfg.max_tracks, max_detections=cfg.max_detections,
        max_age=cfg.max_trajectory_age, min_hits=cfg.min_trajectory,
        iou_threshold=cfg.iou_threshold)
    tracker_state = init_tracker(tracker_cfg, device)
    scene_state = scene_ops.initial_state(d_h, d_w, crop=True,
                                          device=device)

    resume_state = ckpt.load_checkpoint(ckpt_path) if (
        cfg.resume and cfg.checkpoint_every_blocks > 0) else None
    start_frame = beg
    if resume_state is not None:
        start_frame = resume_state["next_frame"]
        scene_state = ckpt.numpy_to_tensors(resume_state["scene_state"],
                                            device)
        tracker_state = ckpt.numpy_to_tensors(
            resume_state["tracker_state"], device)
        print(f"Resuming shard {beg}-{end} at frame {start_frame}")

    group = fetch_group_size(cfg, stop - start_frame, d_h, d_w, spans)
    wire_fmt = cfg.wire_format
    if wire_fmt == "yuv420-delta" and (d_h % 2 or d_w % 2):
        print(f"wire_format=yuv420-delta needs even display dims, "
              f"got {d_w}x{d_h}; falling back to rgb", file=sys.stderr)
        wire_fmt = "rgb"
    # on the yuv420-delta wire the reader emits I420 planes and the host
    # pixel window holds them (face images convert per saved frame)
    reader = open_reader(
        file, info, cfg.block_frames, decode_workers=cfg.decode_workers,
        ring_blocks=fetch_ring_blocks(group, cfg.block_frames, d_h, d_w,
                                      budget_bytes=(2 << 30) // spans),
        pixel_format="i420" if wire_fmt == "yuv420-delta" else "rgb")
    jpeg_writer = make_jpeg_writer(cfg)
    consumer = ShardConsumer(dirs, movie_id, cfg, beg, end, d_w, d_h,
                             embedders, device, jpeg_writer,
                             resume_state=resume_state)

    # per-phase wall time, disjoint; they sum to the loop's wall time.
    # "dispatch" is the block step as the host sees it (the tracker
    # reads one scalar per frame, so it waits for the device there)
    phase = {"decode": 0.0, "encode": 0.0, "upload": 0.0, "dispatch": 0.0,
             "fetch": 0.0, "consume": 0.0, "flush_dispatch": 0.0}
    # FACEREC_PHASE_LOG: the JAX package's per-block lines on stderr
    phase_log = os.environ.get("FACEREC_PHASE_LOG", "") not in ("", "0")

    def log(msg: str) -> None:
        print(f"[phase] {msg}", file=sys.stderr, flush=True)

    def dispatch_block(frame0: int, frames: np.ndarray) -> dict:
        """Encode + upload + the block step; nothing is pulled."""
        nonlocal scene_state, tracker_state
        t0 = time.perf_counter()
        if wire_fmt != "rgb":
            frames_up = yuv_ops.encode_delta(frames)
        else:
            frames_up = frames
        t1 = time.perf_counter()
        dev = torch.from_numpy(frames_up).to(device)
        t2 = time.perf_counter()
        if phase_log and wire_fmt == "rgb":
            log(f"block upload {t2 - t1:.3f}s f0={frame0}")
        if wire_fmt == "rgb-delta":
            dev = yuv_ops.delta_decode(dev)
        elif wire_fmt == "yuv420-delta":
            dev = yuv_ops.delta_i420_to_rgb(dev, d_h)
        payload, scene_state, tracker_state = block_step(
            detector, tracker_cfg, dev, scene_state, tracker_state, frame0)
        packed = pack_tree(payload)
        t3 = time.perf_counter()
        phase["encode"] += t1 - t0
        phase["upload"] += t2 - t1
        phase["dispatch"] += t3 - t2
        if phase_log and wire_fmt != "rgb":
            log(f"block f0={frame0} encode={t1 - t0:.3f}s "
                f"upload={t2 - t1:.3f}s enqueue={t3 - t2:.3f}s")
        # the post-block device state goes with the block: dispatch runs
        # a group ahead of the files, so a checkpoint saves the state of
        # the last block consumed, not the loop's
        return {"frame0": frame0, "frames": frames, "dev": dev,
                "packed": packed, "spec": tree_spec(payload),
                "scene_state": scene_state, "tracker_state": tracker_state}

    staged: List[dict] = []        # dispatched blocks awaiting a fetch
    deferred: List[PendingEmbed] = []   # embeddings awaiting a fetch
    inflight = None                # {"copy", "deferred", "blocks"}
    blocks_done = last_ckpt_blocks = 0
    consumed_through = start_frame
    consumed_state = (scene_state, tracker_state)

    def start_fetch():
        """Concatenate the deferred embeddings and staged payloads on the
        device and start their one copy to the host."""
        nonlocal inflight, staged, deferred
        bufs = [pe.dev_packed for pe in deferred]
        bufs.extend(blk["packed"] for blk in staged)
        if not bufs:
            return
        joined = bufs[0] if len(bufs) == 1 else torch.cat(bufs)
        inflight = {"copy": _HostCopy(joined), "deferred": deferred,
                    "blocks": staged}
        if phase_log:
            log(f"start_fetch nbytes={joined.numel()} n_bufs={len(bufs)} "
                f"t={time.perf_counter():.3f}")
        staged, deferred = [], []

    def collect_fetch():
        """Wait for the group in flight; write the earlier flushes'
        features, consume the blocks, then one crop+embed for all of
        their flushes."""
        nonlocal inflight, blocks_done, consumed_through, consumed_state
        t0 = time.perf_counter()
        if phase_log:
            inflight["copy"].wait_ready()
            t_ready = time.perf_counter()
        buf = inflight["copy"].wait()
        t1 = time.perf_counter()
        if phase_log:
            log(f"collect_fetch compute_wait={t_ready - t0:.3f}s "
                f"transfer={t1 - t_ready:.3f}s nbytes={buf.size}")
        off = 0
        for pe in inflight["deferred"]:
            consumer.complete_flush(pe, buf[off:off + pe.nbytes])
            off += pe.nbytes
        for blk in inflight["blocks"]:
            n = int(blk["packed"].shape[0])
            flags, emit, det_valid, landmarks = unpack_tree(
                buf[off:off + n], *blk["spec"])
            off += n
            frame0, frames = blk["frame0"], blk["frames"]
            consumer.feed_block(frame0, frames, flags, emit, det_valid,
                                landmarks, dev_frames=blk["dev"])
            consumer.plan_flush(consumer.block_watermark(frame0,
                                                         len(frames)))
            blocks_done += 1
            consumed_through = frame0 + len(frames)
            consumed_state = (blk["scene_state"], blk["tracker_state"])
        if off != buf.size:
            raise AssertionError(f"group fetch: {off} of {buf.size} bytes")
        inflight = None
        t2 = time.perf_counter()
        pe = consumer.dispatch_flush_plans()
        t3 = time.perf_counter()
        if pe is not None:
            if pe.host_embeddings is not None:
                consumer.complete_flush(pe)
            else:
                deferred.append(pe)
        phase["fetch"] += t1 - t0
        phase["consume"] += (t2 - t1) + (time.perf_counter() - t3)
        phase["flush_dispatch"] += t3 - t2

    def maybe_checkpoint():
        nonlocal last_ckpt_blocks, deferred
        if (cfg.checkpoint_every_blocks <= 0 or blocks_done
                - last_ckpt_blocks < cfg.checkpoint_every_blocks):
            return
        # the files must hold every dispatched flush before a snapshot
        for pe in deferred:
            consumer.complete_flush(pe)
        deferred = []
        ckpt.save_checkpoint(
            ckpt_path, next_frame=consumed_through,
            scene_state=consumed_state[0], tracker_state=consumed_state[1],
            **consumer.snapshot())
        last_ckpt_blocks = blocks_done

    # Every block is dispatched as it decodes; every `group` blocks their
    # payloads (and the earlier flushes' embeddings) start one copy to
    # the host, collected when the next group is full.  Flushes stay per
    # block, so the files are the same at any group size.
    block_iter = reader.blocks(start_frame, stop, cfg.block_frames)
    try:
        with torch.inference_mode():
            while True:
                t0 = time.perf_counter()
                nxt = next(block_iter, None)
                phase["decode"] += time.perf_counter() - t0
                if phase_log:
                    log(f"decode_wait {time.perf_counter() - t0:.3f}s")
                if nxt is None:
                    break
                staged.append(dispatch_block(*nxt))
                if len(staged) >= group:
                    if inflight is not None:
                        collect_fetch()
                        maybe_checkpoint()
                    start_fetch()
            # drain: the group in flight, then the rest (a short last
            # group and the last flushes' embeddings)
            while inflight is not None or staged or deferred:
                if inflight is not None:
                    collect_fetch()
                    maybe_checkpoint()
                start_fetch()
            counters = consumer.finish()
    finally:
        reader.close()
        if jpeg_writer is not None:
            jpeg_writer.close()   # drains the async write queue

    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    return SpanRun(counters, blocks_done, group, wire_fmt, phase)


def run_extract(
    file,
    cfg: ExtractConfig,
    out_path: str,
    detector: Optional[Callable] = None,
    embedders: Optional[EmbedderBank] = None,
    aspect_csv: str = "aspect_ratios.csv",
    detector_weights: Optional[str] = None,
    facenet_weights: Optional[str] = None,
    device=None,
) -> ExtractCounters:
    """Process one shard of a film (the whole film when n_shards=1).

    ``file`` is a film path, or an in-memory clip
    (:func:`facerec_torch.video.synth.make_frames` or
    :func:`~facerec_torch.video.synth.paint_frames`) for hosts that
    cannot decode video.  ``device`` is resolved by
    :func:`~facerec_torch.runtime.device.resolve_device`: the card, or
    the CPU only when asked for.  A given ``detector`` and
    ``embedders`` must already live on that device.
    """
    if not 0 <= cfg.shard_i < cfg.n_shards:
        raise ValueError("Bad shard index.")
    check_wire_format(cfg)
    device = resolve_device(device)
    use_full_float32()

    name, info = film_info(file, cfg, aspect_csv)
    d_w, d_h = info.display_width, info.display_height

    movie_id = movie_id_from_filename(name)
    dirs = MovieDirs.create(out_path, movie_id)

    shard_len = (info.n_frames + cfg.n_shards - 1) // cfg.n_shards
    beg = shard_len * cfg.shard_i
    end = min(beg + shard_len, info.n_frames)
    end_overlap = min(end + cfg.max_trajectory_age, info.n_frames)

    print(f"Movie file: {os.path.basename(name)}")
    print(f"Total length: {(info.n_frames / info.fps / 3600):.1f}h "
          f"({info.fps} fps)")
    print(f"Storage resolution for film: "
          f"{info.storage_width}x{info.storage_height}")
    print(f"Used display resolution for film: {d_w}x{d_h}")
    print(f"Shard {cfg.shard_i + 1} / {cfg.n_shards}, len: {shard_len} "
          f"frames")
    print(f"Processing frames: {beg} - {end} (max: {info.n_frames}) "
          f"saving every 1/{cfg.save_every} frames")
    print(f"Device: {device}")

    report = StageReport(f"extract_{beg}-{end}", device)
    if cfg.resume and ckpt.is_shard_done(dirs.root, "extract", movie_id,
                                         beg, end):
        print(f"Shard {beg}-{end} already complete; skipping.")
        return ExtractCounters()

    if detector is None:
        detector = build_detector(cfg, d_h, d_w, detector_weights, device)
    if embedders is None:
        embedders = build_embedders(facenet_weights, device)

    run = run_span(file, info, cfg, dirs, movie_id, beg, end, end_overlap,
                   detector, embedders, device)
    counters = run.counters
    for key, value in dataclasses.asdict(counters).items():
        report.set(key, value)
    report.set("blocks", run.blocks)
    report.set("fetch_group", run.group)
    report.set("wire_format", run.wire_format)
    report.set("encode_path", yuv_ops.encode_path()
               if run.wire_format != "rgb" else None)
    for key, value in run.phase.items():
        report.set(f"{key}_seconds", round(value, 3))
    report.write(dirs.root)

    print(f"Saved {counters.saved_boxes} boxes from "
          f"{counters.saved_frames} different frames")
    print(f"and {counters.saved_trajectories} trajectories.")
    if counters.overflow:
        print(f"WARNING: {counters.overflow} detections dropped at "
              f"track-capacity limit.")
    return counters


def check_wire_format(cfg: ExtractConfig) -> None:
    if cfg.wire_format not in WIRE_FORMATS:
        raise ValueError(f"unknown wire_format {cfg.wire_format!r}; one of "
                         f"{WIRE_FORMATS}")


def film_info(file, cfg: ExtractConfig, aspect_csv: str):
    """(name, VideoInfo) of a film path or in-memory clip, at the
    display size ``aspect_csv`` or ``cfg`` gives it."""
    name = file if isinstance(file, (str, os.PathLike)) else file.path
    display = load_aspect_ratio_csv(aspect_csv, os.path.basename(name))
    if cfg.display_width is not None and cfg.display_height is not None:
        display = (cfg.display_width, cfg.display_height)
    return source_info(file, display)


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card) or cpu")
    parser.add_argument("--n-shards", type=int, default=1)
    parser.add_argument("--shard-i", type=int, default=0)
    parser.add_argument("--save-every", type=int, default=5)
    parser.add_argument("--iou-threshold", type=float, default=0.5)
    parser.add_argument("--min-trajectory", type=int, default=3)
    parser.add_argument("--max-trajectory-age", type=int, default=5)
    parser.add_argument("--min-face-size", type=int, default=20)
    parser.add_argument("--face-threshold", type=float, default=0.95)
    parser.add_argument("--out-path", type=str, default="./data")
    parser.add_argument("--no-images", action="store_true")
    parser.add_argument("--block-frames", type=int,
                        default=ExtractConfig.block_frames)
    parser.add_argument("--decode-workers", type=int, default=0,
                        help="parallel native decode workers "
                             "(0 = FACEREC_DECODE_WORKERS or sequential)")
    parser.add_argument("--fetch-every-blocks", type=int,
                        default=ExtractConfig.fetch_every_blocks,
                        help="copy the results of N blocks to the host "
                             "in one transfer (output bytes are the same "
                             "at any N)")
    parser.add_argument("--wire-format", type=str, default="rgb",
                        choices=list(WIRE_FORMATS),
                        help="host→device pixel format.  rgb-delta ships "
                             "uint8 temporal deltas, undone exactly on "
                             "the device (the same output bytes as rgb); "
                             "yuv420-delta ships 4:2:0 planes (half the "
                             "bytes) at a few LSB of chroma in the "
                             "device's crops and features")
    parser.add_argument("--mesh", type=int, default=0,
                        help="process N temporal shard spans at once, one "
                             "process per device: the first N cards, or N "
                             "CPU processes with --device cpu (0/1 = one "
                             "device); writes the shard files of "
                             "--n-shards N")
    parser.add_argument("--detector-long-side", type=int, default=0,
                        help="AR-fitted detector input long side; 0 = "
                             "native display resolution")
    parser.add_argument("--backbone-width", type=int, default=96,
                        help="detector width for random-init runs "
                             "(checkpoints carry their own)")
    parser.add_argument("--detector-weights", type=str, default=None,
                        help="single-file Flax .npz detector checkpoint; "
                             "random init + warning if omitted")
    parser.add_argument("--facenet-weights", type=str, default=None,
                        help="directory with the four FaceNet checkpoints "
                             "(<name>.pt, <name>.h5, <name>.npz or "
                             "<name>/model.h5); random init + warning "
                             "if omitted")
    parser.add_argument("file")
    args = parser.parse_args(argv)

    start = time.time()
    cfg = ExtractConfig(
        n_shards=args.n_shards, shard_i=args.shard_i,
        save_every=args.save_every, iou_threshold=args.iou_threshold,
        min_trajectory=args.min_trajectory,
        max_trajectory_age=args.max_trajectory_age,
        min_face_size=args.min_face_size,
        face_threshold=args.face_threshold,
        save_images=not args.no_images, block_frames=args.block_frames,
        decode_workers=args.decode_workers,
        fetch_every_blocks=args.fetch_every_blocks,
        wire_format=args.wire_format,
        detector_long_side=args.detector_long_side or None,
        backbone_width=args.backbone_width)
    if args.mesh > 1:
        from facerec_torch.parallel.extract_mesh import run_extract_mesh
        from facerec_torch.parallel.mesh import mesh_devices

        run_extract_mesh(args.file, cfg, args.out_path.rstrip("/"),
                         devices=mesh_devices(args.mesh, args.device),
                         detector_weights=args.detector_weights,
                         facenet_weights=args.facenet_weights)
    else:
        run_extract(args.file, cfg, args.out_path.rstrip("/"),
                    detector_weights=args.detector_weights,
                    facenet_weights=args.facenet_weights,
                    device=args.device)
    minutes, seconds = divmod(time.time() - start, 60)
    print(f"Completed in {int(minutes)} minutes, {int(seconds)} seconds.")


if __name__ == "__main__":
    main()
