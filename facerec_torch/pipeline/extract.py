"""Extract stage: decode → scene → detect → track → embed → contract files.

Port of ``facerec_tpu/pipeline/extract.py`` on one device with the
plain ``rgb`` wire.  The film streams through the device in frame
blocks:

  host    decode block (B, H, W, 3)              [native C++ / OpenCV]
  device  scene statistics (CUDA kernels hist256 + cum_lookup on a card)
  device  detector forward + decode + top-k + greedy NMS
  device  tracker over the block's frames
  host    pull the block's flags, emissions and detections
  host    trajectory assembly + the deferred face buffer
  device  crop + resize + all four FaceNet checkpoints
  host    trajectory/feature/scene-change writers

Cross-block carry is the scene state and the tracker table, both on the
device.  Each block's results are pulled to the host before the next
block; the JAX package's grouped fetches and delta wire formats are not
ported (bytes are the same at any fetch grouping), and neither is
``--mesh``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
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
from facerec_torch.ops.boxes import round_clip_box
from facerec_torch.ops.crops import crop_resize
from facerec_torch.pipeline import faces as faces_mod
from facerec_torch.runtime import checkpoint as ckpt
from facerec_torch.runtime.device import resolve_device, use_full_float32
from facerec_torch.runtime.metrics import StageReport
from facerec_torch.track import (TrackEmit, TrackerConfig,
                                 TrajectoryAssembler, init_tracker,
                                 run_block)
from facerec_torch.video.reader import load_aspect_ratio_csv, open_source


@dataclasses.dataclass
class FlushPlan:
    """One block-flush's face selection, before any device work."""

    ready: List["faces_mod.PendingFace"]
    tight_boxes: List[np.ndarray]
    crop_boxes: np.ndarray


@dataclasses.dataclass
class PendingEmbed:
    """The embedded faces of one flush, ready to be written."""

    ready: List["faces_mod.PendingFace"]
    tight_boxes: List[np.ndarray]
    embeddings: Dict[str, np.ndarray]


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

    Test stubs subclass it and override ``__call__`` only."""

    def __init__(self, embedders: Dict[str, FaceNetEmbedder]):
        self.embedders = embedders
        self.pooled = PooledEmbedders(list(embedders.values()))
        self.dims = [int(e.embedding_dim) for e in embedders.values()]

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

    def dispatch_crop_embed(self, stack: torch.Tensor, frame_idx: np.ndarray,
                            crop_boxes: np.ndarray) -> Dict[str, np.ndarray]:
        """Crop + resize on the stack's device, then embed; ``frame_idx``
        and ``crop_boxes`` are host arrays."""
        dev = stack.device
        crops = crop_resize(
            stack, torch.from_numpy(np.asarray(frame_idx, np.int64)).to(dev),
            torch.from_numpy(np.asarray(crop_boxes, np.float32)).to(dev),
            FACE_IMAGE_SIZE)
        return self(crops)

    def __call__(self, crops: torch.Tensor) -> Dict[str, np.ndarray]:
        """(N, 160, 160, 3) crops → {checkpoint: (N, dim) float32}; the
        checkpoints' embeddings come back in one pull."""
        flat = torch.cat(self.pooled(crops), dim=-1).cpu().numpy()
        split = np.split(flat, np.cumsum(self.dims)[:-1], axis=-1)
        return dict(zip(self.pooled.names, split))


class ShardConsumer:
    """Host-side state and writers of one extract shard: trajectory
    assembly, the deferred face buffer with its validity watermark, the
    pixel window for crops, batched crop+embed, and the
    feature/image/scene-change writers."""

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
            for i, p in enumerate(ready):
                b = self._block_of(p.frame)
                faces_mod.save_face_image(
                    self.pixel_window[b][p.frame - b], p.posterior_box,
                    d_w, d_h, self.dirs.images,
                    box_tag(self.movie_id, p.frame, tight_boxes[i]),
                    jpeg_writer=self.jpeg_writer)

        plan = FlushPlan(ready, tight_boxes, crop_boxes)
        self._plans.append(plan)
        self._trim_window()
        return plan

    def dispatch_flush_plans(self) -> Optional[PendingEmbed]:
        """One batched crop+embed over every queued plan, in selection
        order."""
        plans, self._plans = self._plans, []
        if not plans:
            return None
        ready = [p for plan in plans for p in plan.ready]
        tight_boxes = [tb for plan in plans for tb in plan.tight_boxes]
        crop_boxes = np.concatenate([plan.crop_boxes for plan in plans])

        # device stack of exactly the blocks the crops reference
        needed = sorted({self._block_of(p.frame) for p in ready})
        dev_stack = [self.dev_window[b] if b in self.dev_window
                     else torch.from_numpy(self.pixel_window[b]).to(
                         self.device)
                     for b in needed]
        lens = [int(d.shape[0]) for d in dev_stack]
        dev_stack = (dev_stack[0] if len(dev_stack) == 1
                     else torch.cat(dev_stack))
        offsets = {b: sum(lens[:i]) for i, b in enumerate(needed)}
        frame_idx = np.array(
            [offsets[self._block_of(p.frame)]
             + (p.frame - self._block_of(p.frame)) for p in ready], np.int64)

        # pad the crop batch to a power of two (min 16): a bounded set
        # of embed shapes
        n_real = len(ready)
        bucket = max(16, 1 << (n_real - 1).bit_length())
        if bucket != n_real:
            crop_boxes = np.concatenate(
                [crop_boxes, np.tile(crop_boxes[-1:], (bucket - n_real, 1))])
            frame_idx = np.concatenate(
                [frame_idx, np.full(bucket - n_real, frame_idx[-1])])

        emb = self.embedders.dispatch_crop_embed(dev_stack, frame_idx,
                                                 crop_boxes)
        self._trim_window()
        return PendingEmbed(ready, tight_boxes,
                            {name: v[:n_real] for name, v in emb.items()})

    def complete_flush(self, pe: PendingEmbed) -> None:
        """Write the feature records of an embedded flush."""
        frames_seen = set()
        for i, p in enumerate(pe.ready):
            emb = {name: vecs[i].tolist()
                   for name, vecs in pe.embeddings.items()}
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


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


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
    (:func:`facerec_torch.video.synth.make_frames`) for hosts that
    cannot decode video.  ``device`` is resolved by
    :func:`~facerec_torch.runtime.device.resolve_device`: the card, or
    the CPU only when asked for.  A given ``detector`` and
    ``embedders`` must already live on that device.
    """
    if not 0 <= cfg.shard_i < cfg.n_shards:
        raise ValueError("Bad shard index.")
    if cfg.wire_format != "rgb":
        raise NotImplementedError(
            f"wire_format={cfg.wire_format!r} is not ported; use 'rgb'")
    device = resolve_device(device)
    use_full_float32()

    name = file if isinstance(file, (str, os.PathLike)) else file.path
    display = load_aspect_ratio_csv(aspect_csv, os.path.basename(name))
    if cfg.display_width is not None and cfg.display_height is not None:
        display = (cfg.display_width, cfg.display_height)
    name, info, reader = open_source(file, display, cfg.block_frames)
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
    ckpt_path = os.path.join(dirs.root,
                             f".extract_{movie_id}_{beg}-{end}.ckpt")
    if cfg.resume and ckpt.is_shard_done(dirs.root, "extract", movie_id,
                                         beg, end):
        print(f"Shard {beg}-{end} already complete; skipping.")
        reader.close()
        return ExtractCounters()

    if detector is None:
        detector = build_detector(cfg, d_h, d_w, detector_weights, device)
    if embedders is None:
        embedders = build_embedders(facenet_weights, device)

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

    jpeg_writer = make_jpeg_writer(cfg)
    consumer = ShardConsumer(dirs, movie_id, cfg, beg, end, d_w, d_h,
                             embedders, device, jpeg_writer,
                             resume_state=resume_state)

    # per-phase wall time.  "dispatch" is the block step as the host
    # sees it (the tracker reads one scalar per frame, so it waits for
    # the device there); "fetch" is the pull of the block's results
    phase = {"decode": 0.0, "upload": 0.0, "dispatch": 0.0, "fetch": 0.0,
             "consume": 0.0, "embed": 0.0}
    blocks_done = 0
    block_iter = reader.blocks(start_frame, end_overlap, cfg.block_frames)
    with torch.inference_mode():
        while True:
            t0 = time.perf_counter()
            nxt = next(block_iter, None)
            t1 = time.perf_counter()
            phase["decode"] += t1 - t0
            if nxt is None:
                break
            frame0, frames = nxt
            dev_frames = torch.from_numpy(frames).to(device)
            t2 = time.perf_counter()
            phase["upload"] += t2 - t1
            payload, scene_state, tracker_state = block_step(
                detector, tracker_cfg, dev_frames, scene_state,
                tracker_state, frame0)
            t3 = time.perf_counter()
            phase["dispatch"] += t3 - t2
            flags, emit, det_valid, landmarks = payload
            flags, det_valid, landmarks = map(
                _to_host, (flags, det_valid, landmarks))
            emit = TrackEmit(*map(_to_host, emit))
            t4 = time.perf_counter()
            phase["fetch"] += t4 - t3
            consumer.feed_block(frame0, frames, flags, emit, det_valid,
                                landmarks, dev_frames=dev_frames)
            consumer.plan_flush(consumer.block_watermark(frame0,
                                                         len(frames)))
            t5 = time.perf_counter()
            phase["consume"] += t5 - t4
            pe = consumer.dispatch_flush_plans()
            if pe is not None:
                consumer.complete_flush(pe)
            phase["embed"] += time.perf_counter() - t5
            blocks_done += 1
            if (cfg.checkpoint_every_blocks > 0
                    and blocks_done % cfg.checkpoint_every_blocks == 0):
                ckpt.save_checkpoint(
                    ckpt_path, next_frame=frame0 + len(frames),
                    scene_state=scene_state, tracker_state=tracker_state,
                    **consumer.snapshot())
        counters = consumer.finish()
    reader.close()
    if jpeg_writer is not None:
        jpeg_writer.close()   # drains the async write queue

    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    for key, value in dataclasses.asdict(counters).items():
        report.set(key, value)
    report.set("blocks", blocks_done)
    for key, value in phase.items():
        report.set(f"{key}_seconds", round(value, 3))
    report.write(dirs.root)

    print(f"Saved {counters.saved_boxes} boxes from "
          f"{counters.saved_frames} different frames")
    print(f"and {counters.saved_trajectories} trajectories.")
    if counters.overflow:
        print(f"WARNING: {counters.overflow} detections dropped at "
              f"track-capacity limit.")
    return counters


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
        detector_long_side=args.detector_long_side or None,
        backbone_width=args.backbone_width)
    run_extract(args.file, cfg, args.out_path.rstrip("/"),
                detector_weights=args.detector_weights,
                facenet_weights=args.facenet_weights, device=args.device)
    minutes, seconds = divmod(time.time() - start, 60)
    print(f"Completed in {int(minutes)} minutes, {int(seconds)} seconds.")


if __name__ == "__main__":
    main()
