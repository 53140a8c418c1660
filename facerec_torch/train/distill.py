"""Detector distillation from reference-produced detections.

Port of ``facerec_tpu/train/distill.py``.  The reference's pretrained
MTCNN cannot be translated into the single-stage FPN+SSH detector
weight for weight; the parity path is distillation: train the detector
on a reference run's detections (its ``features.jsonl`` carries the
boxes and 5-point keypoints) over the film's decoded frames.

Truth formats accepted (per record):
  - ``{"frame": i, "box": [x1,y1,x2,y2]}`` — detector dumps;
  - full feature records with ``keypoints`` — then the landmark head
    trains too.

Frames are decoded with the port's OpenCV reader
(:class:`facerec_torch.video.reader.VideoReader`) at display resolution,
and letterboxed with OpenCV's resize: distillation runs where OpenCV is
installed.

Run:
  python -m facerec_torch.train.distill \\
      --film 125261-Name.mp4 --truth ref-data/features.jsonl \\
      --steps 4000 --out detector.npz
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from facerec_torch.train.widerface import (fit_detector, letterbox,
                                           npz_path, recalibrate_on)

KEYPOINT_NAMES = ("left_eye", "right_eye", "nose", "mouth_left",
                  "mouth_right")


def load_truth(path: str) -> Dict[int, List[Tuple[np.ndarray,
                                                  Optional[np.ndarray]]]]:
    """JSONL → frame → [(box xyxy f32, landmarks (5,2) f32 or None)]."""
    truth: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            box = np.asarray(rec["box"], np.float32)
            lm = None
            kp = rec.get("keypoints")
            if kp and all(k in kp for k in KEYPOINT_NAMES):
                lm = np.asarray([kp[k] for k in KEYPOINT_NAMES],
                                np.float32)
            truth.setdefault(int(rec["frame"]), []).append((box, lm))
    return truth


class DistillDataset:
    """Letterboxed training batches from a film + truth detections.

    Frames with truth are decoded once per epoch (streaming: a film does
    not fit in memory) and letterboxed into the detector input as
    :class:`~facerec_torch.models.detector.DetectorHarness` letterboxes
    at deploy time, with ``content_hw`` marking the padded area.  Small
    runs are cached in memory (``cache_frames``) so later epochs skip
    the decode.
    """

    def __init__(self, film: str, truth: Dict[int, list],
                 input_size: Tuple[int, int], max_boxes: int = 32,
                 cache_frames: int = 4096):
        self.film = film
        self.truth = {f: v for f, v in truth.items() if v}
        self.input_size = input_size
        self.max_boxes = max_boxes
        self.cache_frames = cache_frames
        self._cache: Optional[Dict[int, tuple]] = None
        self.use_landmarks = all(
            lm is not None for recs in self.truth.values()
            for _, lm in recs)

    def __len__(self) -> int:
        return len(self.truth)

    def _letterbox(self, img: np.ndarray, frame: int) -> tuple:
        canvas, scale, (sh, sw) = letterbox(img, self.input_size)
        m = self.max_boxes
        boxes = np.zeros((m, 4), np.float32)
        valid = np.zeros((m,), bool)
        lms = np.zeros((m, 5, 2), np.float32)
        for k, (box, lm) in enumerate(self.truth[frame][:m]):
            boxes[k] = box * scale
            valid[k] = True
            if lm is not None:
                lms[k] = lm * scale
        return canvas, boxes, valid, lms, np.array([sh, sw], np.int32)

    def _samples(self):
        """Yield (frame, letterboxed tuple) for every truth frame, in
        frame order, decoding the film once."""
        if self._cache is not None:
            for f in sorted(self._cache):
                yield f, self._cache[f]
            return
        from facerec_torch.video.reader import VideoReader, probe_video

        wanted = set(self.truth)
        cache: Optional[Dict[int, tuple]] = (
            {} if len(wanted) <= self.cache_frames else None)
        reader = VideoReader(self.film, probe_video(self.film, None))
        try:
            for f0, block in reader.blocks(0, max(wanted) + 1, 64):
                for i, frame in enumerate(block):
                    if f0 + i in wanted:
                        sample = self._letterbox(frame, f0 + i)
                        if cache is not None:
                            cache[f0 + i] = sample
                        yield f0 + i, sample
        finally:
            reader.close()
        if cache is not None:
            self._cache = cache

    def batches(self, batch_size: int, rng: np.random.Generator):
        """Endless batches: (ims u8, boxes, valid, landmarks,
        content_hw).  Within an epoch samples stream in frame order;
        batch composition is randomised by a shuffled carry-over
        pool."""
        pool: List[tuple] = []
        while True:
            for _f, sample in self._samples():
                pool.append(sample)
                if len(pool) >= 4 * batch_size:
                    rng.shuffle(pool)
                    batch, pool = pool[:batch_size], pool[batch_size:]
                    yield self._stack(batch)
            while len(pool) >= batch_size:
                rng.shuffle(pool)
                batch, pool = pool[:batch_size], pool[batch_size:]
                yield self._stack(batch)

    @staticmethod
    def _stack(batch):
        ims, bxs, vds, lms, chw = zip(*batch)
        return (np.stack(ims), np.stack(bxs), np.stack(vds),
                np.stack(lms), np.stack(chw))


def distill(film: str, truth_path: str, out: str, steps: int,
            batch_size: int = 16,
            input_size: Optional[Tuple[int, int]] = None,
            long_side: int = 512, learning_rate: float = 1e-3,
            init_weights: Optional[str] = None, seed: int = 0,
            log_every: int = 50,
            model_kwargs: Optional[dict] = None,
            recalibrate: bool = True, device=None) -> list:
    """Train the detector toward the reference's detections and write
    ``out`` (a single-file ``.npz``, suffix added) for
    ``--detector-weights``, with its model arguments in
    ``<out>.model.json``.  ``init_weights``: a ``.npz`` to start from.
    Returns the loss history."""
    import torch

    from facerec_torch.models import convert
    from facerec_torch.models.detector import FaceDetector, fit_input_size
    from facerec_torch.models.layers import init_weights as random_init
    from facerec_torch.train.detector_train import DetectorTrainer
    from facerec_torch.video.reader import probe_video

    truth = load_truth(truth_path)
    if input_size is None:
        info = probe_video(film, None)
        input_size = fit_input_size(info.display_height,
                                    info.display_width,
                                    long_side=long_side)
    ds = DistillDataset(film, truth, input_size=input_size)
    if len(ds) == 0:
        raise RuntimeError(f"no truth frames found in {truth_path}")

    model = FaceDetector(**(model_kwargs or {}))
    if init_weights is not None:
        model.load_state_dict(convert.detector_state_dict(
            convert.load_flax_npz(init_weights)))
    else:
        random_init(model, torch.Generator().manual_seed(seed))
    trainer = DetectorTrainer(model, input_size=input_size,
                              learning_rate=learning_rate,
                              use_landmarks=ds.use_landmarks, device=device)
    print(f"distill: {len(ds)} truth frames, input {input_size}, "
          f"landmarks={'on' if ds.use_landmarks else 'off'}, "
          f"device {trainer.device}")
    losses = fit_detector(trainer, ds.batches(
        batch_size, np.random.default_rng(seed)), steps, log_every)
    if recalibrate:
        recalibrate_on(trainer, ds.batches(
            batch_size, np.random.default_rng(seed + 99)))
    path = npz_path(out)
    convert.save_params_npz(path, trainer.model)
    # the model arguments beside the weights (the width is also read
    # back from the stem kernel)
    with open(path[:-len(".npz")] + ".model.json", "w") as f:
        json.dump(model_kwargs or {}, f)
    print(f"saved distilled detector checkpoint to {path}")
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--film", required=True)
    parser.add_argument("--truth", required=True,
                        help="reference detections JSONL (features.jsonl "
                             "works directly)")
    parser.add_argument("--out", default="./detector.npz")
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--long-side", type=int, default=512,
                        help="AR-fitted detector input long side "
                             "(match the deploy setting)")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--init-weights", default=None,
                        help="warm-start from a single-file .npz "
                             "checkpoint (e.g. a WIDER-FACE pretrain)")
    parser.add_argument("--backbone-width", type=int, default=96,
                        help="detector backbone width (read back from "
                             "the checkpoint's stem)")
    parser.add_argument("--no-recalibrate", dest="recalibrate",
                        action="store_false",
                        help="skip the post-training BN running-stat "
                             "recalibration on film batches")
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card) or cpu")
    args = parser.parse_args(argv)
    distill(args.film, args.truth, args.out, args.steps, args.batch,
            long_side=args.long_side, learning_rate=args.lr,
            init_weights=args.init_weights,
            model_kwargs={"backbone_width": args.backbone_width},
            recalibrate=args.recalibrate, device=args.device)


if __name__ == "__main__":
    main()
