"""WIDER-FACE detector training on real data.

Port of ``facerec_tpu/train/widerface.py``: parses the dataset's
annotation format (``wider_face_train_bbx_gt.txt``: an image path line,
a face-count line, then one ``x y w h blur expression illumination
invalid occlusion pose`` line per face — a count of 0 is followed by a
single all-zero line), feeds letterboxed batches to
:class:`~facerec_torch.train.detector_train.DetectorTrainer` (landmark
head untrained: bbx_gt has no landmarks), and writes a single-file
``.npz`` checkpoint for ``extract --detector-weights``.  Reading the
images needs OpenCV (imported when an image is loaded).

Run:
  python -m facerec_torch.train.widerface \\
      --root WIDER_train/images \\
      --ann wider_face_split/wider_face_train_bbx_gt.txt \\
      --steps 20000 --out detector.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    path: str
    boxes: np.ndarray        # (G, 4) float32 xyxy, pixel coords
    invalid: np.ndarray      # (G,) bool — annotation's invalid flag


def parse_bbx_gt(ann_file: str) -> List[Sample]:
    """Parse the WIDER bbx_gt annotation format."""
    samples = []
    with open(ann_file) as f:
        lines = [l.rstrip("\n") for l in f]
    i = 0
    while i < len(lines):
        path = lines[i].strip()
        if not path:
            i += 1
            continue
        count = int(lines[i + 1].strip())
        rows = lines[i + 2:i + 2 + max(count, 1)]
        i += 2 + max(count, 1)
        boxes, invalid = [], []
        for row in rows[:count]:
            vals = [int(v) for v in row.split()[:10]]
            x, y, w, h = vals[:4]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            invalid.append(bool(vals[7]) if len(vals) > 7 else False)
        samples.append(Sample(
            path,
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(invalid, bool).reshape(-1)))
    return samples


def letterbox(img: np.ndarray, input_size: Tuple[int, int]):
    """(H, W, 3) uint8 → (the image scaled by min(ih/H, iw/W) with
    OpenCV's bilinear resize into the top-left of a zero (ih, iw, 3)
    canvas, the scale, the content (sh, sw))."""
    import cv2

    h, w = img.shape[:2]
    ih, iw = input_size
    scale = min(ih / h, iw / w)
    sh, sw = int(round(h * scale)), int(round(w * scale))
    canvas = np.zeros((ih, iw, 3), np.uint8)
    canvas[:sh, :sw] = cv2.resize(np.ascontiguousarray(img), (sw, sh))
    return canvas, scale, (sh, sw)


class WiderFaceDataset:
    """Letterboxed training batches from a WIDER-FACE directory tree."""

    def __init__(self, images_root: str, ann_file: str,
                 input_size: Tuple[int, int] = (640, 640),
                 max_boxes: int = 32, min_face: float = 8.0):
        self.images_root = images_root
        self.input_size = input_size
        self.max_boxes = max_boxes
        self.min_face = min_face
        self.samples = [s for s in parse_bbx_gt(ann_file)
                        if len(s.boxes)]

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, idx: int):
        """→ (image (ih, iw, 3) uint8 RGB letterboxed, boxes (M, 4),
        valid (M,), content_hw (2,) int32) with M = max_boxes padding;
        ``content_hw`` (sh, sw) lets the trainer label anchors centred
        on the padding negative."""
        import cv2

        s = self.samples[idx]
        img = cv2.imread(os.path.join(self.images_root, s.path),
                         cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(s.path)
        canvas, scale, (sh, sw) = letterbox(img[..., ::-1], self.input_size)

        boxes = s.boxes * scale
        wh = np.minimum(boxes[:, 2] - boxes[:, 0],
                        boxes[:, 3] - boxes[:, 1])
        keep = (~s.invalid) & (wh >= self.min_face)
        boxes = boxes[keep][:self.max_boxes]

        m = self.max_boxes
        out_boxes = np.zeros((m, 4), np.float32)
        out_valid = np.zeros((m,), bool)
        out_boxes[:len(boxes)] = boxes
        out_valid[:len(boxes)] = True
        return (canvas, out_boxes, out_valid,
                np.array([sh, sw], np.int32))

    def batches(self, batch_size: int, rng: np.random.Generator
                ) -> Iterator[tuple]:
        """Endless shuffled batches:
        (images (B,ih,iw,3) u8, boxes (B,M,4), valid (B,M),
        landmarks zeros (B,M,5,2), content_hw (B,2) i32)."""
        order = np.arange(len(self.samples))
        while True:
            rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                idxs = order[i:i + batch_size]
                ims, bxs, vds, chw = zip(*(self.load(j) for j in idxs))
                yield (np.stack(ims), np.stack(bxs), np.stack(vds),
                       np.zeros((batch_size, self.max_boxes, 5, 2),
                                np.float32),
                       np.stack(chw))


def npz_path(out: str) -> str:
    """``out`` as the single-file checkpoint the port writes."""
    out = os.path.abspath(out)
    return out if out.endswith(".npz") else out + ".npz"


def fit_detector(trainer, batches, steps: int, log_every: int = 50) -> list:
    """``steps`` trainer steps over ``batches`` of (images, boxes, valid,
    landmarks, content_hw); returns the loss of every step."""
    losses = []
    for step, (ims, bxs, vds, ldm, chw) in enumerate(batches):
        if step >= steps:
            break
        losses.append(float(trainer.step(ims, bxs, vds, ldm,
                                          content_hw=chw)))
        if step % log_every == 0:
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    return losses


def recalibrate_on(trainer, batches, n: int = 32) -> None:
    """The post-training BN refresh on ``n`` dataset batches through the
    same letterbox (train/recalibrate.py, docs/DESIGN.md "BN
    recalibration"): short budgets otherwise deploy with statistics
    still ~0.995^steps anchored to their initialisation."""
    import torch

    from facerec_torch.models.detector import normalize_images
    from facerec_torch.train.recalibrate import recalibrate_batch_stats

    dev = trainer.device
    print("recalibrating BN statistics on dataset batches", flush=True)
    recalibrate_batch_stats(
        trainer.model, (next(batches)[0] for _ in range(n)),
        lambda m, x: m(normalize_images(torch.as_tensor(x, device=dev))))


def train(images_root: str, ann_file: str, out: str, steps: int,
          batch_size: int = 16, input_size: Tuple[int, int] = (640, 640),
          learning_rate: float = 1e-3, seed: int = 0,
          log_every: int = 50, recalibrate: bool = True,
          device=None) -> list:
    """Train the detector on WIDER-FACE data and write ``out`` (a
    single-file ``.npz``, suffix added) for ``--detector-weights``.
    Returns the loss history."""
    import torch

    from facerec_torch.models.convert import save_params_npz
    from facerec_torch.models.detector import FaceDetector
    from facerec_torch.models.layers import init_weights
    from facerec_torch.train.detector_train import DetectorTrainer

    model = FaceDetector()
    init_weights(model, torch.Generator().manual_seed(seed))
    trainer = DetectorTrainer(model, input_size=input_size,
                              learning_rate=learning_rate,
                              use_landmarks=False, device=device)
    ds = WiderFaceDataset(images_root, ann_file, input_size=input_size)
    if len(ds) < batch_size:
        raise RuntimeError(
            f"only {len(ds)} annotated images under {ann_file}")
    print(f"WIDER-FACE: {len(ds)} images, input {input_size}, "
          f"device {trainer.device}")
    losses = fit_detector(trainer, ds.batches(
        batch_size, np.random.default_rng(seed)), steps, log_every)
    if recalibrate:
        recalibrate_on(trainer, ds.batches(
            batch_size, np.random.default_rng(seed + 99)))
    path = npz_path(out)
    save_params_npz(path, trainer.model)
    print(f"saved detector checkpoint to {path}")
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--root", required=True,
                        help="WIDER images root (contains event dirs)")
    parser.add_argument("--ann", required=True,
                        help="wider_face_*_bbx_gt.txt annotation file")
    parser.add_argument("--out", default="./detector.npz")
    parser.add_argument("--steps", type=int, default=20000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=640)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--no-recalibrate", dest="recalibrate",
                        action="store_false",
                        help="skip the post-training BN statistics "
                             "recalibration on dataset batches")
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card) or cpu")
    args = parser.parse_args(argv)
    train(args.root, args.ann, args.out, args.steps, args.batch,
          (args.size, args.size), args.lr,
          recalibrate=args.recalibrate, device=args.device)


if __name__ == "__main__":
    main()
