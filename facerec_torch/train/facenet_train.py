"""FaceNet embedder training: triplet loss with online semi-hard mining.

Port of ``facerec_tpu/train/facenet_train.py``: the batch distance
matrix, semi-hard negative selection and the margin triplet loss, a
trainer that takes Adam steps on the full Inception-ResNet-v1, on one
device or data parallel over a process group (the JAX trainer's
``mesh``), the identity-crop directory dataset and the standalone CLI.
The CLI writes the single-file ``<out>/<name>.npz`` that
:func:`facerec_torch.models.load.resolve_facenet_params` reads, in
place of an orbax directory, which cannot be written without JAX.

Run:
  python -m facerec_torch.train.facenet_train --root CROPS --out WDIR
(``--device cpu`` for the host; reading the crops needs OpenCV).
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from facerec_torch.config import EMB_NAME, FACENET_DIMS
from facerec_torch.models.facenet import FaceNet, prewhiten
from facerec_torch.models.layers import init_weights
from facerec_torch.parallel.mesh import (average_gradients, gather_rows,
                                         replicas_identical, replicate)
from facerec_torch.runtime.device import resolve_device, use_full_float32


def pairwise_sq_dists(emb: torch.Tensor) -> torch.Tensor:
    sq = (emb * emb).sum(dim=-1)
    d2 = sq[:, None] - 2.0 * (emb @ emb.T) + sq[None, :]
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    return torch.maximum(d2, torch.zeros((), device=emb.device))


def semi_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                           margin: float = 0.2) -> torch.Tensor:
    """Batch semi-hard triplet loss (FaceNet §3.2).

    For each anchor-positive pair, the hardest semi-hard negative
    (d_an > d_ap but minimal); the easiest negative where no semi-hard
    one exists.  ``amin``/``amax`` split the gradient evenly among tied
    entries, as ``jnp.min``/``jnp.max`` do.  A batch of one identity has
    no triplet and gives exactly 0.
    """
    d2 = pairwise_sq_dists(embeddings)
    n = embeddings.shape[0]
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)
    pos_mask = same & ~eye
    neg_mask = ~same

    big = 1e9
    d_ap = d2[:, :, None]                       # (a, p, 1)
    d_an = d2[:, None, :]                       # (a, 1, n)
    semi = neg_mask[:, None, :] & (d_an > d_ap)
    semi_neg = torch.where(semi, d_an, big).amin(dim=2)          # (a, p)
    easiest = torch.where(neg_mask[:, None, :], d_an, -big).amax(dim=2)
    chosen_neg = torch.where(semi_neg < big / 2, semi_neg, easiest)

    losses = torch.maximum(d2 + margin - chosen_neg,
                           torch.zeros((), device=d2.device))
    # anchors with no negative at all carry no triplet
    has_neg = neg_mask.any(dim=1)
    keep = pos_mask & has_neg[:, None]
    losses = torch.where(keep, losses, 0.0)
    return losses.sum() / keep.sum().clamp_min(1)


class FaceNetTrainer:
    """Adam steps (``optax.adam`` math) on a random-initialised
    :class:`FaceNet` (weights from ``seed``) on one device, the card
    unless ``device="cpu"`` is asked for: prewhiten → FaceNet in train
    mode → L2 normalise (1e-12 floor) → semi-hard triplet loss.

    With a process ``group`` (the JAX trainer's ``mesh``) each rank
    passes its equal shard of the global batch, and the step is the
    one-device step on the global batch: BatchNorm takes the global
    statistics, the embeddings (with their gradient) and labels are
    gathered before the loss, so mining runs over the global batch,
    and the gradients are averaged over the ranks (every rank computes
    the whole loss, so each backward holds n times its share).  Every
    rank keeps rank 0's parameters, statistics and Adam state
    (:meth:`replicas_identical`)."""

    def __init__(self, embedding_dim: int = 128, learning_rate: float = 1e-3,
                 margin: float = 0.2, seed: int = 0, device=None,
                 group=None):
        self.device = resolve_device(device)
        use_full_float32()
        self.embedding_dim = embedding_dim
        self.margin = margin
        model = FaceNet(embedding_dim)
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).train()
        self.group = group
        if group is not None:
            replicate(self.model, group)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8)

    def loss(self, crops, labels) -> torch.Tensor:
        """The loss of one batch of (N, 160, 160, 3) crops, forward in
        train mode (the running statistics move) in the model's dtype;
        with a group, of the global batch whose shard this rank holds."""
        crops = torch.as_tensor(crops, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        dtype = next(self.model.parameters()).dtype
        emb = self.model(prewhiten(crops, dtype).permute(0, 3, 1, 2))
        emb = emb / torch.linalg.vector_norm(
            emb, dim=-1, keepdim=True).clamp_min(1e-12)
        if self.group is not None:
            emb = gather_rows(emb, self.group)
            labels = gather_rows(labels, self.group)
        return semi_hard_triplet_loss(emb, labels, self.margin)

    def step(self, crops, labels) -> torch.Tensor:
        """One Adam step; returns the loss (a 0-dim device tensor)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(crops, labels)
        loss.backward()
        if self.group is not None:
            average_gradients(self.model.parameters(), self.group)
        self.optimizer.step()
        return loss.detach()

    def replicas_identical(self) -> bool:
        """With a group: True on every rank when parameters, running
        statistics and Adam state equal rank 0's bit for bit."""
        return replicas_identical(self.model, self.optimizer, self.group)


class IdentityCropDataset:
    """Face crops grouped by identity from a directory tree,
    ``root/<identity>/*.jpg|jpeg|png``, resized to ``crop_size`` on
    load.  Reading images needs OpenCV, imported here."""

    EXTS = (".jpg", ".jpeg", ".png")

    def __init__(self, root: str, crop_size: int = 160):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "IdentityCropDataset reads image files with OpenCV, which "
                "is not installed on this host") from e

        self.crops = {}          # identity name -> (n, size, size, 3) u8
        for ident in sorted(os.listdir(root)):
            d = os.path.join(root, ident)
            if not os.path.isdir(d):
                continue
            imgs = []
            for fn in sorted(os.listdir(d)):
                if not fn.lower().endswith(self.EXTS):
                    continue
                bgr = cv2.imread(os.path.join(d, fn))
                if bgr is None:
                    continue
                rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                imgs.append(cv2.resize(rgb, (crop_size, crop_size)))
            if imgs:
                self.crops[ident] = np.stack(imgs)
        self.idents = sorted(self.crops)

    def __len__(self) -> int:
        return len(self.idents)

    def batches(self, ids_per_batch: int, crops_per_id: int,
                rng: np.random.Generator):
        """Endless PK-sampled batches: P identities × K crops each
        (identities with fewer than K crops sample with replacement)."""
        p = min(ids_per_batch, len(self.idents))
        while True:
            picked = rng.choice(len(self.idents), size=p, replace=False)
            ims, labels = [], []
            for lab in picked:
                pool = self.crops[self.idents[int(lab)]]
                idx = rng.choice(len(pool), size=crops_per_id,
                                 replace=len(pool) < crops_per_id)
                ims.append(pool[idx])
                labels.extend([int(lab)] * crops_per_id)
            yield (np.concatenate(ims),
                   np.asarray(labels, dtype=np.int32))


def train(root: str, out: str, steps: int, name: Optional[str] = None,
          ids_per_batch: int = 4, crops_per_id: int = 4,
          learning_rate: float = 3e-4, seed: int = 0,
          init_weights: Optional[str] = None, log_every: int = 50,
          recalibrate: bool = True, device=None) -> list:
    """Train one named FaceNet checkpoint on identity crops and write
    ``<out>/<name>.npz``, which ``--facenet-weights <out>`` resolves.
    Returns the loss history."""
    from facerec_torch.models.convert import (facenet_state_dict,
                                              save_params_npz)
    from facerec_torch.train.recalibrate import recalibrate_batch_stats

    name = name or EMB_NAME
    if name not in FACENET_DIMS:
        raise ValueError(f"unknown checkpoint name {name!r}; "
                         f"known: {sorted(FACENET_DIMS)}")
    trainer = FaceNetTrainer(embedding_dim=FACENET_DIMS[name],
                             learning_rate=learning_rate, seed=seed,
                             device=device)
    ds = IdentityCropDataset(root)
    if len(ds) < 2:
        raise RuntimeError(
            f"need >=2 identity subdirectories with images under "
            f"{root!r}, found {len(ds)}")
    print(f"facenet_train: {len(ds)} identities, "
          f"{sum(len(v) for v in ds.crops.values())} crops, "
          f"checkpoint {name} (dim {FACENET_DIMS[name]}), "
          f"device {trainer.device}")
    if init_weights is not None:
        from facerec_torch.models.load import resolve_facenet_params

        trainer.model.load_state_dict(facenet_state_dict(
            resolve_facenet_params(init_weights, name),
            FACENET_DIMS[name]))
    rng = np.random.default_rng(seed)
    losses = []
    for step, (ims, labels) in enumerate(
            ds.batches(ids_per_batch, crops_per_id, rng)):
        if step >= steps:
            break
        losses.append(float(trainer.step(ims, labels)))
        if step % log_every == 0:
            print(f"step {step}: loss {losses[-1]:.4f}", flush=True)
    if recalibrate:
        # the post-training BN refresh of every trainer
        # (train/recalibrate.py, docs/DESIGN.md "BN recalibration")
        cal = ds.batches(ids_per_batch, crops_per_id,
                         np.random.default_rng(seed + 99))
        print("recalibrating BN statistics on dataset batches", flush=True)
        recalibrate_batch_stats(
            trainer.model, (next(cal)[0] for _ in range(32)),
            forward=lambda m, x: m(prewhiten(torch.as_tensor(
                x, device=trainer.device)).permute(0, 3, 1, 2)))
    os.makedirs(out, exist_ok=True)
    path = os.path.join(os.path.abspath(out), name + ".npz")
    save_params_npz(path, trainer.model)
    print(f"saved FaceNet checkpoint to {path}")
    return losses


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--root", required=True,
                        help="crop root: one subdirectory of face "
                             "images per identity")
    parser.add_argument("--out", default="./facenet_weights",
                        help="weights dir; the checkpoint lands at "
                             "<out>/<name>.npz ready for --facenet-weights")
    parser.add_argument("--name", default=EMB_NAME,
                        help="which of the four checkpoint names to "
                             "train")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--ids-per-batch", type=int, default=4)
    parser.add_argument("--crops-per-id", type=int, default=4)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--init-weights", default=None,
                        help="fine-tune: resolve the starting "
                             "checkpoint from this weights dir "
                             "(.pt/.h5/.npz, models/load.py)")
    parser.add_argument("--no-recalibrate", dest="recalibrate",
                        action="store_false",
                        help="skip the post-training BN statistics "
                             "recalibration on dataset batches")
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card) or cpu")
    args = parser.parse_args(argv)
    train(args.root, args.out, args.steps, name=args.name,
          ids_per_batch=args.ids_per_batch,
          crops_per_id=args.crops_per_id, learning_rate=args.lr,
          seed=0, init_weights=args.init_weights,
          recalibrate=args.recalibrate, device=args.device)


if __name__ == "__main__":
    main()
