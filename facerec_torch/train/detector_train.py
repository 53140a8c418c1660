"""Face-detector training on one device.

Port of ``facerec_tpu/train/detector_train.py``: anchor assignment and
the multi-task loss (score BCE with hard-negative weighting, smooth-L1
box and landmark regression) of the single-stage detector, and a
trainer that takes Adam steps on it, on one device or data parallel
over a process group (the JAX trainer's ``mesh``).  Target assignment
runs over the whole batch at once, as the JAX code's ``vmap`` does.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from facerec_torch.models.detector import (VARIANCES, FaceDetector,
                                           anchor_centers, normalize_images)
from facerec_torch.ops.boxes import iou_broadcast
from facerec_torch.parallel.mesh import (average_gradients, replicas_identical,
                                         replicate)
from facerec_torch.runtime.device import resolve_device, use_full_float32


class AnchorTargets(NamedTuple):
    labels: torch.Tensor       # (B, A) 1 pos / 0 neg / -1 ignore
    box_targets: torch.Tensor  # (B, A, 4) encoded offsets
    ldm_targets: torch.Tensor  # (B, A, 10)
    ldm_valid: torch.Tensor    # (B, A) bool


def anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   gt_landmarks: Optional[torch.Tensor] = None,
                   pos_iou: float = 0.5, neg_iou: float = 0.3,
                   content_hw: Optional[torch.Tensor] = None
                   ) -> AnchorTargets:
    """Assign padded ground truth to anchors, for a batch.

    ``anchors`` (A, 4) [cx, cy, w, h]; ``gt_boxes`` (B, G, 4) xyxy,
    ``gt_valid`` (B, G), ``gt_landmarks`` (B, G, 5, 2) or None,
    ``content_hw`` (B, 2) letterboxed content (h, w) or None.

    Anchors with best-gt IoU ≥ pos_iou are positive, < neg_iou negative,
    in between ignored; each valid gt also claims its best anchor.
    Anchors centred outside ``content_hw`` (the letterbox padding) are
    negative.  Ties go to the first maximum, as ``jnp.argmax``.

    The force-match writes ``gt_valid[g]`` at ``best_anchor[g]`` for
    every gt, as the JAX scatter does; where two gts claim one anchor
    (a padded gt's all −1 column picks anchor 0), the highest gt index
    wins, which is what XLA's scatter gives on the CPU.
    """
    a_cx, a_cy, a_w, a_h = anchors.unbind(-1)
    anchors_xyxy = torch.stack([a_cx - a_w / 2, a_cy - a_h / 2,
                                a_cx + a_w / 2, a_cy + a_h / 2], dim=-1)
    iou = iou_broadcast(anchors_xyxy[None, :, None, :],
                        gt_boxes[:, None, :, :])          # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)

    best_gt = iou.argmax(dim=2)                            # (B, A)
    best_iou = iou.amax(dim=2)

    best_anchor = iou.argmax(dim=1)                        # (B, G)
    g = torch.arange(best_anchor.shape[1], device=iou.device)
    overwritten = ((best_anchor[:, :, None] == best_anchor[:, None, :])
                   & (g[None, None, :] > g[None, :, None])).any(dim=2)
    claim = (gt_valid & ~overwritten).to(torch.int32)
    forced = torch.zeros(iou.shape[:2], dtype=torch.int32,
                         device=iou.device).scatter_reduce(
        1, best_anchor, claim, reduce="amax").bool()

    labels = torch.where(best_iou >= pos_iou, 1, -1)
    labels = torch.where(best_iou < neg_iou, 0, labels)
    labels = torch.where(forced, 1, labels)
    if content_hw is not None:
        inside = ((a_cy[None] < content_hw[:, 0:1])
                  & (a_cx[None] < content_hw[:, 1:2]))
        labels = torch.where(inside, labels, 0)

    gb = torch.gather(gt_boxes, 1,
                      best_gt[..., None].expand(-1, -1, 4))  # (B, A, 4)
    g_w = gb[..., 2] - gb[..., 0]
    g_h = gb[..., 3] - gb[..., 1]
    g_cx = gb[..., 0] + g_w / 2
    g_cy = gb[..., 1] + g_h / 2
    v0, v1 = VARIANCES
    eps = 1e-6
    box_t = torch.stack([
        (g_cx - a_cx) / (v0 * a_w),
        (g_cy - a_cy) / (v0 * a_h),
        torch.log(g_w.clamp_min(eps) / a_w) / v1,
        torch.log(g_h.clamp_min(eps) / a_h) / v1,
    ], dim=-1)

    b, a = labels.shape
    if gt_landmarks is None:
        ldm_t = torch.zeros(b, a, 10, device=iou.device)
        ldm_valid = torch.zeros(b, a, dtype=torch.bool, device=iou.device)
    else:
        lm = torch.gather(gt_landmarks, 1, best_gt[..., None, None].expand(
            -1, -1, 5, 2))                                  # (B, A, 5, 2)
        lx = (lm[..., 0] - a_cx[:, None]) / (v0 * a_w[:, None])
        ly = (lm[..., 1] - a_cy[:, None]) / (v0 * a_h[:, None])
        ldm_t = torch.stack([lx, ly], dim=-1).reshape(b, a, 10)
        ldm_valid = labels == 1
    return AnchorTargets(labels, box_t, ldm_t, ldm_valid)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def detector_loss(raw_outputs: List[Dict[str, torch.Tensor]],
                  targets: AnchorTargets, neg_weight: float = 1.0,
                  box_weight: float = 2.0, ldm_weight: float = 1.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-task loss over a batch of raw head outputs; every sum is
    per image, divided by its positives, then averaged."""
    score = torch.cat([o["score"] for o in raw_outputs], dim=1)
    box = torch.cat([o["box"] for o in raw_outputs], dim=1)
    ldm = torch.cat([o["ldm"] for o in raw_outputs], dim=1)

    labels, box_t, ldm_t, ldm_valid = targets
    pos = labels == 1
    neg = labels == 0
    n_pos = pos.sum(dim=1).clamp_min(1)                    # (B,)

    # optax.sigmoid_binary_cross_entropy
    bce = F.binary_cross_entropy_with_logits(score, pos.to(score.dtype),
                                             reduction="none")
    cls_loss = (torch.where(pos, bce, 0.0).sum(dim=1)
                + neg_weight * torch.where(neg, bce, 0.0).sum(dim=1)) / n_pos
    box_loss = (smooth_l1(box - box_t).sum(-1)
                * pos.to(box.dtype)).sum(dim=1) / n_pos
    ldm_loss = (smooth_l1(ldm - ldm_t).sum(-1)
                * ldm_valid.to(ldm.dtype)).sum(dim=1) / n_pos

    total = (cls_loss + box_weight * box_loss
             + ldm_weight * ldm_loss).mean()
    return total, {"cls": cls_loss.mean(), "box": box_loss.mean(),
                   "ldm": ldm_loss.mean(), "n_pos": n_pos.sum()}


class DetectorTrainer:
    """Adam steps on a :class:`FaceDetector` on one device (the card
    unless ``device="cpu"`` is asked for), with the JAX trainer's loss
    and ``optax.adam`` math (β = 0.9, 0.999, ε = 1e-8).

    ``model`` is moved to the device and trained in place; its batch
    statistics move at every step.  ``use_landmarks=False`` (datasets
    without landmarks, e.g. WIDER-FACE bbx_gt) leaves the landmark head
    without gradient; ``gt_landmarks`` is then ignored.

    With a process ``group`` (the JAX trainer's ``mesh``) each rank
    passes its equal shard of the global batch to :meth:`step`, and the
    step is the one-device step on the global batch, as ``jit`` over a
    sharded batch computes it: BatchNorm takes the global batch's
    statistics, and the gradients are averaged over the ranks (each
    rank's backward already holds the other ranks' share of the
    statistics' gradient).  Every rank starts from rank 0's weights and
    keeps the same parameters, statistics and Adam state
    (:meth:`replicas_identical`).
    """

    def __init__(self, model: FaceDetector, input_size: Tuple[int, int],
                 learning_rate: float = 1e-3, use_landmarks: bool = True,
                 device=None, group=None):
        self.device = resolve_device(device)
        use_full_float32()
        self.model = model.to(self.device).train()
        self.group = group
        if group is not None:
            replicate(self.model, group)
        self.input_size = tuple(input_size)
        self.learning_rate = learning_rate
        self.use_landmarks = use_landmarks
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
            eps=1e-8)
        self.anchors = torch.from_numpy(anchor_centers(self.input_size)).to(
            self.device)

    def loss(self, images, gt_boxes, gt_valid, gt_landmarks,
             content_hw=None) -> torch.Tensor:
        """The loss of one batch, forward in train mode (the running
        statistics move).  ``images`` (B, H, W, 3) uint8 at the input
        size, normalised in the model's dtype; arrays may be numpy or
        tensors.  ``content_hw``: per-image
        (B, 2) letterboxed content (h, w) in input pixels; None = the
        whole input."""
        dev = self.device
        images = torch.as_tensor(images, device=dev)
        if content_hw is None:
            content_hw = torch.tensor(self.input_size, dtype=torch.float32,
                                      device=dev).expand(images.shape[0], 2)
        raw = self.model(normalize_images(
            images, next(self.model.parameters()).dtype))
        targets = anchor_targets(
            self.anchors, torch.as_tensor(gt_boxes, device=dev),
            torch.as_tensor(gt_valid, device=dev),
            (torch.as_tensor(gt_landmarks, device=dev)
             if self.use_landmarks else None),
            content_hw=torch.as_tensor(content_hw, device=dev).to(
                torch.float32))
        return detector_loss(raw, targets)[0]

    def step(self, images, gt_boxes, gt_valid, gt_landmarks,
             content_hw=None) -> torch.Tensor:
        """One Adam step; returns the batch's loss (a 0-dim tensor on
        the device: reading it waits for the step).  With a group, the
        arrays are this rank's shard and the loss is the global
        batch's."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(images, gt_boxes, gt_valid, gt_landmarks,
                         content_hw)
        loss.backward()
        loss = loss.detach()
        if self.group is not None:
            import torch.distributed as dist

            average_gradients(self.model.parameters(), self.group)
            # a mean of per-image terms: equal shards average
            dist.all_reduce(loss, group=self.group)
            loss /= dist.get_world_size(self.group)
        self.optimizer.step()
        return loss

    def replicas_identical(self) -> bool:
        """With a group: True on every rank when parameters, running
        statistics and Adam state equal rank 0's bit for bit."""
        return replicas_identical(self.model, self.optimizer, self.group)
