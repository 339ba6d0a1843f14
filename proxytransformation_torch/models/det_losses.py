"""Losses of the FCAF3D detection head and of the occupancy head.

Counterpart of proxytransformation_tpu/models/det_losses.py:
`rotated_iou_3d_loss` (1 - exact IoU of oriented boxes, differentiable
through `ops/box3d_overlap.py`'s vertex solve), `axis_aligned_iou_loss`,
`binary_cross_entropy_with_logits` (mmdet's CrossEntropyLoss with
use_sigmoid=True), the occupancy head's scene-class affinity losses
`geo_scal_loss` and `sem_scal_loss` (reference occ_loss.py:39-141) and
the preshape offsets' `gaussian_kernel_loss`.

Where the JAX package clips with `jnp.clip` / `jnp.maximum`, this file
takes `torch.maximum` / `torch.minimum`: both split the gradient in half
where the two sides are equal (an IoU of exactly 1, a logit of exactly
0), which `torch.clamp` does not; and `jnp.abs` has the gradient 1 at 0.
"""
from __future__ import annotations

import torch

from ..ops.box3d_overlap import pairs_intersection_volume


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


def _average(s: torch.Tensor, avg_factor, floor: float) -> torch.Tensor:
    if avg_factor is None:
        return s
    return s / _max(torch.as_tensor(avg_factor, dtype=s.dtype,
                                    device=s.device), floor)


def _elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                     eps: float = 1e-4) -> torch.Tensor:
    """Exact IoU of matched box pairs: (N, 9) × (N, 9) → (N,)."""
    inter = pairs_intersection_volume(boxes1, boxes2, eps)
    v1 = torch.prod(boxes1[:, 3:6].abs(), dim=-1)
    v2 = torch.prod(boxes2[:, 3:6].abs(), dim=-1)
    return _min(_max(inter / _max(v1 + v2 - inter, 1e-8), 0.0), 1.0)


def _pad9(b: torch.Tensor) -> torch.Tensor:
    if b.shape[-1] == 9:
        return b
    return torch.cat([b, b.new_zeros(b.shape[:-1] + (9 - b.shape[-1], ))], -1)


def rotated_iou_3d_loss(pred: torch.Tensor, target: torch.Tensor,
                        weight=None, avg_factor=None) -> torch.Tensor:
    """Σ (1 - IoU) of oriented (N, 7 or 9) box pairs (7-DoF zero-padded
    to 9), times `weight`, over max(avg_factor, 1e-6)."""
    loss = 1.0 - _elementwise_iou(_pad9(pred.float()), _pad9(target.float()))
    if weight is not None:
        loss = loss * weight.reshape(loss.shape)
    return _average(torch.sum(loss), avg_factor, 1e-6)


def axis_aligned_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                          weight=None, avg_factor=None) -> torch.Tensor:
    """Σ (1 - IoU) of (x1, y1, z1, x2, y2, z2) boxes, over
    max(avg_factor, 1e-6)."""
    lo = torch.maximum(pred[..., :3], target[..., :3])
    hi = torch.minimum(pred[..., 3:], target[..., 3:])
    inter = torch.prod(_max(hi - lo, 0.0), -1)
    v1 = torch.prod(_max(pred[..., 3:] - pred[..., :3], 0.0), -1)
    v2 = torch.prod(_max(target[..., 3:] - target[..., :3], 0.0), -1)
    loss = 1.0 - inter / _max(v1 + v2 - inter, 1e-8)
    if weight is not None:
        loss = loss * weight.reshape(loss.shape)
    return _average(torch.sum(loss), avg_factor, 1e-6)


def binary_cross_entropy_with_logits(pred, target, weight=None,
                                     avg_factor=None) -> torch.Tensor:
    """Σ BCE(sigmoid(pred), target), times `weight`, over
    max(avg_factor, 1)."""
    # |pred| with jnp.abs's gradient of 1 at 0 (torch.abs gives 0)
    loss = (_max(pred, 0.0) - pred * target
            + torch.log1p(torch.exp(-torch.where(pred >= 0, pred, -pred))))
    if weight is not None:
        loss = loss * weight
    return _average(torch.sum(loss), avg_factor, 1.0)


def gaussian_kernel_loss(offsets: torch.Tensor, sigma: float = 1.0,
                         mask=None) -> torch.Tensor:
    """Mean of 1 - exp(-|offset|² / 2σ²) over the (masked) offsets
    (reference gaussian_offset_loss.py:1-35)."""
    d2 = torch.sum(offsets * offsets, -1)
    loss = 1.0 - torch.exp(-d2 / (2 * sigma ** 2))
    if mask is None:
        return torch.mean(loss)
    m = mask.to(loss.dtype)
    return torch.sum(loss * m) / _max(torch.sum(m), 1.0)


def _neg_log_clip(x: torch.Tensor, eps: float) -> torch.Tensor:
    """-log(clip(x, eps, 1)), with jnp.clip's gradient at the bounds."""
    return -torch.log(_min(_max(x, eps), 1.0))


def geo_scal_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
                  empty_label: int, mask=None) -> torch.Tensor:
    """Geometric scene-class affinity: -log of the precision, recall and
    specificity of occupied (any class but `empty_label`) against empty,
    over the voxels of `mask` (default gt >= 0). pred_logits (..., C)."""
    probs = torch.softmax(pred_logits, -1)
    empty = probs[..., empty_label]
    nonempty = 1.0 - empty
    is_occ = ((gt != empty_label) & (gt >= 0)).to(probs.dtype)
    if mask is None:
        mask = gt >= 0
    m = mask.to(probs.dtype)
    occ = is_occ * m
    free = (1.0 - is_occ) * m
    eps = 1e-6
    precision = torch.sum(nonempty * occ) / _max(torch.sum(nonempty * m), eps)
    recall = torch.sum(nonempty * occ) / _max(torch.sum(occ), eps)
    spec = torch.sum(empty * free) / _max(torch.sum(free), eps)
    return (_neg_log_clip(precision, eps) + _neg_log_clip(recall, eps)
            + _neg_log_clip(spec, eps))


def sem_scal_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Semantic scene-class affinity: per class, -log of the precision,
    recall and specificity of its softmax probability against its gt
    voxels, averaged over the classes present in the masked gt. The JAX
    package loops over the C classes; here one pass over a (V, C) layout
    computes every class at once (the sums are taken in another order, so
    the result agrees to float32 rounding, not bit for bit)."""
    C = pred_logits.shape[-1]
    probs = torch.softmax(pred_logits, -1).reshape(-1, C)
    if mask is None:
        mask = gt >= 0
    m = mask.reshape(-1, 1).to(probs.dtype)
    classes = torch.arange(C, device=gt.device)
    t = (gt.reshape(-1, 1) == classes).to(probs.dtype) * m
    eps = 1e-6
    pt = torch.sum(probs * t, 0)
    t_sum = torch.sum(t, 0)
    precision = pt / _max(torch.sum(probs * m, 0), eps)
    recall = pt / _max(t_sum, eps)
    spec = (torch.sum((1 - probs) * (m - t), 0)
            / _max(torch.sum(m - t, 0), eps))
    per_class = (_neg_log_clip(precision, eps) + _neg_log_clip(recall, eps)
                 + _neg_log_clip(spec, eps))
    has = t_sum > 0
    total = torch.sum(torch.where(has, per_class, torch.zeros_like(per_class)))
    return total / _max(torch.sum(has.to(probs.dtype)), 1.0)
