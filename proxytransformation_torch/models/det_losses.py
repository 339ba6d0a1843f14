"""Losses of the FCAF3D detection head.

Counterpart of proxytransformation_tpu/models/det_losses.py (its box and
centerness losses; the occupancy losses of that file come with the
occupancy models): `rotated_iou_3d_loss` (1 - exact IoU of oriented
boxes, differentiable through `ops/box3d_overlap.py`'s vertex solve),
`axis_aligned_iou_loss` and `binary_cross_entropy_with_logits` (mmdet's
CrossEntropyLoss with use_sigmoid=True).

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
