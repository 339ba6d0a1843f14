"""Losses and match costs of the grounding head.

Counterpart of proxytransformation_tpu/models/losses.py: mmdet's sigmoid
focal loss (γ=2, α=0.25) with soft targets, the corner-Chamfer box loss,
and the Hungarian match costs (binary focal, L1, negative exact IoU), as
masked static-shape functions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.box3d_overlap import box3d_iou
from ..structures.boxes import bbox_to_corners


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None,
                       alpha: float = 0.25, gamma: float = 2.0,
                       avg_factor=None) -> torch.Tensor:
    """mmdet py_sigmoid focal loss with float (soft) targets, summed (and
    divided by `avg_factor`, at least 1)."""
    p = torch.sigmoid(pred)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    # numerically stable BCE with logits
    bce = (torch.clamp(pred, min=0) - pred * target
           + torch.log1p(torch.exp(-pred.abs())))
    loss = bce * focal_weight
    if weight is not None:
        loss = loss * weight
    loss = torch.sum(loss)
    if avg_factor is not None:
        loss = loss / torch.clamp(torch.as_tensor(avg_factor), min=1.0)
    return loss


def chamfer_corner_loss(src_boxes: torch.Tensor, dst_boxes: torch.Tensor,
                        mode: str = 'l1', group: str = 'g8') -> torch.Tensor:
    """Per-box corner Chamfer distance src→dst: the mean over the 8 source
    corners of the distance to the nearest target corner, (..., 9) ×
    (..., 9) → (...)."""
    sc = bbox_to_corners(src_boxes)
    dc = bbox_to_corners(dst_boxes)

    def cham(s, d):
        diff = s[..., :, None, :] - d[..., None, :, :]      # (..., 8, 8, 3)
        if mode == 'l1':
            dist = diff.abs().sum(dim=-1)
        elif mode == 'l2':
            dist = (diff * diff).sum(dim=-1)
        else:
            dist = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                               diff.abs() - 0.5).sum(dim=-1)
        return torch.amin(dist, dim=-1).mean(dim=-1)

    if group == 'g8':
        return cham(sc, dc)
    return (cham(sc[..., :4, :], dc[..., :4, :])
            + cham(sc[..., 4:, :], dc[..., 4:, :]))


def binary_focal_cost(pred_logits: torch.Tensor, gt_maps: torch.Tensor,
                      text_mask: torch.Tensor, alpha: float = 0.25,
                      gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """(..., Q, T) logits × (..., G, T) positive maps, (..., T) valid-token
    mask → (..., Q, G) focal match cost."""
    m = text_mask.to(pred_logits.dtype)[..., None, :]
    p = 1 / (1 + torch.exp(-pred_logits))
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma * m
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma * m
    gt = gt_maps * m
    return pos @ gt.transpose(-1, -2) + neg @ ((1 - gt) * m).transpose(-1, -2)


def bbox_l1_cost(pred_boxes: torch.Tensor,
                 gt_boxes: torch.Tensor) -> torch.Tensor:
    """(..., Q, 9) × (..., G, 9) → (..., Q, G) pairwise L1."""
    return (pred_boxes[..., :, None, :]
            - gt_boxes[..., None, :, :]).abs().sum(dim=-1)


def iou3d_cost(pred_boxes: torch.Tensor,
               gt_boxes: torch.Tensor) -> torch.Tensor:
    """(Q, 9) × (G, 9) → (Q, G) negative exact IoU."""
    return -box3d_iou(pred_boxes, gt_boxes)
