"""Axis-aligned and nearest-BEV 3D IoU (the JAX package's structures/
iou3d_calculator.py, reference structures/ops/iou3d_calculator.py:
10-331): `axis_aligned_bbox_overlaps_3d` is the exact overlap of
axis-aligned boxes, `BboxOverlapsNearest3D` approximates rotated boxes
by their axis-aligned extent."""
from __future__ import annotations

import torch


def axis_aligned_bbox_overlaps_3d(bboxes1: torch.Tensor,
                                  bboxes2: torch.Tensor,
                                  mode: str = 'iou',
                                  eps: float = 1e-6) -> torch.Tensor:
    """(N, 6) × (M, 6) boxes as (x1, y1, z1, x2, y2, z2) → (N, M) IoU,
    'iof' (over the first box's volume) or 'giou'."""
    lo = torch.maximum(bboxes1[:, None, :3], bboxes2[None, :, :3])
    hi = torch.minimum(bboxes1[:, None, 3:], bboxes2[None, :, 3:])
    inter = torch.prod(torch.clamp(hi - lo, min=0), -1)
    v1 = torch.prod(bboxes1[:, 3:] - bboxes1[:, :3], -1)
    v2 = torch.prod(bboxes2[:, 3:] - bboxes2[:, :3], -1)
    if mode == 'giou':
        glo = torch.minimum(bboxes1[:, None, :3], bboxes2[None, :, :3])
        ghi = torch.maximum(bboxes1[:, None, 3:], bboxes2[None, :, 3:])
        hull = torch.prod(torch.clamp(ghi - glo, min=0), -1)
        union = v1[:, None] + v2[None] - inter
        iou = inter / torch.clamp(union, min=eps)
        return iou - (hull - union) / torch.clamp(hull, min=eps)
    union = (v1[:, None] + v2[None] - inter if mode == 'iou'
             else v1[:, None].expand(inter.shape))
    return inter / torch.clamp(union, min=eps)


def bbox_overlaps_nearest_3d(bboxes1: torch.Tensor, bboxes2: torch.Tensor,
                             mode: str = 'iou') -> torch.Tensor:
    """Nearest-axis-aligned approximation for 7/9-DoF boxes."""
    def to_aabb(b):
        half = b[:, 3:6] / 2
        return torch.cat([b[:, :3] - half, b[:, :3] + half], -1)

    return axis_aligned_bbox_overlaps_3d(to_aabb(bboxes1), to_aabb(bboxes2),
                                         mode)


class BboxOverlapsNearest3D:

    def __init__(self, coordinate: str = 'lidar'):
        self.coordinate = coordinate

    def __call__(self, bboxes1, bboxes2, mode='iou', is_aligned=False):
        iou = bbox_overlaps_nearest_3d(bboxes1, bboxes2, mode)
        return torch.diagonal(iou) if is_aligned else iou
