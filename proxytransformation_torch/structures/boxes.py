"""Box corners for the grounding loss, and the box transforms of the
data pipeline's augmentations.

Counterpart of proxytransformation_tpu/structures/boxes.py::
bbox_to_corners, ::box_transform and ::box_flip on (..., 9) boxes
(cx, cy, cz, dx, dy, dz, ZXY euler).
"""
from __future__ import annotations

import math

import torch

from .rotation import euler_angles_to_matrix, matrix_to_euler_angles

# sign pattern of the loss convention (reference chamfer_distance.py:187-195)
_CORNER_SIGNS_LOSS = ((1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
                      (-1, 1, 1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1))


def bbox_to_corners(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 9) boxes → (..., 8, 3) corners in the loss's corner order."""
    signs = torch.tensor(_CORNER_SIGNS_LOSS, dtype=bbox.dtype,
                         device=bbox.device)
    corners = (bbox[..., None, 3:6] / 2.0) * signs
    rot = euler_angles_to_matrix(bbox[..., 6:9], 'ZXY')
    return corners @ rot.transpose(-2, -1) + bbox[..., None, :3]


def _pad_to_9(bbox: torch.Tensor) -> torch.Tensor:
    """(N, 6) and (N, 7) boxes with zero euler angles appended."""
    d = bbox.shape[-1]
    if d == 9:
        return bbox
    if d not in (6, 7):
        raise ValueError(f'box dim must be 6, 7 or 9, got {d}')
    return torch.cat([bbox, bbox.new_zeros(bbox.shape[:-1] + (9 - d, ))], -1)


def box_transform(bbox: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """A 4x4 SE(3) `matrix` applied to (N, 9) boxes (the JAX package's
    structures/boxes.py::box_transform, reference euler_box3d.py:187-207):
    centers transformed, sizes kept, rotations left-composed."""
    bbox = _pad_to_9(bbox)
    rot = matrix[:3, :3]
    center = bbox[..., :3] @ rot.T + matrix[:3, 3]
    final = rot @ euler_angles_to_matrix(bbox[..., 6:9], 'ZXY')
    return torch.cat([center, bbox[..., 3:6],
                      matrix_to_euler_angles(final, 'ZXY')], dim=-1)


def box_flip(bbox: torch.Tensor, direction: str = 'X') -> torch.Tensor:
    """(N, 9) boxes flipped along an axis (the JAX package's
    structures/boxes.py::box_flip, reference euler_box3d.py:265-283)."""
    bbox = _pad_to_9(bbox)
    x, y, z = bbox[..., 0], bbox[..., 1], bbox[..., 2]
    a, b, c = bbox[..., 6], bbox[..., 7], bbox[..., 8]
    if direction == 'X':
        x, a, c = -x, -a + math.pi, -c
    elif direction == 'Y':
        y, a, b = -y, -a, -b + math.pi
    elif direction == 'Z':
        z, b, c = -z, -b, -c + math.pi
    else:
        raise ValueError(direction)
    return torch.cat([torch.stack([x, y, z], -1), bbox[..., 3:6],
                      torch.stack([a, b, c], -1)], -1)
