"""9-DoF Euler-angle boxes: corners, transforms, the point-in-box test
and the `EulerBoxes` wrapper.

Counterpart of proxytransformation_tpu/structures/boxes.py on (..., 9)
boxes (cx, cy, cz, dx, dy, dz, ZXY euler); (N, 6) and (N, 7) boxes take
zero angles where the JAX functions pad them.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from ..device import resolve_device
from ..ops.box3d_overlap import box3d_iou
from .rotation import euler_angles_to_matrix, matrix_to_euler_angles

# corner order of the box class (reference euler_box3d.py:86-95): offsets
# in {0, 1} minus the (0.5, 0.5, 0.5) origin
_CORNER_NORM_BOX = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
                    (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))

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


def box_corners(bbox: torch.Tensor) -> torch.Tensor:
    """(..., 9) boxes → (..., 8, 3) corners in the box class's order."""
    bbox = _pad_to_9(bbox)
    norm = torch.tensor(_CORNER_NORM_BOX, dtype=bbox.dtype,
                        device=bbox.device) - 0.5
    rot = euler_angles_to_matrix(bbox[..., 6:9], 'ZXY')
    corners = (bbox[..., None, 3:6] * norm) @ rot.transpose(-2, -1)
    return corners + bbox[..., None, :3]


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


def points_in_boxes(points: torch.Tensor, bbox: torch.Tensor,
                    eps: float = 0.0) -> torch.Tensor:
    """(N, 3) points × (M, 9) boxes → (N, M) bool: each point rotated into
    the box's frame, |local| ≤ dims / 2 + eps on every axis (the JAX
    package's replacement of mmcv's `points_in_boxes_all`, reference
    euler_depth_box3d.py:100-164)."""
    bbox = _pad_to_9(bbox)
    rot = euler_angles_to_matrix(bbox[..., 6:9], 'ZXY')
    rel = points[:, None, :] - bbox[None, :, :3]
    local = torch.einsum('nmi,mij->nmj', rel, rot)
    half = bbox[None, :, 3:6] / 2.0 + eps
    return torch.all(local.abs() <= half, dim=-1)


class EulerBoxes:
    """A padded (N, 9) float32 box tensor in depth coordinates with the
    reference `EulerDepthInstance3DBoxes`'s surface; the work is in the
    functions above. `device=None` puts the tensor on the card (raising
    when there is none), as the port's entry points do; pass 'cpu' for
    the CPU. Every method returns a new object on the same device."""

    def __init__(self, tensor, device: Optional[Union[str,
                                                      torch.device]] = None):
        self.tensor = _pad_to_9(torch.as_tensor(
            tensor, dtype=torch.float32, device=resolve_device(device)))

    def _new(self, tensor: torch.Tensor) -> 'EulerBoxes':
        return EulerBoxes(tensor, self.tensor.device)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def gravity_center(self) -> torch.Tensor:
        return self.tensor[:, :3]

    @property
    def dims(self) -> torch.Tensor:
        return self.tensor[:, 3:6]

    @property
    def corners(self) -> torch.Tensor:
        return box_corners(self.tensor)

    @property
    def volume(self) -> torch.Tensor:
        return torch.prod(self.tensor[:, 3:6], dim=-1)

    def transform(self, matrix) -> 'EulerBoxes':
        return self._new(box_transform(self.tensor, torch.as_tensor(
            matrix, dtype=torch.float32, device=self.tensor.device)))

    def scale(self, factor: float) -> 'EulerBoxes':
        return self._new(torch.cat([self.tensor[:, :6] * factor,
                                    self.tensor[:, 6:]], -1))

    def rotate(self, angle) -> 'EulerBoxes':
        """By a yaw (a scalar), ZXY euler angles (3,) or a 3x3 matrix."""
        angle = torch.as_tensor(angle, dtype=torch.float32,
                                device=self.tensor.device)
        if angle.ndim == 0:
            angle = torch.stack([angle, angle.new_zeros(()),
                                 angle.new_zeros(())])
        if angle.shape == (3, ):
            rot = euler_angles_to_matrix(angle, 'ZXY')
        elif angle.shape == (3, 3):
            rot = angle
        else:
            raise ValueError(f'bad rotation {tuple(angle.shape)}')
        mat = torch.eye(4, device=self.tensor.device)
        mat[:3, :3] = rot
        return self.transform(mat)

    def flip(self, direction: str = 'X') -> 'EulerBoxes':
        return self._new(box_flip(self.tensor, direction))

    def overlaps(self, other: 'EulerBoxes', eps: float = 1e-4
                 ) -> torch.Tensor:
        """The exact pairwise 3D IoU (N, M) of the oriented boxes."""
        return box3d_iou(self.tensor, other.tensor, eps=eps)
