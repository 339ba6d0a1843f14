"""Box3DMode / Coord3DMode: boxes and points between the CAM, LIDAR and
DEPTH conventions (the JAX package's structures/modes.py, reference
structures/bbox_3d/box_3d_mode.py:14-258, coord_3d_mode.py:17-272)."""
from __future__ import annotations

import enum

import numpy as np
import torch

from .points import _CONVERSIONS
from .rotation import euler_angles_to_matrix, matrix_to_euler_angles


class Box3DMode(enum.IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


class Coord3DMode(enum.IntEnum):
    LIDAR = 0
    CAM = 1
    DEPTH = 2


_NAMES = {Box3DMode.LIDAR: 'LIDAR', Box3DMode.CAM: 'CAMERA',
          Box3DMode.DEPTH: 'DEPTH'}


def _rot_for(src, dst, like: torch.Tensor) -> torch.Tensor:
    s = _NAMES[Box3DMode(int(src))]
    d = _NAMES[Box3DMode(int(dst))]
    rot = np.eye(3, dtype=np.float32) if s == d else _CONVERSIONS[(s, d)]
    return torch.as_tensor(rot, dtype=like.dtype, device=like.device)


def convert_point(points: torch.Tensor, src: Coord3DMode,
                  dst: Coord3DMode) -> torch.Tensor:
    """(N, 3+) points → converted coordinates (extra columns kept)."""
    rot = _rot_for(src, dst, points)
    return torch.cat([points[..., :3] @ rot.T, points[..., 3:]], dim=-1)


def convert_box(boxes: torch.Tensor, src: Box3DMode,
                dst: Box3DMode) -> torch.Tensor:
    """(N, 9) euler boxes → the other frame: centres rotated, sizes (along
    the box's own axes) kept, orientations left-composed with the frame
    rotation and read back as ZXY euler angles."""
    rot = _rot_for(src, dst, boxes)
    center = boxes[..., :3] @ rot.T
    ori = euler_angles_to_matrix(boxes[..., 6:9], 'ZXY')
    angles = matrix_to_euler_angles(rot[None] @ ori, 'ZXY')
    return torch.cat([center, boxes[..., 3:6], angles], dim=-1)
