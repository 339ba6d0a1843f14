"""Point containers in the camera, depth and LiDAR frames (the JAX
package's structures/points.py, reference structures/points/
base_points.py:1-522 and its subclasses): a padded (N, D) float32 tensor
whose first three columns are xyz. Every mutator returns a new object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

# the reference Coord3DMode's conventions (coord_3d_mode.py:17-272):
#   CAM:   x right, y down, z front
#   DEPTH: x right, y front, z up
#   LIDAR: x front, y left, z up
_CONVERSIONS = {
    ('CAMERA', 'DEPTH'): np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]],
                                  np.float32),
    ('DEPTH', 'CAMERA'): np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]],
                                  np.float32),
    ('DEPTH', 'LIDAR'): np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]],
                                 np.float32),
    ('LIDAR', 'DEPTH'): np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                                 np.float32),
    ('CAMERA', 'LIDAR'): np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
                                  np.float32),
    ('LIDAR', 'CAMERA'): np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]],
                                  np.float32),
}


@dataclasses.dataclass
class BasePoints:
    """`device=None` puts the tensor on the card (raising when there is
    none), as the port's entry points do; pass 'cpu' for the CPU. A new
    object made by a method stays on its parent's device."""
    tensor: torch.Tensor
    points_dim: int = 3
    attribute_dims: Optional[Dict] = None
    coord_frame: str = 'DEPTH'
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.tensor = torch.as_tensor(
            self.tensor, dtype=torch.float32,
            device=resolve_device(self.device)).reshape(-1, self.points_dim)
        self.device = self.tensor.device

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def coord(self) -> torch.Tensor:
        return self.tensor[:, :3]

    @property
    def shape(self) -> torch.Size:
        return self.tensor.shape

    def _new(self, tensor: torch.Tensor) -> 'BasePoints':
        return dataclasses.replace(self, tensor=tensor)

    def _with_xyz(self, xyz: torch.Tensor) -> 'BasePoints':
        return self._new(torch.cat([xyz, self.tensor[:, 3:]], dim=-1))

    def _as(self, value) -> torch.Tensor:
        return torch.as_tensor(value, dtype=torch.float32,
                               device=self.tensor.device)

    def translate(self, trans) -> 'BasePoints':
        return self._with_xyz(self.coord + self._as(trans))

    def rotate(self, rot_mat_t) -> 'BasePoints':
        """p[:, :3] @ rot_mat_t (the reference's right-multiplication)."""
        return self._with_xyz(self.coord @ self._as(rot_mat_t))

    def scale(self, factor: float) -> 'BasePoints':
        return self._with_xyz(self.coord * factor)

    def flip(self, bev_direction: str = 'horizontal') -> 'BasePoints':
        t = self.tensor.clone()
        idx = 0 if bev_direction == 'horizontal' else 1
        t[:, idx] *= -1.0
        return self._new(t)

    def convert_to(self, dst: str) -> 'BasePoints':
        if dst == self.coord_frame:
            return self
        mat = self._as(_CONVERSIONS[(self.coord_frame, dst)])
        out = self._with_xyz(self.coord @ mat.T)
        out.coord_frame = dst
        return out

    def in_range_3d(self, point_range) -> torch.Tensor:
        r = self._as(point_range)
        return torch.all((self.coord >= r[:3]) & (self.coord <= r[3:6]), -1)


@dataclasses.dataclass
class CameraPoints(BasePoints):
    coord_frame: str = 'CAMERA'


@dataclasses.dataclass
class DepthPoints(BasePoints):
    coord_frame: str = 'DEPTH'


@dataclasses.dataclass
class LiDARPoints(BasePoints):
    coord_frame: str = 'LIDAR'


def get_points_type(coord_type: str):
    return {'CAMERA': CameraPoints, 'DEPTH': DepthPoints,
            'LIDAR': LiDARPoints}[coord_type]
