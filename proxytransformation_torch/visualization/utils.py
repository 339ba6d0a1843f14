"""Box geometry for the visualizers.

Counterpart of proxytransformation_tpu/visualization/utils.py: 9-DoF
boxes to corners and wireframe segments, computed in torch on an explicit
device (`None` is the card, as for the port's other entry points) by
`structures/boxes.py::box_corners`, returned as numpy.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..structures.boxes import box_corners
from ..structures.rotation import euler_angles_to_matrix

Device = Optional[Union[str, torch.device]]

# 12 box edges over the reference corner ordering
_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7],
                   [7, 4], [0, 4], [1, 5], [2, 6], [3, 7]])


def nine_dof_to_corners(box9: np.ndarray, device: Device = None
                        ) -> np.ndarray:
    """(9,) or (N, 9) box → (N, 8, 3) numpy corners (a 7-dim box is
    refused by the reshape, as in the JAX package)."""
    b = np.asarray(box9, np.float32).reshape(-1, 9)
    t = torch.from_numpy(b).to(resolve_device(device))
    return box_corners(t).cpu().numpy()


def box_lines(box9: np.ndarray, device: Device = None) -> np.ndarray:
    """(N, 9) boxes → (N, 12, 2, 3) wireframe segments."""
    corners = nine_dof_to_corners(box9, device)
    return corners[:, _EDGES]  # (N, 12, 2, 3)


def line_mesh_segments(points: np.ndarray, lines: np.ndarray,
                       radius: float = 0.02):
    """Cylinder segments for thick wireframes: per-segment (start, end,
    radius) tuples (`LineMesh` builds their meshes)."""
    return [(points[a], points[b], radius) for a, b in lines]


def to_open3d_box(box9: np.ndarray, color=(0, 1, 0), device: Device = None):
    """9-DoF box → open3d.geometry.OrientedBoundingBox (if installed)."""
    import open3d as o3d
    b = np.asarray(box9, np.float32).reshape(9)
    angles = torch.from_numpy(b[6:9].copy()).to(resolve_device(device))
    rot = euler_angles_to_matrix(angles, 'ZXY').cpu().numpy()
    obb = o3d.geometry.OrientedBoundingBox(b[:3].reshape(3, 1),
                                           rot.astype(np.float64),
                                           b[3:6].reshape(3, 1))
    obb.color = color
    return obb
