"""Box corners for the grounding loss.

Counterpart of proxytransformation_tpu/structures/boxes.py::
bbox_to_corners on (..., 9) boxes (cx, cy, cz, dx, dy, dz, ZXY euler).
"""
from __future__ import annotations

import torch

from .rotation import euler_angles_to_matrix

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
