"""Camera projection of points (the JAX package's structures/projection.py::
points_cam2img, reference structures/bbox_3d/utils.py:244-370)."""
from __future__ import annotations

import torch


def points_cam2img(points: torch.Tensor, proj_mat: torch.Tensor,
                   with_depth: bool = False) -> torch.Tensor:
    """(N, 3) camera points → (N, 2) pixels (and depth) through a 3x3, 3x4
    or 4x4 projection; a depth within 1e-6 of 0 divides by ±1e-6."""
    d1, d2 = proj_mat.shape[-2:]
    full = torch.eye(4, dtype=proj_mat.dtype, device=proj_mat.device)
    full[:d1, :d2] = proj_mat
    pts4 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    pts2d = pts4 @ full.T
    depth = pts2d[..., 2:3]
    safe = torch.where(depth.abs() < 1e-6,
                       torch.sign(depth) * 1e-6 + (depth == 0) * 1e-6, depth)
    uv = pts2d[..., :2] / safe
    return torch.cat([uv, depth], dim=-1) if with_depth else uv
