"""Camera projection of points and back-projection of pixels (the JAX
package's structures/projection.py, reference structures/bbox_3d/
utils.py:244-370).

The JAX functions run eagerly where the package calls them, so every
division here is a true float32 division, as there.
"""
from __future__ import annotations

import torch


def _expand_proj(proj_mat: torch.Tensor) -> torch.Tensor:
    """(..., 3|4, 3|4) projections → (..., 4, 4), the rest of the identity
    filled in."""
    d1, d2 = proj_mat.shape[-2:]
    if (d1, d2) == (4, 4):
        return proj_mat
    full = torch.eye(4, dtype=proj_mat.dtype, device=proj_mat.device)
    full = full.expand(proj_mat.shape[:-2] + (4, 4)).clone()
    full[..., :d1, :d2] = proj_mat
    return full


def points_cam2img(points: torch.Tensor, proj_mat: torch.Tensor,
                   with_depth: bool = False) -> torch.Tensor:
    """(N, 3) camera points → (N, 2) pixels (and depth) through a 3x3, 3x4
    or 4x4 projection; a depth within 1e-6 of 0 divides by ±1e-6."""
    full = _expand_proj(proj_mat)
    pts4 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    pts2d = pts4 @ full.T
    depth = pts2d[..., 2:3]
    safe = torch.where(depth.abs() < 1e-6,
                       torch.sign(depth) * 1e-6 + (depth == 0) * 1e-6, depth)
    uv = pts2d[..., :2] / safe
    return torch.cat([uv, depth], dim=-1) if with_depth else uv


def batch_points_cam2img(points: torch.Tensor, proj_mats: torch.Tensor,
                         with_depth: bool = False) -> torch.Tensor:
    """(V, N, 3) points × (V, 3|4, 3|4) projections → (V, N, 2) pixels (and
    depth); a depth within 1e-6 of 0 divides by 1e-6."""
    proj_mats = _expand_proj(proj_mats)
    pts4 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    pts2d = torch.einsum('vnk,vjk->vnj', pts4, proj_mats)
    depth = pts2d[..., 2:3]
    safe = torch.where(depth.abs() < 1e-6, torch.full_like(depth, 1e-6),
                       depth)
    uv = pts2d[..., :2] / safe
    return torch.cat([uv, depth], dim=-1) if with_depth else uv


def points_img2cam(uv_depth: torch.Tensor, cam2img: torch.Tensor
                   ) -> torch.Tensor:
    """(N, 3) pixels (u, v, depth) → (N, 3) camera points through a
    pinhole `cam2img` (focal lengths and principal point; reference
    utils.py:336-370)."""
    cam2img = _expand_proj(cam2img)
    u, v, d = uv_depth[..., 0], uv_depth[..., 1], uv_depth[..., 2]
    fx, fy = cam2img[0, 0], cam2img[1, 1]
    cx, cy = cam2img[0, 2], cam2img[1, 2]
    x = (u - cx) * d / fx
    y = (v - cy) * d / fy
    return torch.stack([x, y, d], dim=-1)
