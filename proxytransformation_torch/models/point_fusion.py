"""2D→3D feature painting: project voxels into views, sample, average.

Counterpart of proxytransformation_tpu/models/point_fusion.py: undo the
point augmentation, project with `intrinsic @ extrinsic` per view,
sample the nearest feature (the grounder's `aligned=False`) under
grid_sample align_corners=True normalization over the padded image shape,
and average over the views where the projection is valid.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.common import recip32


def apply_inverse_aug(points: torch.Tensor,
                      pcd_rotation: Optional[torch.Tensor] = None,
                      pcd_scale_factor: Optional[torch.Tensor] = None,
                      pcd_trans: Optional[torch.Tensor] = None,
                      flip_x: Optional[torch.Tensor] = None,
                      flip_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Undo GlobalRotScaleTrans/RandomFlip3D on (..., N, 3) points (the
    aug applied `p @ R`): flips, then -T, 1/S and R⁻¹ = Rᵀ."""
    p = points
    one = torch.ones((), device=p.device)
    if flip_x is not None:
        p = p * torch.where(flip_x[..., None, None],
                            torch.tensor([-1.0, 1.0, 1.0], device=p.device), one)
    if flip_y is not None:
        p = p * torch.where(flip_y[..., None, None],
                            torch.tensor([1.0, -1.0, 1.0], device=p.device), one)
    if pcd_trans is not None:
        p = p - pcd_trans[..., None, :]
    if pcd_scale_factor is not None:
        # one scale a sample, (B,) or the preprocessor's (B, 1)
        p = p / pcd_scale_factor.reshape(*p.shape[:-2], 1, 1)
    if pcd_rotation is not None:
        p = p @ pcd_rotation.transpose(-1, -2)
    return p


def batch_point_sample(img_features: torch.Tensor, points: torch.Tensor,
                       proj_mats: torch.Tensor, img_pad_shape,
                       valid_mask: Optional[torch.Tensor] = None,
                       views_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Nearest-sample painting, batched over samples.

    img_features (B, V, Hf, Wf, C) NHWC, points (B, N, 3) unaugmented,
    proj_mats (B, V, 4, 4), img_pad_shape (h, w), valid_mask (B, N),
    views_mask (B, V) → (B, N, C) mean over valid projections.
    """
    B, V, Hf, Wf, C = img_features.shape
    N = points.shape[1]
    pts4 = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    proj = torch.einsum('bvij,bnj->bvni', proj_mats, pts4)
    depth = proj[..., 2]
    den = torch.where(depth.abs()[..., None] < 1e-6,
                      torch.full_like(depth[..., None], 1e-6),
                      depth[..., None])
    uv = proj[..., :2] / den
    h, w = img_pad_shape
    x, y = uv[..., 0], uv[..., 1]
    valid = (x > 0) & (x < w) & (y > 0) & (y < h) & (depth > 0)
    if views_mask is not None:
        valid = valid & views_mask[:, :, None]
    # the reference divides by the static pad shape, which XLA folds into
    # a multiplication by the float32 reciprocal
    fx = ((x * recip32(w)) * 2 - 1 + 1) / 2 * (Wf - 1)
    fy = ((y * recip32(h)) * 2 - 1 + 1) / 2 * (Hf - 1)
    ix = torch.clamp(torch.round(fx).long(), 0, Wf - 1)
    iy = torch.clamp(torch.round(fy).long(), 0, Hf - 1)
    flat = img_features.reshape(B, V, Hf * Wf, C)
    idx = (iy * Wf + ix)[..., None].expand(B, V, N, C)
    feat = torch.gather(flat, 2, idx)
    feat = torch.where(valid[..., None], feat, torch.zeros_like(feat))
    cnt = valid.sum(dim=1)
    out = (feat.float().sum(dim=1)
           / torch.clamp(cnt[..., None], min=1)).to(feat.dtype)
    out = torch.where((cnt > 0)[..., None], out, torch.zeros_like(out))
    if valid_mask is not None:
        out = torch.where(valid_mask[..., None], out, torch.zeros_like(out))
    return out
