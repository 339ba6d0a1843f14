"""Rotation pieces used by the grounding head (ZXY convention).

Counterpart of proxytransformation_tpu/structures/rotation.py::
ortho_6d_to_matrix and ::matrix_to_euler_angles.
"""
from __future__ import annotations

import torch


def matrix_to_euler_angles(matrix: torch.Tensor,
                           convention: str = 'ZXY') -> torch.Tensor:
    """(..., 3, 3) rotations → (..., 3) ZXY euler angles; for
    R = Rz(a) Rx(b) Ry(c): b = asin(m21), a = atan2(-m01, m11),
    c = atan2(-m20, m22)."""
    if convention != 'ZXY':
        raise ValueError(f'only ZXY is supported, got {convention}')
    m = matrix
    b = torch.asin(torch.clamp(m[..., 2, 1], -1.0, 1.0))
    a = torch.atan2(-m[..., 0, 1], m[..., 1, 1])
    c = torch.atan2(-m[..., 2, 0], m[..., 2, 2])
    return torch.stack([a, b, c], dim=-1)


def ortho_6d_to_matrix(x_raw: torch.Tensor, y_raw: torch.Tensor
                       ) -> torch.Tensor:
    """6D rotation parameterization → (..., 3, 3) with columns x, y, z."""

    def normalize(v):
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)

    y = normalize(y_raw)
    z = normalize(torch.linalg.cross(x_raw, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)
