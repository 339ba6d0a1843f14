"""Rotation pieces used by the grounding head and its loss (ZXY
convention).

Counterpart of proxytransformation_tpu/structures/rotation.py::
euler_angles_to_matrix, ::ortho_6d_to_matrix and ::matrix_to_euler_angles.
"""
from __future__ import annotations

import torch


def _axis_rotation(axis: str, a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {'X': ((o, z, z), (z, c, -s), (z, s, c)),
            'Y': ((c, z, s), (z, o, z), (-s, z, c)),
            'Z': ((c, -s, z), (s, c, z), (z, z, o))}[axis]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_angles_to_matrix(angles: torch.Tensor,
                           convention: str = 'ZXY') -> torch.Tensor:
    """(..., 3) euler angles → (..., 3, 3) rotations,
    R = R_c0(a0) @ R_c1(a1) @ R_c2(a2) (pytorch3d's order)."""
    if len(convention) != 3:
        raise ValueError(f'a convention names 3 axes, got {convention}')
    m = [_axis_rotation(ax, angles[..., i]) for i, ax in enumerate(convention)]
    return (m[0] @ m[1]) @ m[2]


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
