"""Exact IoU of oriented 9-DoF 3D boxes.

Counterpart of proxytransformation_tpu/ops/box3d_overlap.py (the
Hungarian matcher's IoU cost). Each box is 6 half-spaces; every vertex of
the intersection polytope is the intersection of 3 of the 12 planes, so
the 160 triples that hold no two opposite faces of one box are solved
with Cramer's rule and the feasible ones kept. The volume follows from
the divergence theorem, V = (1/3) Σ_faces b_i · Area_i, each face polygon
being the feasible vertices on plane i sorted by angle. float32
throughout, on whatever device the boxes are.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from ..structures.rotation import euler_angles_to_matrix

_OPPOSITE = {(0, 3), (1, 4), (2, 5), (6, 9), (7, 10), (8, 11)}
TRIPLES = np.array([
    t for t in combinations(range(12), 3)
    if not ({(t[0], t[1]), (t[0], t[2]), (t[1], t[2])} & _OPPOSITE)
], dtype=np.int64)                                   # (160, 3)


def box_planes(bbox: torch.Tensor):
    """(..., 9) box → (..., 6, 3) unit outward normals, (..., 6) offsets."""
    center = bbox[..., :3]
    half = bbox[..., 3:6] / 2.0
    axes = euler_angles_to_matrix(bbox[..., 6:9], 'ZXY').transpose(-2, -1)
    normals = torch.cat([axes, -axes], dim=-2)
    offsets = (torch.sum(normals * center[..., None, :], dim=-1)
               + torch.cat([half, half], dim=-1))
    return normals, offsets


def _pairs_intersection_volume(boxes1: torch.Tensor, boxes2: torch.Tensor,
                               eps: float = 1e-4) -> torch.Tensor:
    """Intersection volumes of aligned box pairs: (P, 9) × (P, 9) → (P,)."""
    n1, b1 = box_planes(boxes1.float())
    n2, b2 = box_planes(boxes2.float())
    A = torch.cat([n1, n2], dim=1)                  # (P, 12, 3)
    b = torch.cat([b1, b2], dim=1)                  # (P, 12)
    Ax, Ay, Az = A[..., 0], A[..., 1], A[..., 2]
    P = b.shape[0]
    feps = eps * torch.clamp(b.abs().amax(dim=1, keepdim=True), min=1.0)

    tri = torch.as_tensor(TRIPLES, device=b.device)
    a0x, a0y, a0z = Ax[:, tri[:, 0]], Ay[:, tri[:, 0]], Az[:, tri[:, 0]]
    a1x, a1y, a1z = Ax[:, tri[:, 1]], Ay[:, tri[:, 1]], Az[:, tri[:, 1]]
    a2x, a2y, a2z = Ax[:, tri[:, 2]], Ay[:, tri[:, 2]], Az[:, tri[:, 2]]
    bb0, bb1, bb2 = b[:, tri[:, 0]], b[:, tri[:, 1]], b[:, tri[:, 2]]

    # Cramer: v = (b0·(a1×a2) + b1·(a2×a0) + b2·(a0×a1)) / det
    c12x = a1y * a2z - a1z * a2y
    c12y = a1z * a2x - a1x * a2z
    c12z = a1x * a2y - a1y * a2x
    c20x = a2y * a0z - a2z * a0y
    c20y = a2z * a0x - a2x * a0z
    c20z = a2x * a0y - a2y * a0x
    c01x = a0y * a1z - a0z * a1y
    c01y = a0z * a1x - a0x * a1z
    c01z = a0x * a1y - a0y * a1x
    det = a0x * c12x + a0y * c12y + a0z * c12z      # (P, T)
    ok_det = det.abs() > 1e-7
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det,
                                                  torch.ones_like(det)),
                      torch.zeros_like(det))
    vx = (bb0 * c12x + bb1 * c20x + bb2 * c01x) * inv
    vy = (bb0 * c12y + bb1 * c20y + bb2 * c01y) * inv
    vz = (bb0 * c12z + bb1 * c20z + bb2 * c01z) * inv

    # feasibility against all 12 half-spaces: (P, 12, T)
    slack = (vx[:, None, :] * Ax[..., None] + vy[:, None, :] * Ay[..., None]
             + vz[:, None, :] * Az[..., None] - b[..., None])
    feasible = ok_det & torch.all(slack <= feps[..., None], dim=1)
    on_plane = feasible[:, None, :] & (slack.abs() <= feps[..., None])
    zero = torch.zeros_like(vx)
    vx = torch.where(feasible, vx, zero)
    vy = torch.where(feasible, vy, zero)
    vz = torch.where(feasible, vz, zero)

    # per-plane orthonormal in-plane basis u = n × alt, w = n × u
    use_x = Ax.abs() < 0.9
    altx = torch.where(use_x, 1.0, 0.0)
    alty = torch.where(use_x, 0.0, 1.0)
    ux = Ay * 0.0 - Az * alty
    uy = Az * altx - Ax * 0.0
    uz = Ax * alty - Ay * altx
    un = torch.sqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux / un, uy / un, uz / un
    wx = Ay * uz - Az * uy
    wy = Az * ux - Ax * uz
    wz = Ax * uy - Ay * ux

    m = on_plane.float()                                 # (P, 12, T)
    cnt = torch.clamp(m.sum(dim=2), min=1.0)
    cx = (m * vx[:, None, :]).sum(dim=2) / cnt
    cy = (m * vy[:, None, :]).sum(dim=2) / cnt
    cz = (m * vz[:, None, :]).sum(dim=2) / cnt
    rx = vx[:, None, :] - cx[..., None]
    ry = vy[:, None, :] - cy[..., None]
    rz = vz[:, None, :] - cz[..., None]
    pu = rx * ux[..., None] + ry * uy[..., None] + rz * uz[..., None]
    pw = rx * wx[..., None] + ry * wy[..., None] + rz * wz[..., None]
    ang = torch.where(on_plane, torch.atan2(pw, pu),
                      torch.full_like(pu, 1e9))

    # angular sort per plane; fillers take the first (min-angle) vertex so
    # the shoelace's wrap-around edge closes the polygon at no area
    T = ang.shape[-1]
    order = torch.sort(ang.reshape(P * 12, T), dim=1, stable=True).indices
    pu_s = torch.gather(pu.reshape(P * 12, T), 1, order)
    pw_s = torch.gather(pw.reshape(P * 12, T), 1, order)
    msk_s = torch.gather(on_plane.reshape(P * 12, T), 1, order)
    pu_f = torch.where(msk_s, pu_s, pu_s[:, :1])
    pw_f = torch.where(msk_s, pw_s, pw_s[:, :1])
    cross = (pu_f * torch.roll(pw_f, -1, dims=1)
             - pw_f * torch.roll(pu_f, -1, dims=1))
    area = 0.5 * torch.sum(cross, dim=1).abs().reshape(P, 12)

    # coincident planes (identical boxes, shared faces) count once
    same = (Ax[:, :, None] * Ax[:, None, :] + Ay[:, :, None] * Ay[:, None, :]
            + Az[:, :, None] * Az[:, None, :]) > 1.0 - 1e-6
    same &= (b[:, :, None] - b[:, None, :]).abs() <= feps[..., None]
    lower = torch.ones(12, 12, dtype=torch.bool, device=b.device).tril(-1)
    is_dup = torch.any(same & lower, dim=2)

    vol = torch.sum(torch.where(is_dup, torch.zeros_like(area), b * area),
                    dim=1) / 3.0
    return torch.clamp(vol, min=0.0)


def _iou(flat1: torch.Tensor, flat2: torch.Tensor, eps: float):
    inter = _pairs_intersection_volume(flat1, flat2, eps)
    v1 = torch.prod(flat1[:, 3:6].abs(), dim=-1)
    v2 = torch.prod(flat2[:, 3:6].abs(), dim=-1)
    return torch.clamp(inter / torch.clamp(v1 + v2 - inter, min=1e-8),
                       0.0, 1.0)


def box3d_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
              eps: float = 1e-4) -> torch.Tensor:
    """Exact pairwise IoU: (N, 9) × (M, 9) → (N, M)."""
    N, M = boxes1.shape[0], boxes2.shape[0]
    b1 = boxes1.float()[:, None, :].expand(N, M, 9).reshape(-1, 9)
    b2 = boxes2.float()[None, :, :].expand(N, M, 9).reshape(-1, 9)
    return _iou(b1, b2, eps).reshape(N, M)


def box3d_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor,
                      eps: float = 1e-4) -> torch.Tensor:
    """Elementwise exact IoU: (..., 9) × (..., 9) → (...), one volume per
    aligned pair (the matcher's per-sample (B, Q, G) cost)."""
    shape = torch.broadcast_shapes(boxes1.shape[:-1], boxes2.shape[:-1])
    flat1 = boxes1.float().expand(*shape, 9).reshape(-1, 9)
    flat2 = boxes2.float().expand(*shape, 9).reshape(-1, 9)
    return _iou(flat1, flat2, eps).reshape(shape)
