"""Numpy box operations (host-side oracles and data tooling).

The port's own copy of proxytransformation_tpu/structures/box_np_ops.py
(that package's `structures/__init__` imports jax.numpy): a compact
re-implementation of the reference's numpy kernel library (reference:
structures/ops/box_np_ops.py:14-839): corner generation,
points-in-convex-polygon / points-in-rbbox tests, axis-aligned `iou_jit`,
camera↔lidar conversions of the pieces the data tooling uses.
"""
from __future__ import annotations

import numpy as np


def corners_nd(dims: np.ndarray, origin: float = 0.5) -> np.ndarray:
    """(N, ndim) dims → (N, 2**ndim, ndim) corners."""
    ndim = dims.shape[1]
    corners_norm = np.stack(np.unravel_index(np.arange(2 ** ndim),
                                             [2] * ndim), axis=1)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(
        1, 2 ** ndim, ndim)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate (N, K, 2) points by (N,) angles (counterclockwise)."""
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack([np.stack([c, -s]), np.stack([s, c])])  # (2,2,N)
    return np.einsum('aij,jka->aik', points, rot)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    corners = corners_nd(dims, origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def center_to_corner_box3d(centers, dims, angles=None, origin=0.5, axis=2):
    corners = corners_nd(dims, origin)
    if angles is not None:
        c, s = np.cos(angles), np.sin(angles)
        o, z = np.ones_like(c), np.zeros_like(c)
        if axis == 2:
            rot = np.stack([np.stack([c, -s, z]), np.stack([s, c, z]),
                            np.stack([z, z, o])])
        elif axis == 1:
            rot = np.stack([np.stack([c, z, s]), np.stack([z, o, z]),
                            np.stack([-s, z, c])])
        else:
            rot = np.stack([np.stack([o, z, z]), np.stack([z, c, -s]),
                            np.stack([z, s, c])])
        corners = np.einsum('aij,jka->aik', corners, rot)
    return corners + centers.reshape(-1, 1, 3)


def points_in_convex_polygon_2d(points: np.ndarray,
                                polygon: np.ndarray) -> np.ndarray:
    """(N, 2) points × (M, K, 2) convex polygons (ccw) → (N, M) bool."""
    edges = np.roll(polygon, -1, axis=1) - polygon  # (M, K, 2)
    rel = points[:, None, None, :] - polygon[None]  # (N, M, K, 2)
    cross = edges[None, ..., 0] * rel[..., 1] - \
        edges[None, ..., 1] * rel[..., 0]
    return np.all(cross >= 0, axis=-1) | np.all(cross <= 0, axis=-1)


def points_in_rbbox(points: np.ndarray, boxes7: np.ndarray,
                    origin=(0.5, 0.5, 0.5)) -> np.ndarray:
    """(N, 3) points × (M, 7) yaw boxes → (N, M) bool."""
    centers = boxes7[:, :3]
    dims = boxes7[:, 3:6]
    yaw = boxes7[:, 6]
    rel = points[:, None, :] - centers[None]
    c, s = np.cos(-yaw), np.sin(-yaw)
    x = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    y = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    z = rel[..., 2]
    return ((np.abs(x) <= dims[None, :, 0] / 2)
            & (np.abs(y) <= dims[None, :, 1] / 2)
            & (np.abs(z) <= dims[None, :, 2] / 2))


def iou_jit(boxes: np.ndarray, query_boxes: np.ndarray,
            eps: float = 1.0) -> np.ndarray:
    """Axis-aligned 2D IoU of (N, 4) × (K, 4) boxes (the reference's
    numba kernel, vectorized)."""
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0] + eps)
              * (query_boxes[:, 3] - query_boxes[:, 1] + eps))
    area_b = ((boxes[:, 2] - boxes[:, 0] + eps)
              * (boxes[:, 3] - boxes[:, 1] + eps))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps)
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    return inter / (area_b[:, None] + area_q[None] - inter)


# ---------------------------------------------------------------------------
# frustum / surface / projection utilities
# (capability parity with reference structures/ops/box_np_ops.py:123-765)
# ---------------------------------------------------------------------------
def camera_to_lidar(points: np.ndarray, r_rect: np.ndarray,
                    velo2cam: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points → lidar frame via (r_rect @ velo2cam)⁻¹."""
    n = points.shape[0]
    hom = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], 1)
    out = hom @ np.linalg.inv((r_rect @ velo2cam).T)
    return out[:, :3]


def box_camera_to_lidar(data: np.ndarray, r_rect: np.ndarray,
                        velo2cam: np.ndarray) -> np.ndarray:
    """(N, 7) camera boxes (x,y,z,l,h,w,ry) → lidar (x,y,z,w,l,h,yaw)."""
    xyz = camera_to_lidar(data[:, :3], r_rect, velo2cam)
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    return np.concatenate([xyz, w, l, h, -r - np.pi / 2], axis=1)


def depth_to_points(depth: np.ndarray, trunc_pixel: int = 0) -> np.ndarray:
    """Dense (H, W) depth map → (M, 3) [u, v, d] pixel-frame points."""
    h, w = depth.shape
    vs, us = np.nonzero(depth[trunc_pixel:] > 0)
    vs = vs + trunc_pixel
    return np.stack([us.astype(depth.dtype), vs.astype(depth.dtype),
                     depth[vs, us]], axis=1)


def corner_to_standup_nd(corners: np.ndarray) -> np.ndarray:
    """(N, 2**d, d) corners → (N, 2d) axis-aligned [min, max] boxes."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], 1)


def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) corners → (N, 6, 4, 3) quad surfaces (outward order
    compatible with `surface_equ_3d`). Corner convention follows
    `center_to_corner_box3d` above."""
    idx = np.array([[0, 1, 2, 3], [7, 6, 5, 4], [0, 3, 7, 4],
                    [1, 5, 6, 2], [3, 2, 6, 7], [0, 4, 5, 1]])
    return corners[:, idx]


def surface_equ_3d(surfaces: np.ndarray):
    """(N, S, 4, 3) polygon surfaces → unit?-less plane normals (N, S, 3)
    and offsets d (N, S) with normal·x + d = 0 on the plane."""
    vec1 = surfaces[:, :, 1] - surfaces[:, :, 0]
    vec2 = surfaces[:, :, 2] - surfaces[:, :, 0]
    normal = np.cross(vec1, vec2)
    d = -np.einsum('nsi,nsi->ns', normal, surfaces[:, :, 0])
    return normal, d


def points_in_convex_polygon_3d(points: np.ndarray,
                                surfaces: np.ndarray) -> np.ndarray:
    """(N, 3) points × (M, S, 4, 3) convex polyhedra → (N, M) bool."""
    normal, d = surface_equ_3d(surfaces)
    sign = np.einsum('ni,msi->nms', points, normal) + d[None]
    return np.all(sign <= 1e-9, axis=-1) | np.all(sign >= -1e-9, axis=-1)


def box3d_to_bbox(box3d: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """(N, 7) yaw boxes → (N, 4) image-plane axis-aligned boxes via the
    (4, 4) projection matrix."""
    corners = center_to_corner_box3d(box3d[:, :3], box3d[:, 3:6],
                                     box3d[:, 6], origin=(0.5, 0.5, 0.5),
                                     axis=2)
    n = corners.shape[0]
    hom = np.concatenate([corners, np.ones((n, 8, 1))], -1)
    img = hom @ proj.T
    img = img[..., :2] / np.clip(img[..., 2:3], 1e-6, None)
    return corner_to_standup_nd(img)


def minmax_to_corner_2d(minmax_box: np.ndarray) -> np.ndarray:
    ndim = minmax_box.shape[-1] // 2
    center = minmax_box[:, :ndim]
    dims = minmax_box[:, ndim:] - center
    return center_to_corner_box2d(center, dims, origin=0.0)


def center_to_minmax_2d(centers, dims, origin=0.5):
    if origin == 0.5:
        return np.concatenate([centers - dims / 2, centers + dims / 2], -1)
    corners = center_to_corner_box2d(centers, dims, origin=origin)
    return corners[:, [0, 2]].reshape(-1, 4)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """(N, 5) rotated 2D boxes → nearest axis-aligned (N, 4) boxes
    (swap w/l when the yaw is closer to ±π/2)."""
    rots = np.abs(np.mod(rbboxes[:, 4] + np.pi / 4, np.pi) - np.pi / 4)
    cond = (rots > np.pi / 4)[..., None]
    swapped = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(swapped[:, :2], swapped[:, 2:4])


def projection_matrix_to_CRT_kitti(proj: np.ndarray):
    """Decompose a 3×4 (or 4×4) projection P = C @ [R|T] with C upper
    triangular (RQ decomposition via flipped QR)."""
    P = proj[:3, :4]
    CR = P[:3, :3]
    CT = P[:3, 3]
    f = np.eye(3)[::-1]
    Q, R = np.linalg.qr((f @ CR).T)
    C = f @ R.T @ f
    Rm = f @ Q.T
    # fix signs so the intrinsic diagonal is positive: C' = C D, R' = D R
    sign = np.sign(np.diag(C))
    sign[sign == 0] = 1.0
    C = C * sign[None, :]
    Rm = Rm * sign[:, None]
    T = np.linalg.solve(C, CT)
    return C, Rm, T


def get_frustum(bbox_image, C, near_clip: float = 0.001,
                far_clip: float = 100.0) -> np.ndarray:
    """Image-plane bbox [xmin, ymin, xmax, ymax] + intrinsic C →
    (8, 3) camera-frame frustum corners (near 4 then far 4)."""
    fku, fkv = C[0, 0], -C[1, 1]
    u0v0 = C[:2, 2]
    z_points = np.array([near_clip] * 4 + [far_clip] * 4)[:, None]
    b = bbox_image
    box_corners = np.array(
        [[b[0], b[1]], [b[0], b[3]], [b[2], b[3]], [b[2], b[1]]],
        dtype=C.dtype)
    near_corners = (box_corners - u0v0) / np.array(
        [fku / near_clip, -np.abs(fkv) / near_clip])
    far_corners = (box_corners - u0v0) / np.array(
        [fku / far_clip, -np.abs(fkv) / far_clip])
    return np.concatenate(
        [np.concatenate([near_corners, far_corners], 0), z_points], 1)


def remove_outside_points(points: np.ndarray, rect: np.ndarray,
                          velo2cam: np.ndarray, proj: np.ndarray,
                          image_shape) -> np.ndarray:
    """Drop lidar points projecting outside the image frustum."""
    C, R, T = projection_matrix_to_CRT_kitti(proj)
    bbox = [0, 0, image_shape[1], image_shape[0]]
    frustum = get_frustum(bbox, C)
    frustum = frustum - T
    frustum = (np.linalg.inv(R) @ frustum.T).T
    frustum = camera_to_lidar(frustum, rect, velo2cam)
    surfaces = corner_to_surfaces_3d(frustum[None])
    keep = points_in_convex_polygon_3d(points[:, :3], surfaces)[:, 0]
    return points[keep]
