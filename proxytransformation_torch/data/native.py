"""The data pipeline's point kernels, in numpy.

The port's own versions of proxytransformation_tpu/data/native.py's
`depth_to_points`, `fps_sample`, `transform_points_inplace` and
`invert_4x4`. The JAX package runs them in `native/libpt_native.so`
whenever that library loads (it is committed and built with
`-march=native`), so these follow the library's arithmetic rather than the
JAX package's numpy fallbacks:

- `depth_to_points` multiplies by float32 reciprocals,
  `raw * (1 / shift)` and `((u - cx) * d) * (1 / fx)`;
- the compiler contracted the library's float32 sums into fused
  multiply-adds: `transform_points` computes each coordinate as
  `fma(m2, z, fma(m0, x, m1 * y)) + m3` and `fps_sample` each distance as
  `fma(dz, dz, fma(dy, dy, dx * dx))`. `fma32` rounds those once, as the
  FMA instruction does;
- `invert_4x4` is the library's Gauss-Jordan elimination with partial
  pivoting in float64. The library fuses its row updates into float64
  FMAs, which numpy cannot round once; a float64 result one ulp apart
  changes the float32 matrix only where it lies on a float32 rounding
  boundary.
"""
from __future__ import annotations

import numpy as np

_F32_TIE = np.uint64(1 << 28)          # float64 bits dropped by a float32
_F32_DROPPED = np.uint64((1 << 29) - 1)


def fma32(a, b, c) -> np.ndarray:
    """float32 `a * b + c` rounded once (a fused multiply-add). The product
    of two float32 values is exact in float64 and TwoSum gives the exact
    error of the float64 sum; only a sum that lands exactly on a float32
    tie needs that error to round the right way."""
    a64 = np.asarray(a, np.float32).astype(np.float64)
    p = a64 * np.asarray(b, np.float32)
    c64 = np.asarray(c, np.float32).astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    tie = (s.view(np.uint64) & _F32_DROPPED) == _F32_TIE
    fix = tie & (err != 0)
    if np.any(fix):
        s = s.copy()
        s[fix] = np.nextafter(s[fix], np.where(err[fix] > 0, np.inf, -np.inf))
    return s.astype(np.float32)


def depth_to_points(depth_u16: np.ndarray, cam2img: np.ndarray,
                    depth_shift: float = 1000.0) -> np.ndarray:
    """uint16 depth map → (N, 3) float32 camera-frame points of the pixels
    with depth > 0, in row-major order."""
    if depth_u16.dtype != np.uint16 or depth_u16.ndim != 2:
        raise ValueError('depth_to_points takes a (H, W) uint16 depth map')
    k = np.asarray(cam2img, np.float32)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    one = np.float32(1.0)
    h, w = depth_u16.shape
    flat = depth_u16.reshape(-1)
    idx = np.flatnonzero(flat)
    vs, us = np.divmod(idx, w)
    d = flat[idx].astype(np.float32) * (one / np.float32(depth_shift))
    # (u - cx) and (v - cy) depend on the column and row only
    du = np.arange(w, dtype=np.float32) - cx
    dv = np.arange(h, dtype=np.float32) - cy
    out = np.empty((len(d), 3), np.float32)
    out[:, 0] = du[us] * d * (one / fx)
    out[:, 1] = dv[vs] * d * (one / fy)
    out[:, 2] = d
    return out


def fps_sample(points: np.ndarray, k: int) -> np.ndarray:
    """Farthest point sampling from index 0: min(k, N) int64 indices; each
    pick is the first point at the largest float32 distance to the picked
    set."""
    xyz = np.ascontiguousarray(points[:, :3], np.float32)
    n = len(xyz)
    k = min(k, n)
    sel = np.zeros(k, np.int64)
    closest = np.full(n, np.inf, np.float32)
    cur = 0
    for i in range(1, k):
        dx, dy, dz = (xyz - xyz[cur]).T
        d = fma32(dz, dz, fma32(dy, dy, dx * dx))
        np.minimum(closest, d, out=closest)
        cur = int(np.argmax(closest))
        sel[i] = cur
    return sel


def transform_points_inplace(points: np.ndarray, mat: np.ndarray) -> None:
    """p[:, :3] = M[:3, :3] @ p + M[:3, 3] on C-contiguous float32 points,
    in place, each coordinate rounded as the library's FMAs round it."""
    if points.dtype != np.float32 or not points.flags['C_CONTIGUOUS']:
        raise ValueError('transform_points_inplace takes C-contiguous '
                         'float32 points')
    m = np.asarray(mat, np.float32).reshape(-1)
    x, y, z = points[:, 0].copy(), points[:, 1].copy(), points[:, 2].copy()
    for r in range(3):
        m0, m1, m2, m3 = m[4 * r:4 * r + 4]
        t = fma32(m2, z, fma32(m0, x, m1 * y))
        points[:, r] = t + m3


def invert_4x4(mat: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 matrix as float32: Gauss-Jordan with partial
    pivoting in float64, and numpy's inverse where a pivot is below
    1e-12, as in the library."""
    a = np.zeros((4, 8), np.float64)
    a[:, :4] = np.asarray(mat, np.float32)
    a[:, 4:] = np.eye(4)
    for col in range(4):
        piv = col
        for r in range(col + 1, 4):
            if abs(a[r, col]) > abs(a[piv, col]):
                piv = r
        if abs(a[piv, col]) < 1e-12:
            return np.linalg.inv(np.asarray(mat, np.float32).astype(
                np.float64)).astype(np.float32)
        if piv != col:
            a[[piv, col]] = a[[col, piv]]
        a[col] /= a[col, col]
        for r in range(4):
            if r != col:
                a[r] -= a[r, col] * a[col]
    return a[:, 4:].astype(np.float32)
