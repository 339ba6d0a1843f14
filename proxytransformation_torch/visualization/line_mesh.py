"""Cylinder line meshes for thick 3D box wireframes.

The port's copy of proxytransformation_tpu/visualization/line_mesh.py
(numpy, bit for bit): the reference's open3d `LineMesh` (reference:
embodiedscan/visualization/line_mesh.py:42-120) as a pure-numpy mesh
generator (vertices / triangles / colors), dumped to an ASCII PLY
headlessly or handed to open3d when it is installed (`to_open3d`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rotation_aligning(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1 / (1 + c))


def _cylinder(p0: np.ndarray, p1: np.ndarray, radius: float,
              sides: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Open cylinder mesh between two points: (verts, tris)."""
    axis = p1 - p0
    h = np.linalg.norm(axis)
    if h < 1e-9:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    rot = _rotation_aligning(np.array([0.0, 0.0, 1.0]), axis / h)
    ang = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius,
                     np.zeros(sides)], 1)
    bot = ring @ rot.T + p0
    top = (ring + np.array([0, 0, h])) @ rot.T + p0
    verts = np.concatenate([bot, top], 0)
    tris = []
    for i in range(sides):
        j = (i + 1) % sides
        tris.append([i, j, sides + i])
        tris.append([j, sides + j, sides + i])
    return verts.astype(np.float32), np.asarray(tris, np.int32)


class LineMesh:
    """Thick line set as a triangle mesh.

    Args:
        points: (N, 3) endpoints.
        lines: (M, 2) index pairs; consecutive pairs when None.
        colors: single rgb or per-line (M, 3).
        radius: cylinder radius.
    """

    def __init__(self, points: np.ndarray,
                 lines: Optional[Sequence[Sequence[int]]] = None,
                 colors=(0.0, 1.0, 0.0), radius: float = 0.02,
                 sides: int = 8):
        points = np.asarray(points, np.float32)
        if lines is None:
            lines = self.lines_from_ordered_points(points)
        lines = np.asarray(lines, np.int32)
        colors = np.asarray(colors, np.float32)
        if colors.ndim == 1:
            colors = np.tile(colors, (len(lines), 1))
        verts: List[np.ndarray] = []
        tris: List[np.ndarray] = []
        cols: List[np.ndarray] = []
        off = 0
        for (i, j), col in zip(lines, colors):
            v, t = _cylinder(points[i], points[j], radius, sides)
            if len(v) == 0:
                continue
            verts.append(v)
            tris.append(t + off)
            cols.append(np.tile(col, (len(v), 1)))
            off += len(v)
        self.vertices = (np.concatenate(verts, 0) if verts
                         else np.zeros((0, 3), np.float32))
        self.triangles = (np.concatenate(tris, 0) if tris
                          else np.zeros((0, 3), np.int32))
        self.vertex_colors = (np.concatenate(cols, 0) if cols
                              else np.zeros((0, 3), np.float32))

    @staticmethod
    def lines_from_ordered_points(points: np.ndarray) -> np.ndarray:
        n = len(points)
        return np.stack([np.arange(n - 1), np.arange(1, n)], 1)

    # ------------------------------------------------------------------
    def to_open3d(self):
        """One open3d TriangleMesh (requires open3d)."""
        import open3d as o3d
        m = o3d.geometry.TriangleMesh()
        m.vertices = o3d.utility.Vector3dVector(self.vertices)
        m.triangles = o3d.utility.Vector3iVector(self.triangles)
        m.vertex_colors = o3d.utility.Vector3dVector(self.vertex_colors)
        m.compute_vertex_normals()
        return m

    def save_ply(self, path: str) -> None:
        """ASCII PLY dump (headless inspection)."""
        with open(path, 'w') as f:
            f.write('ply\nformat ascii 1.0\n'
                    f'element vertex {len(self.vertices)}\n'
                    'property float x\nproperty float y\nproperty float z\n'
                    'property uchar red\nproperty uchar green\n'
                    'property uchar blue\n'
                    f'element face {len(self.triangles)}\n'
                    'property list uchar int vertex_indices\nend_header\n')
            for v, c in zip(self.vertices, self.vertex_colors):
                rgb = (np.clip(c, 0, 1) * 255).astype(int)
                f.write(f'{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} '
                        f'{rgb[0]} {rgb[1]} {rgb[2]}\n')
            for t in self.triangles:
                f.write(f'3 {t[0]} {t[1]} {t[2]}\n')
