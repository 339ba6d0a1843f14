"""Synthetic indoor scans for smoke runs and benchmarks.

The port's own copy of proxytransformation_tpu/data/synthetic.py::
surface_scene_points / surface_scene_batch (same numpy draws, so the same
seed gives the same clouds in both packages).
"""
from __future__ import annotations

import numpy as np


def surface_scene_points(n_points: int, seed: int = 0,
                         room_size=(11.0, 9.0, 3.0), n_objects: int = 28,
                         noise: float = 0.005) -> np.ndarray:
    """Points on the surfaces of a room (floor + 4 walls) and of
    `n_objects` yaw-rotated boxes, area-proportional, with ~5 mm noise.
    At 100k points and 1 cm voxels this reproduces the reference's
    per-sample level occupancies (≈82k/71k/43k/15k/3.7k voxels at
    2/4/8/16/32 cm). Returns (n_points, 3) float32."""
    rng = np.random.RandomState(seed)
    Lx, Ly, Lz = room_size
    rects = [
        ((0, 0, 0), (Lx, 0, 0), (0, Ly, 0)),
        ((0, 0, 0), (Lx, 0, 0), (0, 0, Lz)),
        ((0, Ly, 0), (Lx, 0, 0), (0, 0, Lz)),
        ((0, 0, 0), (0, Ly, 0), (0, 0, Lz)),
        ((Lx, 0, 0), (0, Ly, 0), (0, 0, Lz)),
    ]
    for _ in range(n_objects):
        sx, sy = rng.uniform(0.3, 1.6, 2)
        sz = rng.uniform(0.3, 1.2)
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        cx = rng.uniform(1.0, Lx - 1.0)
        cy = rng.uniform(1.0, Ly - 1.0)
        z0 = 0.0 if rng.rand() < 0.8 else rng.uniform(0.3, 1.0)
        base = np.array([cx, cy, z0])
        ex = rot @ np.array([sx, 0, 0])
        ey = rot @ np.array([0, sy, 0])
        ez = np.array([0, 0, sz])
        o = base - 0.5 * (ex + ey)
        rects += [
            (o, ex, ez), (o + ey, ex, ez), (o, ey, ez), (o + ex, ey, ez),
            (tuple(o + ez), ex, ey),
        ]
    origins = np.array([r[0] for r in rects], np.float64)
    us = np.array([r[1] for r in rects], np.float64)
    vs = np.array([r[2] for r in rects], np.float64)
    areas = np.linalg.norm(np.cross(us, vs), axis=1)
    counts = rng.multinomial(n_points, areas / areas.sum())
    face = np.repeat(np.arange(len(rects)), counts)
    a = rng.rand(n_points)[:, None]
    b = rng.rand(n_points)[:, None]
    pts = origins[face] + a * us[face] + b * vs[face]
    pts += rng.normal(0.0, noise, pts.shape)
    rng.shuffle(pts)
    return pts.astype(np.float32)


def surface_scene_batch(batch: int, n_points: int, seed: int = 0,
                        **kw) -> np.ndarray:
    """(B, n_points, 3) stack of `surface_scene_points` scenes."""
    return np.stack([
        surface_scene_points(n_points, seed=seed * 1000003 + i, **kw)
        for i in range(batch)
    ])


def flagship_batch(B: int = 2, n_points: int = 100_000, V: int = 20,
                   H: int = 480, W: int = 480, L: int = 32,
                   seed: int = 0) -> dict:
    """A predict request at the flagship benchmark's shapes: surface
    scenes, random images, a pinhole projection per view, random token
    ids (numpy arrays; see `models.detector.batch_to_device`)."""
    rng = np.random.RandomState(seed)
    proj = np.tile(np.array([[400, 0, W / 2, 0], [0, 400, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    return {
        'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
        'points': surface_scene_batch(B, n_points, seed=seed),
        'points_mask': np.ones((B, n_points), bool),
        'input_ids': rng.randint(0, 49408, (B, L)).astype(np.int32),
        'text_mask': np.ones((B, L), bool),
        'proj_mats': proj,
        'views_mask': np.ones((B, V), bool),
    }
