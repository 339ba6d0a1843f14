"""Synthetic indoor scans and grounding samples for smoke runs, tests and
benchmarks.

The port's own copy of proxytransformation_tpu/data/synthetic.py::
surface_scene_points / surface_scene_batch / SyntheticGroundingDataset
(same numpy draws, so the same seed gives the same clouds and samples in
both packages).
"""
from __future__ import annotations

import numpy as np

from ..utils.registry import DATASETS


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
                   seed: int = 0, with_targets: bool = False) -> dict:
    """A request at the flagship benchmark's shapes: surface scenes,
    random images, a pinhole projection per view, random token ids (numpy
    arrays; see `models.detector.batch_to_device`). `with_targets` adds
    the train step's synthetic targets of bench.py::_flagship_batch: 8 gt
    boxes per sample (centers in [1, 5), sizes in [0.3, 1.5), angles in
    [-0.5, 0.5)), all valid, each positive at token 1 of the flagship's
    256."""
    rng = np.random.RandomState(seed)
    proj = np.tile(np.array([[400, 0, W / 2, 0], [0, 400, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    batch = {
        'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
        'points': surface_scene_batch(B, n_points, seed=seed),
        'points_mask': np.ones((B, n_points), bool),
        'input_ids': rng.randint(0, 49408, (B, L)).astype(np.int32),
        'text_mask': np.ones((B, L), bool),
        'proj_mats': proj,
        'views_mask': np.ones((B, V), bool),
    }
    if with_targets:
        G = 8
        gt = np.concatenate([rng.uniform(1, 5, (B, G, 3)),
                             rng.uniform(0.3, 1.5, (B, G, 3)),
                             rng.uniform(-0.5, 0.5, (B, G, 3))], -1)
        pm = np.zeros((B, G, 256), np.float32)
        pm[:, :, 1] = 1.0
        batch.update({'gt_bboxes': gt.astype(np.float32),
                      'gt_masks': np.ones((B, G), bool),
                      'positive_maps': pm})
    return batch


@DATASETS.register_module()
class SyntheticGroundingDataset:
    """Grounding samples with the contract of the real pipeline's output
    (points, multi-view images, text, gt boxes, flags), the JAX package's
    draws in the same order: the same seed and index give the same
    sample in both packages. Points are uniform in a 5 m cube plus
    `n_objects` boxes of points, not surfaces: at 1 cm voxels nearly
    every voxel is a singleton."""

    def __init__(self, length: int = 32, n_points: int = 4096,
                 n_views: int = 4, img_size: int = 96, n_objects: int = 4,
                 seed: int = 0, test_mode: bool = False):
        self.length = length
        self.n_points = n_points
        self.n_views = n_views
        self.img_size = img_size
        self.n_objects = n_objects
        self.seed = seed
        self.test_mode = test_mode

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        S = self.img_size
        # objects: boxes with points concentrated inside
        centers = rng.uniform(0.5, 4.5, (self.n_objects, 3)).astype(np.float32)
        sizes = rng.uniform(0.3, 0.9, (self.n_objects, 3)).astype(np.float32)
        angles = np.stack([
            rng.uniform(-np.pi, np.pi, self.n_objects),
            np.zeros(self.n_objects), np.zeros(self.n_objects)
        ], -1).astype(np.float32)
        boxes = np.concatenate([centers, sizes, angles], -1)

        per_obj = self.n_points // (self.n_objects + 1)
        pts = [rng.uniform(0, 5.0, (self.n_points - self.n_objects * per_obj,
                                    3))]
        for o in range(self.n_objects):
            local = rng.uniform(-0.5, 0.5, (per_obj, 3)) * sizes[o]
            c, s = np.cos(angles[o, 0]), np.sin(angles[o, 0])
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            pts.append(local @ rot.T + centers[o])
        points = np.concatenate(pts).astype(np.float32)

        target = rng.randint(self.n_objects)
        names = ['chair', 'table', 'bed', 'sofa', 'lamp', 'desk', 'shelf',
                 'cabinet']
        name = names[target % len(names)]
        text = f'find the {name} in the room'
        beg = text.find(name)

        imgs = rng.randint(0, 255, (self.n_views, S, S, 3)).astype(np.uint8)
        proj = np.tile(np.array([[S, 0, S / 2, 0], [0, S, S / 2, 0],
                                 [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                       (self.n_views, 1, 1))
        gt = boxes[target:target + 1]
        return {
            'points': points,
            'imgs': imgs.astype(np.float32),
            'text': text,
            'tokens_positive': [[[beg, beg + len(name)]]],
            'gt_bboxes_3d': gt,
            'gt_labels_3d': np.asarray([target], np.int64),
            'depth2img': dict(
                intrinsic=[p[:3, :3] for p in proj],
                extrinsic=[np.eye(4, dtype=np.float32)] * self.n_views),
            'scale_factor': None,
            'pcd_rotation': None,
            'pcd_scale_factor': None,
            'pcd_trans': None,
            'eval_ann_info': {
                'gt_bboxes_3d': gt,
                'gt_labels_3d': np.asarray([target], np.int64),
                'is_hard': bool(idx % 3 == 0),
                'is_view_dep': bool(idx % 2 == 0),
                'is_unique': bool(idx % 4 == 0),
            },
        }
