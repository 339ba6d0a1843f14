"""Step-through scene drawers for continuous 3D perception.

Counterpart of proxytransformation_tpu/visualization/continuous_drawer.py
(reference: embodiedscan/visualization/continuous_drawer.py:12-335): walk
a scene view by view, accumulating the back-projected RGB-D cloud (or
predicted occupancy) and the boxes visible so far. `step()` returns the
accumulated state; `run_headless()` saves a render per step through the
base visualizer; `run_interactive()` drives an open3d window ("press D
for the next frame"). The back-projection runs in torch on the drawer's
device.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .base_visualizer import EmbodiedScanBaseVisualizer
from .utils import Device, nine_dof_to_corners


def _backproject(rgb: Optional[np.ndarray], depth: np.ndarray,
                 intrinsic: np.ndarray, cam2global: np.ndarray,
                 depth_shift: float = 1000.0, max_depth: float = 10.0,
                 device: Device = None) -> np.ndarray:
    """RGB-D view → (N, 6) float32 xyzrgb in the global frame (pinhole
    model), in the JAX drawer's precisions: z = depth / shift in float32;
    the pinhole maths and the pose in float64 (numpy promotes the int64
    pixel indices minus a float32 scalar to float64), cast to float32 at
    the end; colors divided by 255 in float32 when their maximum passes
    1.5. Divisions take a divisor tensor on the device (CUDA multiplies
    by the reciprocal of a host scalar)."""
    dev = resolve_device(device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    f64 = torch.float64
    z = torch.from_numpy(np.asarray(depth, np.float32)).to(dev)
    z = z / scalar(depth_shift, torch.float32)
    valid = (z > 0) & (z < max_depth)
    ys, xs = torch.nonzero(valid, as_tuple=True)
    z = z[ys, xs].to(f64)
    fx, fy = float(intrinsic[0, 0]), float(intrinsic[1, 1])
    cx, cy = float(intrinsic[0, 2]), float(intrinsic[1, 2])
    pts_cam = torch.stack([(xs.to(f64) - cx) / scalar(fx, f64) * z,
                           (ys.to(f64) - cy) / scalar(fy, f64) * z, z,
                           torch.ones_like(z)], 1)
    pose = torch.from_numpy(np.asarray(cam2global, np.float64)).to(dev)
    pts = pts_cam @ pose.T
    if rgb is None:
        col = torch.full((len(pts), 3), 0.5, dtype=torch.float32,
                         device=dev)
    else:
        img = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        col = img[ys, xs, :3].to(torch.float32)
        if col.numel() == 0:
            # numpy's max of an empty array: the JAX drawer raises here
            raise ValueError('zero-size array to reduction operation '
                             'maximum which has no identity')
        if col.max() > 1.5:
            col = col / scalar(255.0, torch.float32)
    out = torch.cat([pts[:, :3].to(torch.float32), col], 1)
    return out.cpu().numpy()


class ContinuousDrawer:
    """Accumulating RGB-D detection drawer.

    Args:
        views: sequence of dicts with 'depth' (H, W), optional 'img'
            (H, W, 3), 'intrinsic' (4, 4 or 3, 3), 'cam2global' (4, 4),
            optional 'depth_shift'.
        boxes: optional (M, 9) boxes; per-view visible subsets can be
            given via each view's 'visible_instance_ids'.
        classes/labels: names + per-box label indices for coloring.
        device: where the back-projection and the box geometry run
            (`None`: the card).
    """

    def __init__(self, views: Sequence[Dict], boxes=None, labels=None,
                 classes: Sequence[str] = (), save_dir: str = './viz',
                 downsample: int = 1, device: Device = None):
        self.views = list(views)
        self.boxes = None if boxes is None else np.asarray(boxes)
        self.labels = labels
        self.vis = EmbodiedScanBaseVisualizer(classes, save_dir, device)
        self.device = self.vis.device
        self.save_dir = save_dir
        self.downsample = max(int(downsample), 1)
        self.idx = 0
        self.points: List[np.ndarray] = []
        self.shown_ids: set = set()

    # ------------------------------------------------------------------
    def step(self) -> Optional[Dict]:
        """Consume the next view; returns the accumulated scene state."""
        if self.idx >= len(self.views):
            return None
        v = self.views[self.idx]
        intr = np.asarray(v['intrinsic'], np.float32)
        pts = _backproject(v.get('img'), np.asarray(v['depth']),
                           intr, np.asarray(v['cam2global'], np.float32),
                           float(v.get('depth_shift', 1000.0)),
                           device=self.device)
        pts = pts[::self.downsample]
        self.points.append(pts)
        if 'visible_instance_ids' in v:
            self.shown_ids.update(int(i) for i in v['visible_instance_ids'])
        elif self.boxes is not None:
            self.shown_ids = set(range(len(self.boxes)))
        self.idx += 1
        cloud = (np.concatenate(self.points, 0) if self.points
                 else np.zeros((0, 6), np.float32))
        ids = sorted(self.shown_ids)
        boxes = (self.boxes[ids] if self.boxes is not None and ids
                 else None)
        labels = (np.asarray(self.labels)[ids]
                  if self.labels is not None and ids else None)
        return {'points': cloud, 'boxes': boxes, 'labels': labels,
                'view_index': self.idx - 1}

    def run_headless(self, prefix: str = 'frame') -> List[str]:
        """Render every step to PNG via the base visualizer."""
        outs = []
        while (state := self.step()) is not None:
            name = f'{prefix}_{state["view_index"]:04d}'
            self.vis.visualize_scene(state['points'], state['boxes'],
                                     state['labels'], name=name,
                                     show=False)
            outs.append(os.path.join(self.save_dir, name + '.png'))
        return outs

    def run_interactive(self) -> None:
        """open3d window; D advances a frame (reference begin/draw_next)."""
        import open3d as o3d
        vis = o3d.visualization.VisualizerWithKeyCallback()
        vis.create_window()

        def draw_next(v):
            state = self.step()
            if state is None:
                v.close()
                return False
            pc = o3d.geometry.PointCloud()
            pc.points = o3d.utility.Vector3dVector(state['points'][:, :3])
            pc.colors = o3d.utility.Vector3dVector(state['points'][:, 3:6])
            v.add_geometry(pc)
            if state['boxes'] is not None:
                for box in state['boxes']:
                    corners = nine_dof_to_corners(box, self.device)
                    ls = o3d.geometry.LineSet()
                    ls.points = o3d.utility.Vector3dVector(corners)
                    ls.lines = o3d.utility.Vector2iVector(
                        [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6],
                         [6, 7], [7, 4], [0, 4], [1, 5], [2, 6], [3, 7]])
                    v.add_geometry(ls)
            v.poll_events()
            return True

        vis.register_key_callback(ord('D'), draw_next)
        draw_next(vis)
        vis.run()
        vis.destroy_window()


class ContinuousOccupancyDrawer(ContinuousDrawer):
    """Accumulating occupancy drawer: each view carries a predicted
    'occupancy' (K, 4) array of (x_idx, y_idx, z_idx, label) voxels
    (the reference's gathered occupancy format); voxels are rendered as
    label-colored points at voxel centers (float64: the colors promote
    the concatenation, as in the JAX drawer)."""

    def __init__(self, views, voxel_size: float = 0.16, origin=(0, 0, 0),
                 classes: Sequence[str] = (), save_dir: str = './viz',
                 device: Device = None):
        super().__init__(views, classes=classes, save_dir=save_dir,
                         device=device)
        self.voxel_size = voxel_size
        self.origin = np.asarray(origin, np.float32)
        self.occ: Dict[tuple, int] = {}

    def step(self) -> Optional[Dict]:
        if self.idx >= len(self.views):
            return None
        v = self.views[self.idx]
        occ = np.asarray(v['occupancy'], np.int64).reshape(-1, 4)
        for x, y, z, lbl in occ:
            self.occ[(int(x), int(y), int(z))] = int(lbl)
        self.idx += 1
        if self.occ:
            keys = np.asarray(list(self.occ.keys()), np.float32)
            labels = np.asarray(list(self.occ.values()), np.int64)
            centers = self.origin + (keys + 0.5) * self.voxel_size
            colors = np.stack(
                [self.vis.colors[int(l)] for l in labels])
            pts = np.concatenate([centers, colors], 1)
        else:
            pts = np.zeros((0, 6), np.float32)
            labels = np.zeros((0, ), np.int64)
        return {'points': pts, 'boxes': None, 'labels': labels,
                'view_index': self.idx - 1}
