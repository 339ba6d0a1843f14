"""Scene visualizer (open3d when available, matplotlib / PLY otherwise).

Counterpart of proxytransformation_tpu/visualization/base_visualizer.py
(reference: visualizer/base_visualizer.py:16-276): a scene's point cloud
with its 9-DoF boxes, NMS-filtered by the port's `ops/nms3d.py::nms3d` on
the visualizer's device, rendered interactively through open3d or
headlessly to a PNG of three matplotlib projections, or dumped to PLY.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nms3d import nms3d
from .color_selector import ColorMap
from .utils import Device, box_lines, to_open3d_box


class EmbodiedScanBaseVisualizer:

    def __init__(self, classes: Sequence[str] = (), save_dir: str = './viz',
                 device: Device = None):
        self.colors = ColorMap(classes)
        self.device = resolve_device(device)
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def visualize_scene(self, points: np.ndarray,
                        boxes: Optional[np.ndarray] = None,
                        labels: Optional[np.ndarray] = None,
                        scores: Optional[np.ndarray] = None,
                        nms_iou: float = 0.15,
                        name: str = 'scene',
                        show: bool = False):
        """Render and save a scene.

        Args:
            points: (N, 3[+3 rgb]) point cloud.
            boxes: optional (M, 9) boxes.
            labels/scores: optional per-box.
        Returns the saved file path.
        """
        boxes = self._nms_filter(boxes, scores, nms_iou)
        try:
            import open3d  # noqa: F401
            return self._render_open3d(points, boxes, labels, name, show)
        except ImportError:
            return self._render_matplotlib(points, boxes, labels, name)

    def _nms_filter(self, boxes, scores, iou_thr):
        if boxes is None or scores is None or len(boxes) == 0:
            return boxes
        keep = nms3d(
            torch.as_tensor(np.asarray(boxes, np.float32),
                            device=self.device),
            torch.as_tensor(np.asarray(scores, np.float32),
                            device=self.device),
            iou_threshold=iou_thr)
        return np.asarray(boxes)[keep.cpu().numpy()]

    # ------------------------------------------------------------------
    def _render_matplotlib(self, points, boxes, labels, name):
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        points = np.asarray(points)
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        planes = [(0, 1, 'top (xy)'), (0, 2, 'front (xz)'),
                  (1, 2, 'side (yz)')]
        sub = points[::max(len(points) // 20000, 1)]
        color = sub[:, 3:6] / 255.0 if points.shape[1] >= 6 else 'gray'
        for ax, (i, j, title) in zip(axes, planes):
            ax.scatter(sub[:, i], sub[:, j], s=0.2, c=color)
            if boxes is not None and len(boxes):
                segs = box_lines(boxes, self.device)  # (M, 12, 2, 3)
                for m in range(len(segs)):
                    col = (self.colors[int(labels[m])] if labels is not None
                           else (0, 0.8, 0))
                    for a, b in segs[m]:
                        ax.plot([a[i], b[i]], [a[j], b[j]], c=col, lw=0.8)
            ax.set_title(title)
            ax.set_aspect('equal')
        out = os.path.join(self.save_dir, f'{name}.png')
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out

    def _render_open3d(self, points, boxes, labels, name, show):
        import open3d as o3d
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(np.asarray(points[:, :3]))
        if points.shape[1] >= 6:
            pcd.colors = o3d.utility.Vector3dVector(
                np.asarray(points[:, 3:6]) / 255.0)
        geoms = [pcd]
        if boxes is not None:
            for m, b in enumerate(np.asarray(boxes)):
                col = (self.colors[int(labels[m])] if labels is not None
                       else (0, 0.8, 0))
                geoms.append(to_open3d_box(b, col, self.device))
        if show:
            o3d.visualization.draw_geometries(geoms)
        out = os.path.join(self.save_dir, f'{name}.ply')
        o3d.io.write_point_cloud(out, pcd)
        return out

    # ------------------------------------------------------------------
    def export_ply(self, points: np.ndarray, name: str = 'scene'):
        """Headless PLY dump (ASCII, no dependencies)."""
        points = np.asarray(points)
        out = os.path.join(self.save_dir, f'{name}.ply')
        has_rgb = points.shape[1] >= 6
        with open(out, 'w') as f:
            f.write('ply\nformat ascii 1.0\n'
                    f'element vertex {len(points)}\n'
                    'property float x\nproperty float y\nproperty float z\n')
            if has_rgb:
                f.write('property uchar red\nproperty uchar green\n'
                        'property uchar blue\n')
            f.write('end_header\n')
            for p in points:
                if has_rgb:
                    f.write(f'{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} '
                            f'{int(p[3])} {int(p[4])} {int(p[5])}\n')
                else:
                    f.write(f'{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n')
        return out
