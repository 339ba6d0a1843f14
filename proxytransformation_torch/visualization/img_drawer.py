"""2D image drawer: project 9-DoF boxes into a view and draw their
wireframes.

Counterpart of proxytransformation_tpu/visualization/img_drawer.py: the
corners come from `nine_dof_to_corners` on the drawer's device, the
projection, the depth test and the rounding of the endpoints are the JAX
drawer's numpy, and each edge is drawn by `raster.line`, which replays
`cv2.line` pixel for pixel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..device import resolve_device
from .color_selector import ColorMap
from .raster import line
from .utils import Device, _EDGES, nine_dof_to_corners


class ImgDrawer:

    def __init__(self, classes: Sequence[str] = (), device: Device = None):
        self.colors = ColorMap(classes)
        self.device = resolve_device(device)

    def draw_boxes(self, img: np.ndarray, boxes: np.ndarray,
                   proj_mat: np.ndarray,
                   labels: Optional[np.ndarray] = None,
                   thickness: int = 2) -> np.ndarray:
        """Draw projected box wireframes on a BGR image."""
        img = np.ascontiguousarray(np.asarray(img).copy())
        corners = nine_dof_to_corners(boxes, self.device)  # (M, 8, 3)
        ones = np.ones((*corners.shape[:2], 1), np.float32)
        pts4 = np.concatenate([corners, ones], -1)
        proj = pts4 @ np.asarray(proj_mat, np.float32).T  # (M, 8, 4)
        depth = proj[..., 2]
        uv = proj[..., :2] / np.clip(depth[..., None], 1e-6, None)
        for m in range(len(corners)):
            col = (np.array(self.colors[int(labels[m])]) * 255
                   if labels is not None else (0, 200, 0))
            col = tuple(int(c) for c in np.asarray(col).reshape(-1))[:3]
            for a, b in _EDGES:
                if depth[m, a] <= 0 or depth[m, b] <= 0:
                    continue
                pa = tuple(np.round(uv[m, a]).astype(int))
                pb = tuple(np.round(uv[m, b]).astype(int))
                line(img, pa, pb, col, thickness)
        return img

    def draw_text(self, img: np.ndarray, text: str,
                  org=(10, 30)) -> np.ndarray:
        """Refused: the JAX drawer writes `text` with cv2.putText in
        OpenCV's Hershey simplex font (scale 0.8, thickness 2), and the
        port has no copy of that font's glyph table."""
        raise NotImplementedError(
            "ImgDrawer.draw_text needs OpenCV's Hershey simplex font "
            "(cv2.FONT_HERSHEY_SIMPLEX), whose glyph table the port does "
            "not carry; draw the text with another tool")
