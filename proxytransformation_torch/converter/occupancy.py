"""Occupancy annotations from a labelled scene point cloud.

The port's own copy of proxytransformation_tpu/converter/occupancy.py
(the reference's `extract_occupancy_ann.py`): the points are quantized
onto a fixed grid and each occupied voxel keeps the most frequent label
of its points, as sparse (x, y, z, label) rows.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def extract_occupancy_annotations(points: np.ndarray, labels: np.ndarray,
                                  voxel_range: Sequence[float],
                                  grid_shape: Tuple[int, int, int],
                                  min_points: int = 1) -> np.ndarray:
    """(N, 3) points and their (N,) labels (> 0; 0 is empty) → (M, 4)
    int32 rows [x, y, z, majority label] of the voxels holding at least
    `min_points` points, in flat-index order; on a tie the smallest label
    wins."""
    X, Y, Z = grid_shape
    lo = np.asarray(voxel_range[:3], np.float32)
    hi = np.asarray(voxel_range[3:6], np.float32)
    vox = (hi - lo) / np.asarray([X, Y, Z], np.float32)
    q = np.floor((points - lo) / vox).astype(np.int64)
    ok = np.all((q >= 0) & (q < [X, Y, Z]), -1)
    q, lab = q[ok], np.asarray(labels)[ok]
    flat = (q[:, 0] * Y + q[:, 1]) * Z + q[:, 2]
    order = np.argsort(flat, kind='stable')
    flat, lab, q = flat[order], lab[order], q[order]
    starts = np.concatenate([[0], np.nonzero(np.diff(flat))[0] + 1,
                             [len(flat)]])
    out = []
    for s, e in zip(starts[:-1], starts[1:]):
        if e - s < min_points:
            continue
        vals, counts = np.unique(lab[s:e], return_counts=True)
        out.append([*q[s], vals[np.argmax(counts)]])
    return np.asarray(out, np.int32).reshape(-1, 4)
