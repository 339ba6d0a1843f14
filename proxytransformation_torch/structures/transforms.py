"""Result and ROI packaging of boxes (the JAX package's structures/
transforms.py, reference structures/ops/transforms.py:1-76), on numpy
arrays."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .boxes import box_flip


def bbox3d_mapping_back(bboxes: np.ndarray, scale_factor: float,
                        flip_horizontal: bool,
                        flip_vertical: bool) -> np.ndarray:
    """(N, 9) boxes from an augmented (test) frame back to the original:
    the flips undone, then the uniform scale, in float32."""
    b = torch.as_tensor(np.asarray(bboxes, np.float32))
    if flip_horizontal:
        b = box_flip(b, 'X')
    if flip_vertical:
        b = box_flip(b, 'Y')
    return torch.cat([b[:, :6] / scale_factor, b[:, 6:]], dim=-1).numpy()


def bbox3d2roi(bbox_list: Sequence[np.ndarray]) -> np.ndarray:
    """Per-sample boxes → (M, 1+C) rois with a leading batch-index
    column."""
    rois = []
    for idx, boxes in enumerate(bbox_list):
        boxes = np.asarray(boxes, np.float32).reshape(len(boxes), -1)
        ind = np.full((len(boxes), 1), idx, np.float32)
        rois.append(np.concatenate([ind, boxes], axis=-1))
    if not rois:
        return np.zeros((0, 10), np.float32)
    return np.concatenate(rois, axis=0)


def bbox3d2result(bboxes: np.ndarray, scores: np.ndarray,
                  labels: np.ndarray,
                  attrs: Optional[np.ndarray] = None) -> Dict:
    """One sample's detections as the result dict the metrics and dumps
    read."""
    out = {
        'bboxes_3d': np.asarray(bboxes),
        'scores_3d': np.asarray(scores),
        'labels_3d': np.asarray(labels),
    }
    if attrs is not None:
        out['attr_labels'] = np.asarray(attrs)
    return out
