"""Test-time augmentation: merging the predictions of augmented copies.

Counterpart of proxytransformation_tpu/models/tta.py (reference
merge_augs.py:12-73 and the grounder's aug_test, detector :1031-1074):
each copy's boxes are mapped back to the original frame (flips undone,
then the scale, then a rotation), the copies are concatenated, and the
merged set is ranked by score. The grounding task applies no NMS: the
metric's top-k selects. Numpy in, numpy out; the box maths runs in
float32 on the CPU through `structures/boxes.py`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..structures.boxes import box_flip, box_transform


def _undo_aug(boxes: np.ndarray, meta: Dict) -> np.ndarray:
    """(N, 9) boxes predicted on an augmented copy → the original frame.
    `pcd_rotation_angle` (radians) is undone when a meta carries one; the
    Runner's metas carry flips and scales only."""
    b = torch.as_tensor(np.asarray(boxes, np.float32))
    if meta.get('pcd_horizontal_flip'):
        b = box_flip(b, 'X')
    if meta.get('pcd_vertical_flip'):
        b = box_flip(b, 'Y')
    scale = meta.get('pcd_scale_factor')
    if scale:
        b = torch.cat([b[:, :6] / scale, b[:, 6:]], -1)
    angle = meta.get('pcd_rotation_angle')
    if angle:
        c, s = np.cos(-angle), np.sin(-angle)
        rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1]], np.float32)
        b = box_transform(b, torch.from_numpy(rot))
    return b.numpy()


def merge_aug_bboxes_3d(aug_results: List[Dict], aug_metas: List[Dict],
                        test_cfg: Optional[Dict] = None) -> Dict:
    """Merge the predictions of one scene's augmented copies.

    aug_results: each {'bboxes_3d': (N, 9), 'scores_3d': (N,)};
    aug_metas: the transforms each copy was made with.
    Returns {'bboxes_3d', 'scores_3d'} by descending score, at most
    `test_cfg['max_num']` of them.
    """
    boxes, scores = [], []
    for res, meta in zip(aug_results, aug_metas):
        boxes.append(_undo_aug(np.asarray(res['bboxes_3d']).reshape(-1, 9),
                               meta))
        scores.append(np.asarray(res['scores_3d']).reshape(-1))
    boxes = np.concatenate(boxes, 0)
    scores = np.concatenate(scores, 0)
    max_num = (test_cfg or {}).get('max_num', len(scores))
    order = np.argsort(-scores)[:max_num]
    return {'bboxes_3d': boxes[order], 'scores_3d': scores[order]}
