"""Occupancy evaluation: per-class IoU, mIoU and the geometric IoU.

The port's own copy of proxytransformation_tpu/eval/occupancy_metric.py
(the reference `OccupancyMetric`, eval/metrics/occupancy_metric.py:
18-178): intersection and union of each class over dense voxel grids,
voxels labelled `ignore_index` left out; numpy on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..parallel.gather import evaluate_gathered
from ..utils.registry import METRICS


@METRICS.register_module()
class OccupancyMetric:

    def __init__(self, num_classes: int = 81, ignore_index: int = 255,
                 empty_label: int = 0, prefix: Optional[str] = None,
                 collect_device: str = 'cpu'):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.empty_label = empty_label
        self.results: list = []

    def process(self, data_batch, data_samples: Sequence[dict]) -> None:
        """Each sample's 'pred_occupancy' and 'gt_occupancy_dense' labels
        (arrays of one shape)."""
        for ds in data_samples:
            self.results.append((np.asarray(ds['pred_occupancy']),
                                 np.asarray(ds['gt_occupancy_dense'])))

    def compute_metrics(self, results=None) -> Dict[str, float]:
        """'iou_cls_c' of every class present in a prediction or the gt,
        'mIoU' over those but the empty class and 'IoU_geo' over all of
        them (0.0 when there is none)."""
        results = results if results is not None else self.results
        C = self.num_classes
        inter = np.zeros(C)
        union = np.zeros(C)
        for pred, gt in results:
            valid = gt != self.ignore_index
            for c in range(C):
                p = (pred == c) & valid
                g = (gt == c) & valid
                inter[c] += np.sum(p & g)
                union[c] += np.sum(p | g)
        iou = inter / np.maximum(union, 1)
        present = union > 0
        nonempty = present.copy()
        nonempty[self.empty_label] = False
        out = {f'iou_cls_{c}': float(iou[c]) for c in range(C) if present[c]}
        out['mIoU'] = float(iou[nonempty].mean()) if nonempty.any() else 0.0
        out['IoU_geo'] = float(iou[present].mean()) if present.any() else 0.0
        return out

    def evaluate(self, *_a, order=None, **_k) -> Dict[str, float]:
        """Every rank's results gathered (in `order` when given), scored
        on rank 0, its dict on every rank (`GroundingMetric.evaluate`)."""
        ret = evaluate_gathered(self.compute_metrics, self.results, order)
        self.results = []
        return ret
