"""EmbodiedScan grounding metric (Acc@0.25 / Acc@0.5 buckets).

The port's own copy of proxytransformation_tpu/eval/grounding_metric.py
(the reference `GroundingMetric`, eval/metrics/grounding_metric.py:
14-193): per sample, take the top-k (default 10, env `TOP_K`) predicted
boxes by score, mark the sample found if any of them overlaps a gt box
with IoU > threshold, and bucket into Easy/Hard, View-Dep/Indep,
Unique/Multi and Overall. The IoU is the port's exact oriented-box IoU
(`ops/box3d_overlap.py::box3d_iou`), on the CPU.

`format_only=True` dumps the top-20 boxes per sample to
`test_results.json` for the leaderboard (reference :171-189).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.box3d_overlap import box3d_iou
from ..utils.registry import METRICS


def ground_eval(gt_annos: Sequence[dict], det_annos: Sequence[dict],
                iou_thr=(0.25, 0.5), top_k: int = 10,
                logger=None) -> Dict[str, float]:
    """Offline scorer (mirror of reference ground_eval :73-155).

    Each det_anno: {'bboxes_3d': (Q, 9) array, 'target_scores_3d': (Q,)}.
    Each gt_anno: {'gt_bboxes_3d': (G, 9), 'is_hard', 'is_view_dep',
    'is_unique'}.
    """
    assert len(det_annos) == len(gt_annos)
    object_types = ['Easy', 'Hard', 'View-Dep', 'View-Indep', 'Unique',
                    'Multi', 'Overall']
    pred = {f'{o}@{t}': 0 for t in iou_thr for o in object_types}
    gt = {f'{o}@{t}': 1e-14 for t in iou_thr for o in object_types}

    for det_anno, gt_anno in zip(det_annos, gt_annos):
        scores = np.asarray(det_anno['target_scores_3d'])
        bboxes = np.asarray(det_anno['bboxes_3d'])
        gt_bboxes = np.asarray(gt_anno['gt_bboxes_3d']).reshape(-1, 9)
        order = np.argsort(-scores)[:top_k]
        top = bboxes[order]
        if len(gt_bboxes) == 0:
            iou = np.zeros((len(top), 1))
        else:
            iou = box3d_iou(torch.as_tensor(top, device='cpu'),
                            torch.as_tensor(gt_bboxes, device='cpu')).numpy()
        for t in iou_thr:
            found = int((iou > t).any())
            buckets = [
                ('View-Dep' if gt_anno['is_view_dep'] else 'View-Indep'),
                ('Hard' if gt_anno['is_hard'] else 'Easy'),
                ('Unique' if gt_anno['is_unique'] else 'Multi'),
                'Overall',
            ]
            for b in buckets:
                gt[f'{b}@{t}'] += 1
                pred[f'{b}@{t}'] += found

    ret = {}
    lines = []
    for t in iou_thr:
        row = []
        for o in object_types:
            key = f'{o}@{t}'
            ret[key] = pred[key] / max(gt[key], 1)
            row.append(f'{o}: {ret[key]:.4f}')
        lines.append(' | '.join(row))
    msg = '\n'.join(lines)
    if logger is not None:
        logger.info('\n' + msg)
    else:
        print(msg)
    return ret


@METRICS.register_module()
class GroundingMetric:
    """Accumulating metric with the reference's process/compute split."""

    def __init__(self, iou_thr: List[float] = (0.25, 0.5),
                 prefix: Optional[str] = None, format_only: bool = False,
                 result_dir: str = '', top_k: int = 10,
                 collect_device: str = 'cpu'):
        self.iou_thr = ([iou_thr] if isinstance(iou_thr, float)
                        else list(iou_thr))
        self.format_only = format_only
        self.result_dir = result_dir
        self.top_k = int(os.environ.get('TOP_K', top_k))
        self.results: list = []

    def process(self, data_batch, data_samples: Sequence[dict]) -> None:
        for ds in data_samples:
            self.results.append((ds['eval_ann_info'],
                                 ds['pred_instances_3d']))

    def compute_metrics(self, results=None) -> Dict[str, float]:
        results = results if results is not None else self.results
        annotations = [r[0] for r in results]
        preds = [r[1] for r in results]
        if self.format_only:
            dump = []
            for p in preds:
                scores = np.asarray(p['target_scores_3d'])
                boxes = np.asarray(p['bboxes_3d'])
                order = np.argsort(-scores)[:20]
                dump.append({'bboxes_3d': boxes[order].tolist(),
                             'scores_3d': scores[order].tolist()})
            out = os.path.join(self.result_dir, 'test_results.json')
            with open(out, 'w') as f:
                json.dump(dump, f)
            return {}
        return ground_eval(annotations, preds, self.iou_thr, self.top_k)

    def evaluate(self, *_args, **_kw) -> Dict[str, float]:
        # one host: the JAX package's `allgather_objects` (the reference's
        # collect_device='cpu', eval/metrics/grounding_metric.py:43-44) is
        # the identity there, and the port runs on one host; gathering
        # across hosts waits for its `parallel/` (ROADMAP item 14)
        ret = self.compute_metrics(self.results)
        self.results = []
        return ret
