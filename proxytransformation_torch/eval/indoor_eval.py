"""Indoor detection AP (VOC-style area AP with the exact 9-DoF IoU).

The port's own copy of proxytransformation_tpu/eval/indoor_eval.py (the
reference's `average_precision`, `eval_det_cls`, `indoor_eval` and
`IndoorDetMetric`, eval/indoor_eval.py and eval/metrics/det_metric.py):
greedy matching in descending confidence, area-mode AP, predicted boxes
thinner than 2e-4 m² on a face clamped to 2 cm edges, per-class AP and
recall at each IoU threshold, and their means. numpy, with the IoU of
`ops/box3d_overlap.py::box3d_iou` on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.box3d_overlap import box3d_iou
from ..parallel.gather import evaluate_gathered
from ..utils.registry import METRICS


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> np.ndarray:
    """Area under the precision envelope of each recall curve."""
    if mode != 'area':
        raise ValueError(mode)
    if recalls.ndim == 1:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    zeros = np.zeros((num_scales, 1), recalls.dtype)
    ones = np.ones((num_scales, 1), recalls.dtype)
    mrec = np.hstack((zeros, recalls, ones))
    mpre = np.hstack((zeros, precisions, zeros))
    for i in range(mpre.shape[1] - 1, 0, -1):
        mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
    for i in range(num_scales):
        ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
        ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    return ap


def _pairwise_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), np.float32)
    return box3d_iou(torch.as_tensor(boxes1, dtype=torch.float32),
                     torch.as_tensor(boxes2, dtype=torch.float32)).numpy()


def eval_det_cls(pred: Dict, gt: Dict, iou_thr: Sequence[float]):
    """One class's PR curves: pred img_id → [(box9, score)], gt img_id →
    (G, 9) → per threshold (recall curve, precision curve, ap)."""
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        boxes = np.asarray(boxes, np.float32).reshape(-1, 9)
        npos += len(boxes)
        class_recs[img_id] = {'bbox': boxes,
                              'det': [[False] * len(boxes) for _ in iou_thr]}

    image_ids, confidence, ious = [], [], []
    for img_id, dets in pred.items():
        if len(dets) == 0:
            continue
        boxes = np.stack([np.asarray(b, np.float32) for b, _ in dets])
        w, l, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
        thin = (w * l < 2e-4) | (w * h < 2e-4) | (h * l < 2e-4)
        boxes[:, 3:6] = np.where(thin[:, None],
                                 np.clip(boxes[:, 3:6], 2e-2, None),
                                 boxes[:, 3:6])
        gt_boxes = class_recs.get(img_id, {'bbox': np.zeros((0, 9))})['bbox']
        iou_mat = _pairwise_iou(boxes, gt_boxes)
        for i, (_, score) in enumerate(dets):
            image_ids.append(img_id)
            confidence.append(score)
            ious.append(iou_mat[i])

    if len(image_ids) == 0:
        return [(np.zeros(1), np.zeros(1), 0.0) for _ in iou_thr]

    order = np.argsort(-np.asarray(confidence))
    image_ids = [image_ids[i] for i in order]
    ious = [ious[i] for i in order]

    nd = len(image_ids)
    tp_thr = [np.zeros(nd) for _ in iou_thr]
    fp_thr = [np.zeros(nd) for _ in iou_thr]
    for d, img_id in enumerate(image_ids):
        rec = class_recs.get(img_id)
        iou_row = ious[d]
        iou_max, jmax = -np.inf, -1
        if rec is not None and len(iou_row):
            jmax = int(np.argmax(iou_row))
            iou_max = iou_row[jmax]
        for t_i, t in enumerate(iou_thr):
            if iou_max > t and rec is not None and not rec['det'][t_i][jmax]:
                tp_thr[t_i][d] = 1.0
                rec['det'][t_i][jmax] = True
            else:
                fp_thr[t_i][d] = 1.0

    out = []
    for t_i in range(len(iou_thr)):
        fp = np.cumsum(fp_thr[t_i])
        tp = np.cumsum(tp_thr[t_i])
        recall = tp / max(float(npos), 1e-14)
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        out.append((recall, precision, average_precision(recall,
                                                         precision)[0]))
    return out


def indoor_eval(gt_annos: Sequence[dict], dt_annos: Sequence[dict],
                metric: Sequence[float], label2cat: Dict[int, str],
                logger=None) -> Dict[str, float]:
    """Per-class AP / recall and their means ('mAP_0.25', 'mAR_0.25', ...)
    over samples: gt {'gt_bboxes_3d' (G, 9), 'gt_labels_3d' (G,)}, dt
    {'bboxes_3d' (D, 9), 'scores_3d' (D,), 'labels_3d' (D,)}."""
    pred: Dict[int, Dict] = {}
    gt: Dict[int, Dict] = {}
    for img_id, (gt_anno, dt_anno) in enumerate(zip(gt_annos, dt_annos)):
        labels = np.asarray(dt_anno.get('labels_3d', []), np.int64)
        boxes = np.asarray(dt_anno.get('bboxes_3d', np.zeros((0, 9))))
        scores = np.asarray(dt_anno.get('scores_3d', []))
        for i in range(len(labels)):
            pred.setdefault(int(labels[i]), {}).setdefault(img_id, []) \
                .append((boxes[i], float(scores[i])))
        g_labels = np.asarray(gt_anno.get('gt_labels_3d', []), np.int64)
        g_boxes = np.asarray(gt_anno.get('gt_bboxes_3d',
                                         np.zeros((0, 9)))).reshape(-1, 9)
        for i in range(len(g_labels)):
            gt.setdefault(int(g_labels[i]), {}).setdefault(img_id, []) \
                .append(g_boxes[i])
    # every (gt class, sample) pair on both sides
    for label in gt:
        for img_id in range(len(gt_annos)):
            pred.setdefault(label, {}).setdefault(img_id, [])
            gt[label].setdefault(img_id, [])

    ret: Dict[str, float] = {}
    aps = {t: [] for t in metric}
    recalls = {t: [] for t in metric}
    for label, gt_cls in gt.items():
        gt_arrays = {k: np.asarray(v, np.float32).reshape(-1, 9)
                     for k, v in gt_cls.items()}
        results = eval_det_cls(pred[label], gt_arrays, metric)
        cat = label2cat.get(label, str(label))
        for t_i, t in enumerate(metric):
            rec_curve, _, ap = results[t_i]
            ret[f'{cat}_AP_{t:.2f}'] = float(ap)
            rec = float(rec_curve[-1]) if len(rec_curve) else 0.0
            ret[f'{cat}_rec_{t:.2f}'] = rec
            aps[t].append(ap)
            recalls[t].append(rec)
    for t in metric:
        ret[f'mAP_{t:.2f}'] = float(np.mean(aps[t])) if aps[t] else 0.0
        ret[f'mAR_{t:.2f}'] = (float(np.mean(recalls[t])) if recalls[t]
                               else 0.0)
    if logger is not None:
        logger.info({k: round(v, 4) for k, v in ret.items()
                     if k.startswith('mA')})
    return ret


@METRICS.register_module()
class IndoorDetMetric:
    """Accumulates (eval_ann_info, pred_instances_3d) per sample and scores
    them with `indoor_eval` (label names: the labels' numbers)."""

    def __init__(self, iou_thr: Sequence[float] = (0.25, 0.5),
                 collect_device: str = 'cpu', prefix: Optional[str] = None):
        self.iou_thr = list(iou_thr)
        self.results: list = []

    def process(self, data_batch, data_samples: Sequence[dict]) -> None:
        for ds in data_samples:
            self.results.append((ds['eval_ann_info'],
                                 ds['pred_instances_3d']))

    def compute_metrics(self, results=None, label2cat=None):
        results = results if results is not None else self.results
        return indoor_eval([r[0] for r in results], [r[1] for r in results],
                           self.iou_thr, label2cat or {})

    def evaluate(self, *_a, order=None, **_k):
        """Every rank's results gathered (in `order` when given), scored
        on rank 0, its dict on every rank (`GroundingMetric.evaluate`)."""
        ret = evaluate_gathered(self.compute_metrics, self.results, order)
        self.results = []
        return ret
