"""3D NMS over oriented boxes.

Counterpart of proxytransformation_tpu/ops/nms3d.py (mmcv's `nms3d` /
`nms3d_normal` in the reference): the IoU matrix comes from the exact
box IoU (`ops/box3d_overlap.py`, or the axis-aligned one), and the
greedy suppression is a loop of fixed length on the device, with no host
sync inside it. Where the JAX package keeps an index (`argsort`,
`top_k`), ties go to the lower index here too (`torch.argsort(...,
stable=True)`, `topk_stable`); `argmax` takes the first maximum on both
sides.
"""
from __future__ import annotations

from typing import Optional

import torch

from .box3d_overlap import box3d_iou
from .sparse import topk_stable


def _aabb_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU ignoring rotation (nms3d_normal semantics)."""
    min1 = boxes1[:, :3] - boxes1[:, 3:6] / 2
    max1 = boxes1[:, :3] + boxes1[:, 3:6] / 2
    min2 = boxes2[:, :3] - boxes2[:, 3:6] / 2
    max2 = boxes2[:, :3] + boxes2[:, 3:6] / 2
    lo = torch.maximum(min1[:, None], min2[None])
    hi = torch.minimum(max1[:, None], max2[None])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    v1 = torch.prod(max1 - min1, dim=-1)
    v2 = torch.prod(max2 - min2, dim=-1)
    return inter / torch.clamp(v1[:, None] + v2[None] - inter, min=1e-8)


def _iou_matrix(boxes: torch.Tensor, use_rotation: bool) -> torch.Tensor:
    return box3d_iou(boxes, boxes) if use_rotation else _aabb_iou(boxes,
                                                                  boxes)


def suppress_sorted(iou: torch.Tensor, smask: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Greedy suppression over boxes already in descending score order:
    (N, N) IoU and (N,) validity → (N,) keep, in that order."""
    N = iou.shape[0]
    ar = torch.arange(N, device=iou.device)
    over = iou > iou_threshold
    keep = smask.clone()
    for i in range(N):
        alive = keep[i] & smask[i]
        keep &= ~(over[i] & (ar > i) & alive)
    return keep


def nms3d(boxes: torch.Tensor, scores: torch.Tensor,
          iou_threshold: float = 0.5, mask: Optional[torch.Tensor] = None,
          use_rotation: bool = True) -> torch.Tensor:
    """Greedy NMS of (N, 9) boxes by (N,) scores → (N,) bool keep."""
    N = boxes.shape[0]
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=boxes.device)
    key = torch.where(mask, -scores, torch.full_like(scores, float('inf')))
    order = torch.argsort(key, stable=True)
    keep = suppress_sorted(_iou_matrix(boxes[order], use_rotation),
                           mask[order], iou_threshold)
    out = torch.empty_like(keep)
    out[order] = keep
    return out


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   mask: torch.Tensor, score_thr: float = 0.01,
                   iou_thr: float = 0.5, nms_pre: int = 1000,
                   max_out: int = 256, use_rotation: bool = True):
    """Per-class greedy NMS of a batch of scenes, on the device.

    boxes (B, N, 9), scores (B, N, C) (post-sigmoid), mask (B, N) →
    (boxes (B, max_out, 9), scores (B, max_out), labels (B, max_out)
    int32, valid (B, max_out) bool), score-sorted, label -1 and zeros at
    padding. The top `nms_pre` candidates by best class score share one
    exact IoU matrix; each of `max_out` iterations commits the best
    still-alive candidate of every (scene, class) and suppresses its
    overlaps of that class (exact per class up to `max_out` kept boxes,
    as the JAX package's while_loop). Iterations after every class runs
    out write what the buffers already hold, so the loop runs all
    `max_out` of them without asking the device whether to stop.
    """
    B, N, C = scores.shape
    P = min(nms_pre, N)
    dev = boxes.device
    ninf = torch.tensor(float('-inf'), device=dev)
    best = torch.where(mask, scores.amax(-1), ninf)
    keep = topk_stable(best, P)                              # (B, P)
    cb = torch.take_along_dim(boxes.float(), keep[..., None], dim=1)
    cs = torch.take_along_dim(scores.float(), keep[..., None], dim=1)
    cm = torch.gather(mask, 1, keep)
    suppress = torch.stack([_iou_matrix(cb[b], use_rotation) > iou_thr
                            for b in range(B)])              # (B, P, P)

    cs_t = cs.transpose(1, 2)                                # (B, C, P)
    alive = (cs_t > score_thr) & cm[:, None, :]
    T = max_out
    out_idx = torch.full((B, C, T), -1, dtype=torch.int64, device=dev)
    out_scr = torch.full((B, C, T), float('-inf'), device=dev)
    for t in range(T):
        s = torch.where(alive, cs_t, ninf)
        pscore, pick = s.max(dim=2)                          # (B, C)
        ok = pscore > ninf
        rows = torch.take_along_dim(suppress, pick[..., None], dim=1)
        alive &= ~(ok[..., None] & rows)
        out_idx[..., t] = torch.where(ok, pick, -1)
        out_scr[..., t] = torch.where(ok, pscore, ninf)

    flat_scr = out_scr.reshape(B, C * T)
    flat_idx = out_idx.reshape(B, C * T)
    sel = topk_stable(flat_scr, T)                           # (B, T)
    top_scr = torch.gather(flat_scr, 1, sel)
    sel_idx = torch.gather(flat_idx, 1, sel)
    valid = top_scr > ninf
    rows = torch.where(valid, sel_idx, 0)
    out_boxes = torch.where(valid[..., None],
                            torch.take_along_dim(cb, rows[..., None], dim=1),
                            torch.zeros((), device=dev))
    labels = torch.where(valid, (sel // T).to(torch.int32),
                         torch.full_like(sel, -1, dtype=torch.int32))
    out_scores = torch.where(valid, top_scr, torch.zeros((), device=dev))
    return out_boxes, out_scores, labels, valid
