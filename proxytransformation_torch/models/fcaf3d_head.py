"""FCAF3D anchor-free detection head: sparse FPN, box coding, targets,
losses and prediction.

Counterpart of proxytransformation_tpu/models/fcaf3d_head.py
(mmdet3d's `FCAF3DHead` / `FCAF3DHeadRotMat` in the reference): the
sparse FPN fine←coarse with score pruning (the machinery of MinkNeck:
each finer level is compacted to the 4·P voxels with the best parent
score, summed with the generative transpose of the coarser level, then
compacted to P), per-level centerness / classification / regression
with a learnable scale, face-distance box coding, and the FCAF3D target
assignment (inside a box → its best level by positive count → the top
centerness → the smallest box). The levels come out compacted to P rows
each, fine→coarse.

Parameters carry mmdet3d's names: `up_block_{i}` / `out_block_{i}` as
MinkNeck's, `conv_center`, `conv_reg`, `conv_cls` (1x1 convs: `kernel`
(C, out), `bias`) and `scales.{i}.scale` (mmcv's `Scale`, a 0-d
parameter).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse import (SENTINEL, SparseLevel, build_neighbor_map,
                          compact_topk, conv_plan, generative_transpose_apply,
                          generative_transpose_map, linearize, lookup_center)
from ..structures.rotation import (matrix_to_euler_angles,
                                   ortho_6d_to_matrix, rotation_3d_in_euler)
from .det_losses import binary_cross_entropy_with_logits, rotated_iou_3d_loss
from .losses import sigmoid_focal_loss
from .sparse_neck import _ConvCls, _out_block, _up_block, compact_by_score

PRIOR_BIAS = float(-np.log((1 - 0.01) / 0.01))
_FLOAT_MAX = 1e8


def get_face_distances(points: torch.Tensor,
                       boxes: torch.Tensor) -> torch.Tensor:
    """Distances from points (P, G, 3) to the 6 faces of boxes (P, G, 9)
    (broadcast pairs; each column g one box) → (P, G, 6): (dx_min,
    dx_max, dy_min, dy_max, dz_min, dz_max), in the box's frame (the
    reference rotates by the negated euler angles)."""
    shift = points - boxes[..., :3]
    shift = rotation_3d_in_euler(shift.transpose(0, 1),
                                 -boxes[0, :, 6:9]).transpose(0, 1)
    centers = boxes[..., :3] + shift
    half = boxes[..., 3:6] / 2
    dmin = centers - (boxes[..., :3] - half)
    dmax = (boxes[..., :3] + half) - centers
    return torch.stack([dmin[..., 0], dmax[..., 0], dmin[..., 1],
                        dmax[..., 1], dmin[..., 2], dmax[..., 2]], -1)


def get_centerness(face_distances: torch.Tensor) -> torch.Tensor:
    """sqrt(Π_axes min/max) of the face distances, in the reference's
    order of operations."""
    def lo_hi(a, b):
        pair = face_distances[..., a:b]
        return pair.amin(-1), torch.maximum(pair.amax(-1),
                                            pair.new_tensor(1e-8))

    (x0, x1), (y0, y1), (z0, z1) = lo_hi(0, 2), lo_hi(2, 4), lo_hi(4, 6)
    c = x0 / x1 * y0 / y1 * z0 / z1
    return torch.sqrt(torch.maximum(c, c.new_zeros(())))


class _Scale(nn.Module):
    """mmcv `Scale`: one learnable factor."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))


class FCAF3DHead(nn.Module):
    """`rot_param='euler'` (9 regression outputs: 6 face distances and 3
    euler angles) or 'ortho6d' (12: the 6-D rotation; `FCAF3DHeadRotMat`).
    """

    def __init__(self, num_classes: int = 284,
                 in_channels: Sequence[int] = (128, 256, 512, 1024),
                 out_channels: int = 128, pts_prune_threshold: int = 1000,
                 pts_assign_threshold: int = 27,
                 pts_center_threshold: int = 18, rot_param: str = 'euler'):
        super().__init__()
        if rot_param not in ('euler', 'ortho6d'):
            raise ValueError(f'rot_param {rot_param!r}: euler or ortho6d')
        self.num_classes = num_classes
        self.in_channels = tuple(in_channels)
        self.pts_prune_threshold = pts_prune_threshold
        self.pts_assign_threshold = pts_assign_threshold
        self.pts_center_threshold = pts_center_threshold
        self.rot_param = rot_param
        n = len(self.in_channels)
        for i in range(1, n):
            self.add_module(f'up_block_{i}',
                            _up_block(in_channels[i], in_channels[i - 1]))
        for i in range(n):
            self.add_module(f'out_block_{i}',
                            _out_block(in_channels[i], out_channels))
        self.conv_center = _ConvCls(out_channels, 1)
        self.conv_reg = _ConvCls(out_channels,
                                 12 if rot_param == 'ortho6d' else 9)
        self.conv_cls = _ConvCls(out_channels, num_classes)
        self.scales = nn.ModuleList(_Scale() for _ in range(n))

    @property
    def n_levels(self) -> int:
        return len(self.in_channels)

    # ------------------------------------------------------------------
    def forward(self, inputs: List[SparseLevel], self_maps=None,
                self_plans=None, train: bool = False):
        """FPN and the head's convs → (center (B, LP, 1), bbox (B, LP, R),
        cls (B, LP, C), points (B, LP, 3), mask (B, LP), level_ids (LP,)),
        each level compacted to P rows, fine→coarse. The coarsest level's
        out block reuses the backbone's self map and plan."""
        n = self.n_levels
        P = self.pts_prune_threshold
        outs = {}
        cur: Optional[SparseLevel] = None
        prune_score = None
        for i in range(n - 1, -1, -1):
            fine = inputs[i]
            if i < n - 1:
                pkeys = torch.where(
                    fine.mask, linearize(fine.coords // 2, cur.extent),
                    torch.full_like(fine.keys, SENTINEL))
                parent_idx = lookup_center(cur.keys, pkeys)
                hit = parent_idx >= 0
                ps = torch.gather(prune_score, 1,
                                  torch.where(hit, parent_idx, 0).long())
                ps = torch.where(hit, ps, torch.zeros_like(ps))
                lvl, (ps_c, ), _ = compact_topk(
                    fine, ps, min(4 * P, fine.capacity), extras=(ps, ))
                parent_idx_c, offset_id = generative_transpose_map(lvl, cur)
                nbr_up = build_neighbor_map(lvl, lvl, 3, 1)
                blk = getattr(self, f'up_block_{i + 1}')
                up = generative_transpose_apply(
                    cur.feats, parent_idx_c, offset_id, blk['0'].kernel,
                    lvl.mask)
                up = F.elu(blk['1'](up, lvl.mask, train))
                up = blk['3'](up, nbr_up, lvl.mask, conv_plan(nbr_up))
                up = F.elu(blk['4'](up, lvl.mask, train))
                lvl, _, _ = compact_topk(lvl._replace(feats=lvl.feats + up),
                                         ps_c, min(P, lvl.capacity))
                nbr = build_neighbor_map(lvl, lvl, 3, 1)
                plan = conv_plan(nbr)
            else:
                lvl = fine
                nbr = (self_maps[i] if self_maps is not None
                       else build_neighbor_map(lvl, lvl, 3, 1))
                plan = (self_plans[i] if self_plans is not None
                        else conv_plan(nbr))
            x, mask = lvl.feats, lvl.mask
            blk = getattr(self, f'out_block_{i}')
            out = F.elu(blk['1'](blk['0'](x, nbr, mask, plan), mask, train))
            center_pred = self.conv_center(out)
            cls_pred = self.conv_cls(out)
            reg = self.conv_reg(out)
            dist = torch.exp(self.scales[i].scale * reg[..., :6])
            bbox_pred = torch.cat(
                [torch.maximum(dist, dist.new_tensor(1e-3)), reg[..., 6:]], -1)
            best = cls_pred.amax(-1)
            prune_score = torch.where(mask, best, torch.zeros_like(best))
            outs[i] = compact_by_score(
                [center_pred, bbox_pred, cls_pred, lvl.world_xyz()],
                best, mask, min(P, lvl.capacity))
            cur = lvl

        cat = [torch.cat([outs[i][0][j] for i in range(n)], 1)
               for j in range(4)]
        masks = torch.cat([outs[i][1] for i in range(n)], 1)
        level_ids = torch.cat([
            torch.full((outs[i][1].shape[1], ), i, dtype=torch.int64,
                       device=masks.device) for i in range(n)])
        return (*cat, masks, level_ids)

    # ------------------------------------------------------------------
    def bbox_pred_to_bbox(self, points: torch.Tensor,
                          bbox_pred: torch.Tensor) -> torch.Tensor:
        """Face-distance coding → 9-DoF boxes (center, size, ZXY euler)."""
        d = bbox_pred[..., :6]
        if self.rot_param == 'ortho6d':
            euler = matrix_to_euler_angles(
                ortho_6d_to_matrix(bbox_pred[..., 6:9], bbox_pred[..., 9:12]),
                'ZXY')
        else:
            euler = bbox_pred[..., 6:9]
        shift = torch.stack([(d[..., 1] - d[..., 0]) / 2,
                             (d[..., 3] - d[..., 2]) / 2,
                             (d[..., 5] - d[..., 4]) / 2], -1)
        shift = rotation_3d_in_euler(shift.reshape(-1, 1, 3),
                                     euler.reshape(-1, 3))[:, 0, :]
        center = points + shift.reshape(points.shape)
        size = torch.stack([d[..., 0] + d[..., 1], d[..., 2] + d[..., 3],
                            d[..., 4] + d[..., 5]], -1)
        return torch.cat([center, size, euler], -1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def get_targets(self, points: torch.Tensor, level_ids: torch.Tensor,
                    pts_mask: torch.Tensor, gt_bboxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_mask: torch.Tensor):
        """FCAF3D assignment of one sample: points (P, 3), level_ids (P,),
        pts_mask (P,), gt_bboxes (G, 9), gt_labels (G,), gt_mask (G,) →
        center_targets (P,), bbox_targets (P, 9), cls_targets (P,) (-1:
        background)."""
        P, G = points.shape[0], gt_bboxes.shape[0]
        boxes = gt_bboxes[None].expand(P, G, 9)
        face = get_face_distances(points[:, None, :].expand(P, G, 3), boxes)
        inside = ((face.amin(-1) > 0) & gt_mask[None, :]
                  & pts_mask[:, None])

        # the best level of each box: the last before the first level with
        # fewer than pts_assign_threshold points inside, else the coarsest
        L = self.n_levels
        onehot = F.one_hot(level_ids, L).float()                 # (P, L)
        n_pos = onehot.T @ inside.float()                        # (L, G)
        lower = n_pos < self.pts_assign_threshold
        lower_index = torch.clamp(lower.int().argmax(0) - 1, min=0)
        best_level = torch.where((~lower).all(0),
                                 torch.full_like(lower_index, L - 1),
                                 lower_index)
        level_cond = level_ids[:, None] == best_level[None, :]

        chosen = inside & level_cond
        centerness = torch.where(chosen, get_centerness(face),
                                 face.new_tensor(-1.0))
        k = min(self.pts_center_threshold + 1, P)
        top_c = torch.topk(centerness.T, k, dim=1).values[:, -1]  # (G,)
        topk_cond = centerness > top_c[None, :]

        size = gt_bboxes[:, 3:6]
        volumes = (size[:, 0] * size[:, 1] * size[:, 2])[None].expand(P, G)
        volumes = torch.where(chosen & topk_cond, volumes,
                              volumes.new_tensor(_FLOAT_MAX))
        min_vol, min_ind = volumes.min(-1)
        center_targets = torch.gather(centerness, 1, min_ind[:, None])[:, 0]
        cls_targets = torch.where(min_vol >= _FLOAT_MAX,
                                  torch.full_like(min_ind, -1),
                                  gt_labels[min_ind].long())
        return center_targets, gt_bboxes[min_ind], cls_targets

    # ------------------------------------------------------------------
    def loss(self, head_outs, gt_bboxes, gt_labels, gt_mask
             ) -> Dict[str, torch.Tensor]:
        """'loss_center' (BCE on centerness), 'loss_bbox' (rotated IoU,
        centerness-weighted) and 'loss_cls' (focal), each averaged over
        the batch (the reference's loss weights are 1).

        Each sample's normalisers (`avg`, `denom`) are its own, as in the
        JAX package, which computes them inside its per-sample vmap
        (fcaf3d_head.py:257-288); the one reduction over the batch is the
        mean. Under data parallelism every rank holds an equal slice of
        the global batch (the loader's rank slices), so the local mean is
        local_sum / (global B / world size) and the rank mean of the
        losses and gradients is the global batch's: nothing is synced."""
        centers, bboxes, clses, points, masks, level_ids = head_outs
        losses = [[], [], []]
        for b in range(centers.shape[0]):
            c, bb, cl, p, m = (centers[b], bboxes[b], clses[b], points[b],
                               masks[b])
            ct, bt, clt = self.get_targets(p, level_ids, m, gt_bboxes[b],
                                           gt_labels[b], gt_mask[b])
            pos = (clt >= 0) & m
            avg = torch.clamp(pos.sum(), min=1)
            onehot = (F.one_hot(torch.where(clt >= 0, clt, 0),
                                self.num_classes).float()
                      * (clt >= 0)[:, None])
            losses[2].append(sigmoid_focal_loss(
                cl, onehot, m[:, None].float(), avg_factor=avg))
            losses[0].append(binary_cross_entropy_with_logits(
                c[:, 0], ct, pos.float(), avg_factor=avg))
            w = ct * pos
            denom = torch.maximum(w.sum(), w.new_tensor(1e-6))
            losses[1].append(rotated_iou_3d_loss(
                self.bbox_pred_to_bbox(p, bb), bt, weight=w,
                avg_factor=denom))
        return {'loss_center': torch.stack(losses[0]).mean(),
                'loss_bbox': torch.stack(losses[1]).mean(),
                'loss_cls': torch.stack(losses[2]).mean()}

    # ------------------------------------------------------------------
    def predict(self, head_outs):
        """Decoded boxes (B, LP, 9), per-class scores (B, LP, C) and the
        mask; the NMS is `ops/nms3d.py::multiclass_nms`."""
        centers, bboxes, clses, points, masks, _ = head_outs
        scores = torch.sigmoid(clses) * torch.sigmoid(centers)
        return self.bbox_pred_to_bbox(points, bboxes), scores, masks


def multiclass_nms_host(boxes: np.ndarray, scores: np.ndarray,
                        mask: np.ndarray, score_thr: float = 0.01,
                        iou_thr: float = 0.5, nms_pre: int = 1000,
                        use_rotation: bool = True):
    """Per-class greedy NMS of one scene on the host (numpy and `nms3d`),
    the reference's loop of one nms3d call a class. Returns (boxes,
    scores, labels)."""
    from ..ops.nms3d import nms3d
    boxes = boxes[mask]
    scores = scores[mask]
    if len(boxes) > nms_pre:
        keep = np.argsort(-scores.max(-1))[:nms_pre]
        boxes, scores = boxes[keep], scores[keep]
    out_b, out_s, out_l = [], [], []
    for c in range(scores.shape[1]):
        ids = scores[:, c] > score_thr
        if not ids.any():
            continue
        cb, cs = boxes[ids], scores[ids, c]
        keep = nms3d(torch.from_numpy(np.ascontiguousarray(cb)),
                     torch.from_numpy(np.ascontiguousarray(cs)),
                     iou_threshold=iou_thr,
                     use_rotation=use_rotation).numpy()
        out_b.append(cb[keep])
        out_s.append(cs[keep])
        out_l.append(np.full(int(keep.sum()), c, np.int64))
    if out_b:
        return (np.concatenate(out_b), np.concatenate(out_s),
                np.concatenate(out_l))
    return (np.zeros((0, boxes.shape[-1] if len(boxes) else 9)),
            np.zeros((0, )), np.zeros((0, ), np.int64))


class FCAF3DHeadRotMat(FCAF3DHead):
    """The 6-D rotation variant (12 regression outputs)."""

    def __init__(self, **kw):
        super().__init__(rot_param='ortho6d', **kw)
