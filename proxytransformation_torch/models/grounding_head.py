"""Grounding head: contrastive query-token logits, 9-DoF boxes, and the
DETR loss with Hungarian matching.

Counterpart of proxytransformation_tpu/models/grounding_head.py::
GroundingHead (branches, `bbox_pred_to_bbox`, `loss`, `predict`). The
flagship shares one prediction layer across decoder layers, so the module
holds `cls_branches.0` and `reg_branches.0` only, the keys a reference
checkpoint stores. The loss has the flagship config's settings
(configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py:72-99):
focal classification, the decoupled 4-group corner-Chamfer box loss with
weights (.2, .2, .2, .4), match costs focal 1 + L1 2 + IoU 2, no
background class weight.

The two normalisers are the global batch's, as under the JAX package's
jitted step on a sharded batch (its `axis_name` form, JAX
grounding_head.py:233-275, spells the same out with `pmean`): with more
than one rank each is max(global count, 1) over the world size
(`parallel.synced_normaliser`, one all-reduce for every layer's two), so
the rank mean of the losses and of their gradients is the one-process
global loss's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.box3d_overlap import box3d_iou_aligned
from ..ops.hungarian import hungarian_assign
from ..parallel.dist import synced_normaliser
from ..structures.rotation import matrix_to_euler_angles, ortho_6d_to_matrix
from .layers import linear
from .losses import (bbox_l1_cost, binary_focal_cost, chamfer_corner_loss,
                     sigmoid_focal_loss)

_NEG_BIAS = float(-np.log((1 - 0.01) / 0.01))  # -4.595


class ContrastiveEmbed(nn.Module):
    """Query·text-token similarity logits, log_scale='auto' with a
    learnable bias; -inf at masked tokens/queries and padded up to
    `max_text_len`."""

    def __init__(self, max_text_len: int = 256):
        super().__init__()
        self.max_text_len = max_text_len
        self.bias = nn.Parameter(torch.full((1, ), _NEG_BIAS))

    def forward(self, visual_feat, text_feat, text_token_mask,
                visual_feat_mask=None):
        # bfloat16 query features are promoted, as the reference's einsum
        # promotes them
        res = visual_feat.float() @ text_feat.transpose(-1, -2)
        res = res / torch.sqrt(torch.tensor(float(visual_feat.shape[-1]),
                                            device=res.device))
        res = res + self.bias
        ninf = torch.full_like(res, float('-inf'))
        res = torch.where(text_token_mask[:, None, :], res, ninf)
        if visual_feat_mask is not None:
            res = torch.where(visual_feat_mask[:, :, None], res, ninf)
        T = res.shape[-1]
        if T < self.max_text_len:
            pad = torch.full(res.shape[:-1] + (self.max_text_len - T, ),
                             float('-inf'), device=res.device)
            res = torch.cat([res, pad], dim=-1)
        return res


class RegBranch(nn.Sequential):
    """Linear-ReLU x2 → Linear(9 | 12), keys `reg_branches.0.{0,2,4}`."""

    def __init__(self, embed_dims: int = 256, num_reg: int = 9):
        super().__init__(linear(embed_dims, embed_dims), nn.ReLU(),
                         linear(embed_dims, embed_dims), nn.ReLU(),
                         linear(embed_dims, num_reg))


class GroundingHead(nn.Module):

    cost_focal_weight = 1.0
    cost_l1_weight = 2.0
    cost_iou_weight = 2.0
    loss_cls_weight = 1.0
    loss_bbox_weight = 1.0
    bg_cls_weight = 0.0
    decouple_weights = (0.2, 0.2, 0.2, 0.4)

    def __init__(self, embed_dims: int = 256, num_reg: int = 9,
                 max_text_len: int = 256):
        super().__init__()
        self.cls_branches = nn.ModuleList([ContrastiveEmbed(max_text_len)])
        self.reg_branches = nn.ModuleList([RegBranch(embed_dims, num_reg)])

    @staticmethod
    def bbox_pred_to_bbox(points: torch.Tensor,
                          bbox_pred: torch.Tensor) -> torch.Tensor:
        """'baseline' coder: center offset + log-size + euler (or ortho-6d
        for 12 regression channels)."""
        center = bbox_pred[..., :3] + points
        size = torch.clamp(torch.exp(bbox_pred[..., 3:6]), min=2e-2)
        if bbox_pred.shape[-1] == 9:
            euler = bbox_pred[..., 6:]
        else:
            rot = ortho_6d_to_matrix(bbox_pred[..., 6:9], bbox_pred[..., 9:12])
            euler = matrix_to_euler_angles(rot, 'ZXY')
        return torch.cat([center, size, euler], dim=-1)

    # ---------------- loss ----------------
    def assign(self, cls_scores, pred_bboxes, text_token_mask, gt_bboxes,
               gt_masks, positive_maps, query_mask=None) -> torch.Tensor:
        """Hungarian assignment of every layer at once (the reference
        vmaps `_loss_single` over the layers): (L, B, Q) gt index per
        query, -1 where unassigned. Nothing here carries a gradient."""
        cls_scores = cls_scores.detach()
        pred = pred_bboxes.detach()
        L, B, Q, _ = cls_scores.shape
        G = gt_bboxes.shape[1]
        T = text_token_mask.shape[1]
        iou = box3d_iou_aligned(pred[:, :, :, None, :],
                                gt_bboxes[None, :, None, :, :])
        cost = self.cost_focal_weight * binary_focal_cost(
            cls_scores[..., :T], positive_maps[..., :T], text_token_mask)
        cost = cost + self.cost_l1_weight * bbox_l1_cost(pred, gt_bboxes)
        cost = cost + self.cost_iou_weight * (-iou)
        big = torch.full_like(cost, 1e6)
        cost = torch.where(gt_masks[None, :, None, :], cost, big)
        if query_mask is not None:
            cost = torch.where(query_mask[None, :, :, None], cost, big)
        num_gts = gt_masks.sum(dim=1).repeat(L)
        return hungarian_assign(cost.reshape(L * B, Q, G),
                                num_gts).reshape(L, B, Q)

    def normalisers(self, assign, query_mask=None) -> torch.Tensor:
        """(2, L): each layer's `cls_avg` (positives plus negatives times
        the background weight) and `np_sync` (positives), at least 1, the
        global batch's under data parallelism."""
        pos = (assign >= 0).flatten(1).sum(1).float()
        valid_q = (assign[0].numel() if query_mask is None
                   else query_mask.sum().float())
        cls = pos + (valid_q - pos) * self.bg_cls_weight
        return synced_normaliser(torch.stack([cls, pos]), 1.0)

    def _loss_single(self, cls_scores, pred_bboxes, assign, text_token_mask,
                     gt_bboxes, positive_maps, query_mask, cls_avg, np_sync):
        B, Q, M = cls_scores.shape
        T = text_token_mask.shape[1]
        pos = assign >= 0
        safe = torch.where(pos, assign, torch.zeros_like(assign))
        idx = safe[..., None]
        labels = torch.take_along_dim(positive_maps, idx, dim=1)
        labels = torch.where(pos[..., None], labels, torch.zeros_like(labels))
        bbox_targets = torch.take_along_dim(gt_bboxes, idx, dim=1)

        # classification: focal over the valid text tokens
        tmask_full = torch.zeros((B, M), dtype=torch.bool,
                                 device=cls_scores.device)
        tmask_full[:, :T] = text_token_mask
        weight = tmask_full[:, None, :].float()
        if query_mask is not None:
            weight = weight * query_mask[..., None]
        finite = torch.isfinite(cls_scores)
        logits = torch.where(finite, cls_scores,
                             torch.zeros_like(cls_scores))
        loss_cls = sigmoid_focal_loss(
            logits, labels[..., :M], weight * finite) / cls_avg \
            * self.loss_cls_weight

        # boxes: decoupled corner Chamfer over the matched queries
        pos_f = pos.float()

        def cd(src):
            per_box = chamfer_corner_loss(src, bbox_targets)
            return torch.sum(per_box * pos_f) / np_sync

        pc, ps, pe = (pred_bboxes[..., :3], pred_bboxes[..., 3:6],
                      pred_bboxes[..., 6:])
        tc, ts, te = (bbox_targets[..., :3], bbox_targets[..., 3:6],
                      bbox_targets[..., 6:])
        w = self.decouple_weights
        loss_bbox = (w[0] * cd(torch.cat([pc, ts, te], -1))
                     + w[1] * cd(torch.cat([tc, ps, te], -1))
                     + w[2] * cd(torch.cat([tc, ts, pe], -1)))
        loss_bbox = loss_bbox + w[3] * cd(pred_bboxes)
        return loss_cls, loss_bbox * self.loss_bbox_weight

    def loss(self, hidden_states, all_layers_pred_bboxes, text_feats,
             text_token_mask, gt_bboxes, gt_masks, positive_maps,
             query_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """Masked DETR loss over all decoder layers: hidden_states
        (L, B, Q, C), all_layers_pred_bboxes (L, B, Q, 9), gt_bboxes
        (B, G, 9), gt_masks (B, G), positive_maps (B, G, max_text_len) →
        {'loss_cls', 'loss_bbox'} of the last layer and
        {'d{i}.loss_cls', 'd{i}.loss_bbox'} of the others."""
        all_cls = torch.stack([
            self.cls_branches[0](h, text_feats, text_token_mask)
            for h in hidden_states])
        assign = self.assign(all_cls, all_layers_pred_bboxes,
                             text_token_mask, gt_bboxes, gt_masks,
                             positive_maps, query_mask)
        L = all_cls.shape[0]
        cls_avg, np_sync = self.normalisers(assign, query_mask)
        losses = {}
        for lid in range(L):
            lc, lb = self._loss_single(
                all_cls[lid], all_layers_pred_bboxes[lid], assign[lid],
                text_token_mask, gt_bboxes, positive_maps, query_mask,
                cls_avg[lid], np_sync[lid])
            pre = '' if lid == L - 1 else f'd{lid}.'
            losses[pre + 'loss_cls'] = lc
            losses[pre + 'loss_bbox'] = lb
        return losses

    def predict(self, hidden_states, all_layers_pred_bboxes, text_feats,
                text_token_mask, query_mask=None):
        """Last-layer boxes as they are, scores = max sigmoid over text
        tokens (0 at padded queries), no NMS."""
        cls = self.cls_branches[0](hidden_states[-1], text_feats,
                                   text_token_mask)
        cls = torch.where(torch.isfinite(cls), cls, torch.full_like(cls, -1e9))
        scores = torch.amax(torch.sigmoid(cls), dim=-1)
        if query_mask is not None:
            scores = torch.where(query_mask, scores, torch.zeros_like(scores))
        return all_layers_pred_bboxes[-1], scores

