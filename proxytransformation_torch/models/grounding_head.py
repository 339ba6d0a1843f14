"""Grounding head, predict path: contrastive query-token logits and
9-DoF boxes.

Counterpart of proxytransformation_tpu/models/grounding_head.py::
GroundingHead (branches, `bbox_pred_to_bbox`, `predict`). The flagship
shares one prediction layer across decoder layers, so the module holds
`cls_branches.0` and `reg_branches.0` only, the keys a reference
checkpoint stores. The loss comes with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..structures.rotation import matrix_to_euler_angles, ortho_6d_to_matrix
from .layers import linear

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
        res = visual_feat @ text_feat.transpose(-1, -2)
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

