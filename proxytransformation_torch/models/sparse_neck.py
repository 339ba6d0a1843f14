"""Sparse FPN neck with score-based voxel pruning (MinkNeck).

Counterpart of proxytransformation_tpu/models/sparse_neck.py: top-down
FPN over the four backbone levels with a generative transpose-conv up
path, per-level 1-class scoring, and physical pruning (compaction) to
`pts_prune_threshold` voxels per sample per level. Painting is injected
per level through `paint_fn` and runs after compaction.

Keys follow the reference's Sequentials: `up_block_i.{0,1,3,4}` =
[GenerativeTranspose, BN, ELU, Conv3, BN, ELU], `out_block_i.{0,1}` =
[Conv3, BN, ELU], and `conv_cls` a 1x1 conv with bias.

The neck has no compute dtype of its own: its convs, norms and painting
keep the dtype of the features they receive (bfloat16 behind a bfloat16
backbone), and its scores are float32.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse import (SENTINEL, SparseLevel, build_neighbor_map,
                          compact_topk, conv_plan, generative_transpose_apply,
                          generative_transpose_map, linearize, lookup_center,
                          topk_stable)
from .norms import MaskedBatchNorm
from .sparse_resnet import SparseConv

# paint_fn(world_xyz (B, Vc, 3), mask (B, Vc), level_idx) -> (B, Vc, C_img)
PaintFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


class _Transpose(nn.Module):
    """Generative transpose conv weights (8, C_in, C_out)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, in_channels, out_channels))


def _up_block(in_channels: int, out_channels: int) -> nn.ModuleDict:
    return nn.ModuleDict({'0': _Transpose(in_channels, out_channels),
                          '1': MaskedBatchNorm(out_channels),
                          '3': SparseConv(out_channels, out_channels, 27,
                                          self_map=True),
                          '4': MaskedBatchNorm(out_channels)})


def _out_block(in_channels: int, out_channels: int) -> nn.ModuleDict:
    return nn.ModuleDict({'0': SparseConv(in_channels, out_channels, 27,
                                          self_map=True),
                          '1': MaskedBatchNorm(out_channels)})


def compact_by_score(arrays, scores, mask, k: int):
    """Gather the k best-scoring valid rows of each array (ties: lowest
    index first, like `jax.lax.top_k`)."""
    s = torch.where(mask, scores, torch.full_like(scores, float('-inf')))
    idx = topk_stable(s, k)
    out_mask = torch.gather(mask, 1, idx)

    def take(a):
        g = torch.take_along_dim(a, idx[..., None], dim=1)
        return torch.where(out_mask[..., None], g, torch.zeros_like(g))

    return [take(a) for a in arrays], out_mask


class _ConvCls(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_channels, num_classes))
        self.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x):
        # float32 Dense: bfloat16 features are promoted
        return x.float() @ self.kernel + self.bias


class MinkNeck(nn.Module):
    """Returns (feats (B, 4·P, C_out), scores (B, 4·P, num_classes),
    xyz (B, 4·P, 3), mask (B, 4·P)), coarsest level first. `self_maps`
    and `self_plans` are the backbone's self maps and their plans; the
    coarsest level's out block reuses them, and the pruned levels build
    their own maps and plans."""

    def __init__(self, num_classes: int = 1,
                 in_channels: Sequence[int] = (128, 256, 512, 1024),
                 out_channels: int = 256, pts_prune_threshold: int = 1000):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.pts_prune_threshold = pts_prune_threshold
        n = len(in_channels)
        for i in range(1, n):
            self.add_module(f'up_block_{i}',
                            _up_block(in_channels[i], in_channels[i - 1]))
        for i in range(n):
            self.add_module(f'out_block_{i}',
                            _out_block(in_channels[i], out_channels))
        self.conv_cls = _ConvCls(out_channels, num_classes)

    def forward(self, inputs: List[SparseLevel], self_maps=None,
                self_plans=None, paint_fn: Optional[PaintFn] = None,
                train: bool = False):
        n = len(inputs)
        P = self.pts_prune_threshold
        Pup = 4 * P  # up-block support: the children-of-survivors analog

        def paint_concat(lvl: SparseLevel, i: int) -> torch.Tensor:
            if paint_fn is None:
                return lvl.feats
            return torch.cat([lvl.feats, paint_fn(lvl.world_xyz(), lvl.mask,
                                                  i)], dim=-1)

        feats_l, scores_l, xyz_l, mask_l = [], [], [], []
        cur: Optional[SparseLevel] = None
        prune_score = None
        for i in range(n - 1, -1, -1):
            fine = inputs[i]
            if i < n - 1:
                # parent score at every occupied fine voxel
                pkeys = torch.where(
                    fine.mask, linearize(fine.coords // 2, cur.extent),
                    torch.full_like(fine.keys, SENTINEL))
                parent_idx = lookup_center(cur.keys, pkeys)
                hit = parent_idx >= 0
                ps = torch.gather(prune_score, 1,
                                  torch.where(hit, parent_idx, 0).long())
                ps = torch.where(hit, ps, torch.zeros_like(ps))
                # stage 1: physical prune to the up-block support
                lvl, (ps_c, ), _ = compact_topk(
                    fine, ps, min(Pup, fine.capacity), extras=(ps, ))
                skip = paint_concat(lvl, i)
                parent_idx_c, offset_id = generative_transpose_map(lvl, cur)
                nbr_up = build_neighbor_map(lvl, lvl, 3, 1)
                blk = getattr(self, f'up_block_{i + 1}')
                up = generative_transpose_apply(
                    cur.feats, parent_idx_c, offset_id, blk['0'].kernel,
                    lvl.mask)
                up = F.elu(blk['1'](up, lvl.mask, train))
                up = blk['3'](up, nbr_up, lvl.mask, conv_plan(nbr_up))
                up = F.elu(blk['4'](up, lvl.mask, train))
                x = skip + up
                # stage 2: physical prune to P (same score and tie-break)
                lvl, _, _ = compact_topk(lvl._replace(feats=x), ps_c,
                                         min(P, lvl.capacity))
                x = lvl.feats
                nbr_out = build_neighbor_map(lvl, lvl, 3, 1)
                plan_out = conv_plan(nbr_out)
            else:
                lvl = fine
                x = paint_concat(lvl, i)
                lvl = lvl._replace(feats=x)
                nbr_out = (self_maps[i] if self_maps is not None
                           else build_neighbor_map(lvl, lvl, 3, 1))
                plan_out = (self_plans[i] if self_plans is not None
                            else conv_plan(nbr_out))

            blk = getattr(self, f'out_block_{i}')
            out = F.elu(blk['1'](blk['0'](x, nbr_out, lvl.mask, plan_out),
                                 lvl.mask, train))
            cls_pred = self.conv_cls(out)
            cls_pred = torch.where(lvl.mask[..., None], cls_pred,
                                   torch.zeros_like(cls_pred))
            prune_score = torch.amax(cls_pred, dim=-1)
            prune_score = torch.where(lvl.mask, prune_score,
                                      torch.zeros_like(prune_score))
            cur = lvl._replace(feats=x)

            (f, sc, p), m = compact_by_score(
                [out, cls_pred, lvl.world_xyz()],
                torch.amax(cls_pred, dim=-1), lvl.mask,
                min(P, lvl.capacity))
            feats_l.append(f)
            scores_l.append(sc)
            xyz_l.append(p)
            mask_l.append(m)

        return (torch.cat(feats_l, dim=1), torch.cat(scores_l, dim=1),
                torch.cat(xyz_l, dim=1), torch.cat(mask_l, dim=1))
