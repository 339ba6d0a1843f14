"""DETR-style grounding decoder with per-layer box refinement.

Counterpart of proxytransformation_tpu/models/decoder.py: 6 layers of
self-attn → text cross-attn → point cross-attn → FFN (post-norm), with
learned positional embeddings from the current 9-DoF boxes (queries) and
the voxel xyz (keys), refined per layer through the head's regression
branch. Paddings are boolean masks applied as -1e9 logits. Dropout is 0
(the reference config's), so train mode differs from eval only in the
position nets' BatchNorm, and the boxes carry no gradient from one layer
to the next (`stop_gradient` at reference decoder.py:186).

With `dtype` bfloat16 (reference models/decoder.py:30-100) the attention
projections and the FFN run in bfloat16, the logits and softmax in
float32 (the softmax cast back), and each residual sum is cast to
float32; the LayerNorms, position nets and box refinement stay float32.
`remat` recomputes each decoder layer in the backward (reference
models/decoder.py:176-177).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .layers import Conv1x1, dense, linear, matmul_f32
from .norms import BatchNormParams, checkpoint_block, layer_norm


class MultiheadAttention(nn.Module):
    """Post-norm residual MHA under nn.MultiheadAttention's key names
    (`attn.in_proj_weight`, `attn.in_proj_bias`, `attn.out_proj`):
    out = query + attn(query + query_pos, key + key_pos, value), float32
    out."""

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(
            torch.zeros(3 * embed_dims, embed_dims))
        self.attn.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.attn.out_proj = linear(embed_dims, embed_dims, dtype=dtype)

    def forward(self, query, key, value, query_pos=None, key_pos=None,
                key_padding_mask=None):
        q = query if query_pos is None else query + query_pos
        k = key if key_pos is None else key + key_pos
        B, Q, C = q.shape
        H = self.num_heads
        hd = C // H
        w = self.attn.in_proj_weight
        bias = self.attn.in_proj_bias
        qp = dense(q, w[:C], bias[:C], self.dtype)
        kp = dense(k, w[C:2 * C], bias[C:2 * C], self.dtype)
        vp = dense(value, w[2 * C:], bias[2 * C:], self.dtype)

        def split(t):
            return t.reshape(B, -1, H, hd).transpose(1, 2)

        qp, kp, vp = split(qp), split(kp), split(vp)
        logits = matmul_f32(qp, kp.transpose(-1, -2)) * hd ** -0.5
        if key_padding_mask is not None:
            logits = torch.where(key_padding_mask[:, None, None, :],
                                 torch.full_like(logits, -1e9), logits)
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = matmul_f32(attn, vp).transpose(1, 2).reshape(B, Q, C)
        return (query + self.attn.out_proj(out)).float()


class PositionEmbeddingLearned(nn.Module):
    """conv1d-BN-ReLU-conv1d over tokens; the BN is masked (0 at padded
    tokens; running statistics in eval, batch statistics in train)."""

    def __init__(self, in_channels: int, embed_dims: int):
        super().__init__()
        self.position_embedding_head = nn.ModuleDict({
            '0': Conv1x1(in_channels, embed_dims, spatial_dims=1),
            '1': BatchNormParams(embed_dims),
            '3': Conv1x1(embed_dims, embed_dims, spatial_dims=1)})

    def forward(self, xyz, mask=None, train: bool = False):
        h = self.position_embedding_head
        if mask is None:
            mask = torch.ones(xyz.shape[:2], dtype=torch.bool,
                              device=xyz.device)
        x = torch.relu(h['1'].masked(h['0'](xyz), mask, train))
        return h['3'](x)


class FFN(nn.Module):
    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(linear(embed_dims, feedforward_channels,
                                 dtype=dtype), nn.ReLU()),
            linear(feedforward_channels, embed_dims, dtype=dtype))

    def forward(self, x):
        return (x + self.layers(x)).float()


class DecoderLayer(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dims, num_heads, dtype)
        self.cross_attn_text = MultiheadAttention(embed_dims, num_heads,
                                                  dtype)
        self.cross_attn = MultiheadAttention(embed_dims, num_heads, dtype)
        self.norms = nn.ModuleList(layer_norm(embed_dims) for _ in range(4))
        self.ffn = FFN(embed_dims, feedforward_channels, dtype)

    def forward(self, query, key, value, query_pos, key_pos,
                key_padding_mask, text_feats, text_padding_mask):
        query = self.norms[0](self.self_attn(query, query, query, query_pos,
                                             query_pos))
        query = self.norms[1](self.cross_attn_text(
            query, text_feats, text_feats, query_pos, None,
            key_padding_mask=text_padding_mask))
        query = self.norms[2](self.cross_attn(
            query, key, value, query_pos, key_pos,
            key_padding_mask=key_padding_mask))
        return self.norms[3](self.ffn(query))


class SparseFeatureFusionTransformerDecoder(nn.Module):
    """Stacked decoder with box refinement; returns the normed hidden
    states (L, B, Q, C) and the boxes of every layer (L, B, Q, 9)."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, feedforward_channels: int = 2048,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.self_posembed = PositionEmbeddingLearned(9, embed_dims)
        self.cross_posembed = PositionEmbeddingLearned(3, embed_dims)
        self.norm = layer_norm(embed_dims)
        self.layers = nn.ModuleList(
            DecoderLayer(embed_dims, num_heads, feedforward_channels, dtype)
            for _ in range(num_layers))

    def forward(self, query, feats, feats_padding_mask, query_coords,
                feats_coords, pred_bboxes, text_feats, text_padding_mask,
                reg_branch_fn: Callable, bbox_coder_fn: Callable,
                feats_mask: Optional[torch.Tensor] = None,
                query_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        inter, inter_boxes = [], []
        key_pos = self.cross_posembed(feats_coords, feats_mask, train)
        for layer in self.layers:
            query_pos = self.self_posembed(pred_bboxes, query_mask, train)
            args = (query, feats, feats, query_pos, key_pos,
                    feats_padding_mask, text_feats, text_padding_mask)
            query = (checkpoint_block(layer, *args) if self.remat
                     else layer(*args))
            new_pred = bbox_coder_fn(query_coords, reg_branch_fn(query))
            pred_bboxes = new_pred.detach()
            inter.append(self.norm(query))
            inter_boxes.append(new_pred)
        return torch.stack(inter), torch.stack(inter_boxes)
