"""ProxyTransformation preshape module (the paper's core).

Counterpart of proxytransformation_tpu/models/preshape.py with static
shapes: grid-prior clusters refined by a learned offset and a second
ball query, dynamic cluster dropout (emptiest clusters, then FPS), per-
cluster PointNet proxies, text- and image-guided proxy blocks, and a
per-cluster 3x3 transform + translation scattered back onto the points.
Dropped clusters' points are masked out, not removed.

Like the reference (and the JAX package), every block of a branch reads
`point_proxy` and only the last block's result is used.

Train mode (reference models/preshape.py:338-460): the PointNets' and the
transform heads' flax BatchNorms use batch statistics and update their
running ones; every proxy block drops attention weights, its projection
and its MLP activations with rate 0.2 and its residual branches with a
per-sample DropPath of rate linspace(0, 0.2, blocks)[i]. The draws come
from the `generator` handed to `forward`. FPS keeps its deterministic
start, as the reference's train step passes no 'fps' rng
(engine/train.py:121).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ball_query import ball_query
from ..ops.common import recip32
from ..ops.fps import sample_farthest_points
from .layers import Conv1x1, linear
from .norms import BatchNormParams, layer_norm

# the reference's dropout, attention-dropout and drop-path rates
_DROP = 0.2


class Dropout(nn.Module):
    """flax `nn.Dropout`: in train mode keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, shape, device, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        """The keep mask (bool), from `generator`."""
        u = torch.rand(shape, generator=generator, device=device)
        return u < 1.0 - self.rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = self.draw(self.mask_shape(x), x.device, generator)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)


class DropPath(Dropout):
    """Per-sample stochastic depth (reference models/preshape.py:54):
    one draw per sample, broadcast over the other axes."""

    def mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], ) + (1, ) * (x.ndim - 1)


def _point_features(center: torch.Tensor, cluster: torch.Tensor
                    ) -> torch.Tensor:
    """[cluster - center (0 at padded slots), cluster] → (b, m, k, 6)."""
    rel = cluster - center[:, :, None, :]
    pad = torch.all(cluster == 0.0, dim=-1, keepdim=True)
    rel = torch.where(pad, torch.zeros_like(rel), rel)
    return torch.cat([rel, cluster], dim=-1)


class _PointMLP(nn.Module):
    """`mlp.0` Conv2d 1x1 (6 → C) + `mlp.1` BatchNorm2d, then ReLU."""

    def __init__(self, out: int):
        super().__init__()
        self.mlp = nn.ModuleDict({'0': Conv1x1(6, out), '1': BatchNormParams(out)})

    def forward(self, center, cluster, train: bool = False):
        x = self.mlp['0'](_point_features(center, cluster))
        return torch.relu(self.mlp['1'].flax(x, train))


class OffsetNetwork(_PointMLP):
    """Per-cluster center offsets (mean over K, padded slots included),
    before the tanh·margin."""

    def __init__(self, hidden: int = 256):
        super().__init__(hidden)
        self.channel_mapper = Conv1x1(hidden, 3, bias=False, spatial_dims=1)

    def forward(self, center, cluster, train: bool = False):
        return self.channel_mapper(
            super().forward(center, cluster, train).mean(dim=2))


class SimplifiedPointNet(_PointMLP):
    """Max-pool PointNet over each cluster → (b, m, C)."""

    def forward(self, center, cluster, train: bool = False):
        return torch.amax(super().forward(center, cluster, train), dim=2)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling over an (n, h, w, c) feature map."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = linear(embed_dim, embed_dim)
        self.k_proj = linear(embed_dim, embed_dim)
        self.v_proj = linear(embed_dim, embed_dim)
        self.c_proj = linear(embed_dim, embed_dim)

    def forward(self, x):
        n, h, w, c = x.shape
        x = x.reshape(n, h * w, c)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None]
        nh = self.num_heads
        hd = c // nh
        q = self.q_proj(x[:, :1]).reshape(n, 1, nh, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(n, -1, nh, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(n, -1, nh, hd).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(n, c)
        return self.c_proj(out)


class ProxyAttention(nn.Module):
    """Two-stage linear proxy attention with interpolated cluster biases:
    proxies attend over clusters (unmasked), then clusters attend over
    proxies (text mask applied). Train mode drops both attention maps
    and the output, each with the reference's rate."""

    def __init__(self, dim: int, num_heads: int, num_cluster: int,
                 dynamic_drop_radio: float, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        n = int(num_cluster * (1 - dynamic_drop_radio))
        s = int(round(dim ** 0.5))
        if s * s != dim:
            raise ValueError('ProxyAttention embed_dim must be a perfect '
                             f'square (the pc/pr biases are s x s); got {dim}')
        self.qkv = linear(dim, 3 * dim, bias=qkv_bias)
        self.proxy_proj = linear(dim, dim)
        self.proj = linear(dim, dim)
        self.pb_bias = nn.Parameter(torch.zeros(1, n, 4, 4))
        self.pc_bias = nn.Parameter(torch.zeros(1, n, s, 1))
        self.pr_bias = nn.Parameter(torch.zeros(1, n, 1, s))
        self.drop_pa = Dropout(_DROP)
        self.drop_qa = Dropout(_DROP)
        self.drop_proj = Dropout(_DROP)

    def forward(self, x, proxy, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, n, c = x.shape
        if n != self.pb_bias.shape[1]:
            raise ValueError(
                f'ProxyAttention got {n} cluster tokens, but num_cluster'
                f'*(1-dynamic_drop_radio) = {self.pb_bias.shape[1]}')
        s = self.pc_bias.shape[2]
        nh = self.num_heads
        hd = c // nh
        # bilinear 4x4 → s x s, half-pixel centers (jax.image.resize 'linear')
        bias1 = F.interpolate(self.pb_bias, size=(s, s), mode='bilinear',
                              align_corners=False).reshape(1, n, c)
        bias2 = (self.pc_bias + self.pr_bias).reshape(1, n, c)
        x = x + bias1 + bias2

        q, k, v = self.qkv(x).split(c, dim=-1)
        p = self.proxy_proj(proxy)

        def heads(t):
            return t.reshape(b, -1, nh, hd).transpose(1, 2)

        q, k, v, p = heads(q), heads(k), heads(v), heads(p)
        scale = hd ** -0.5
        pa = torch.softmax((p * scale) @ k.transpose(-1, -2), dim=-1)
        pv = self.drop_pa(pa, train, generator) @ v
        qa = (q * scale) @ p.transpose(-1, -2)
        if mask is not None:
            qa = torch.where(mask[:, None, None, :], qa,
                             torch.full_like(qa, -1e9))
        qa = self.drop_qa(torch.softmax(qa, dim=-1), train, generator)
        out = (qa @ pv).transpose(1, 2).reshape(b, n, c)
        return self.drop_proj(self.proj(out), train, generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = linear(dim, hidden)
        self.fc2 = linear(hidden, dim)
        self.drop1 = Dropout(_DROP)
        self.drop2 = Dropout(_DROP)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.drop1(F.gelu(self.fc1(x)), train, generator)
        return self.drop2(self.fc2(x), train, generator)


class ProxyBlock(nn.Module):
    """Pre-norm proxy attention + MLP block, each residual branch behind
    a DropPath."""

    def __init__(self, dim: int, num_heads: int, num_cluster: int,
                 dynamic_drop_radio: float, mlp_radio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn = ProxyAttention(dim, num_heads, num_cluster,
                                   dynamic_drop_radio, qkv_bias)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_radio))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, proxy, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h = self.attn(self.norm1(x), proxy, mask, train, generator)
        x = x + self.drop_path1(h, train, generator)
        h = self.mlp(self.norm2(x), train, generator)
        return x + self.drop_path2(h, train, generator)


def grid_unit(grid_size: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0, 1, gs)` bit for bit: i * f32(1/(gs-1)), last = 1
    (XLA folds the division by the constant into that multiplication)."""
    if grid_size == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(grid_size - 1, dtype=torch.float32, device=device)
    step = step * recip32(grid_size - 1)
    return torch.cat([step, torch.ones(1, device=device)])


class ProxyTransformationNormReverse(nn.Module):
    """Multi-modal point-cloud preshaping (ProxyTransformation, CVPR'25);
    flagship: grid_size=12, 3 text + 3 image blocks,
    dynamic_drop_radio=0.6, num_sub=30."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 grid_size: int = 4, text_blocks: int = 1,
                 img_blocks: int = 1, dynamic_drop_radio: float = 0.8,
                 mlp_radio: float = 4.0, qkv_bias: bool = False,
                 num_sub: int = 30, input_dim: int = 512,
                 img_spacial_dim: int = 15, radius: float = 3.0,
                 margin: float = 4.0, empty_drop: float = 0.3):
        super().__init__()
        self.embed_dim = embed_dim
        self.grid_size = grid_size
        self.dynamic_drop_radio = dynamic_drop_radio
        self.num_sub = num_sub
        self.radius = radius
        self.margin = margin
        self.empty_drop = empty_drop
        nc = grid_size ** 3

        def block(path_rate):
            return ProxyBlock(embed_dim, num_heads, nc, dynamic_drop_radio,
                              mlp_radio, qkv_bias, float(path_rate))

        self.get_offsets = OffsetNetwork(embed_dim)
        self.simple_encoder = SimplifiedPointNet(embed_dim)
        self.channel_mapper = Conv1x1(input_dim, embed_dim)
        self.attn_pool2d = AttentionPool2d(img_spacial_dim, embed_dim,
                                           num_heads)
        self.norm_img = layer_norm(embed_dim)
        self.textformer = nn.ModuleList(
            block(r) for r in np.linspace(0, _DROP, text_blocks))
        self.text_norm = nn.ModuleList(layer_norm(embed_dim)
                                       for _ in range(text_blocks))
        self.imgformer = nn.ModuleList(
            block(r) for r in np.linspace(0, _DROP, img_blocks))
        self.img_norm = nn.ModuleList(layer_norm(embed_dim)
                                      for _ in range(img_blocks))
        self.text_trans = linear(embed_dim, 3)
        self.img_trans = linear(embed_dim, 9)
        self.text_trans_norm = BatchNormParams(3)
        self.img_trans_norm = BatchNormParams(9)

    # ---------------- clustering ----------------
    def _grid_prior(self, points, mask):
        big = torch.full_like(points, 1e9)
        pmin = torch.amin(torch.where(mask[..., None], points, big), dim=1,
                          keepdim=True)
        pmax = torch.amax(torch.where(mask[..., None], points, -big), dim=1,
                          keepdim=True)
        lin = grid_unit(self.grid_size, points.device)
        gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing='ij')
        grid = torch.stack([gx, gy, gz], -1).reshape(1, -1, 3)
        centers = pmin + self.margin + grid * (pmax - pmin - 2 * self.margin)
        return centers, pmin, pmax

    def _deformable_cluster(self, points, mask, train):
        centers, pmin, pmax = self._grid_prior(points, mask)
        _, temp_cluster = ball_query(centers, points, self.num_sub,
                                     self.radius, mask)
        offsets = self.get_offsets(centers, temp_cluster, train)
        offsets = torch.tanh(offsets) * self.margin
        new_centers = torch.clamp(centers + offsets, pmin, pmax)
        idx, cluster = ball_query(new_centers, points, self.num_sub,
                                  self.radius, mask)
        return new_centers, cluster, idx

    def _dynamic_dropout(self, cluster, center, idx):
        """Drop the emptiest clusters, then FPS-selected ones."""
        B, M, K, _ = cluster.shape
        pad_counts = torch.sum(idx == -1, dim=2)
        temp_keep = M - int(M * self.empty_drop)
        keep1 = torch.argsort(pad_counts, dim=1, stable=True)[:, :temp_keep]
        center1 = _take_rows(center, keep1)
        cluster1 = _take_rows(cluster, keep1)
        idx1 = _take_rows(idx, keep1)

        num_keep = int(M * (1 - self.dynamic_drop_radio))
        num_drop = temp_keep - num_keep
        # FPS selects the DROPPED clusters (reference :393)
        _, fps_drop = sample_farthest_points(center1.detach(), num_drop)
        keep_mask = torch.ones((B, temp_keep), dtype=torch.bool,
                               device=center.device)
        keep_mask.scatter_(1, fps_drop.long(), False)
        keep2 = torch.argsort((~keep_mask).to(torch.int8), dim=1,
                              stable=True)[:, :num_keep]
        return (_take_rows(cluster1, keep2), _take_rows(center1, keep2),
                _take_rows(idx1, keep2),
                _take_rows(idx1, fps_drop).reshape(B, -1))

    def _img_proxy(self, img_feat):
        B, V, H, W, C = img_feat.shape
        x = self.channel_mapper(img_feat.reshape(B * V, H, W, C))
        x = self.norm_img(self.attn_pool2d(x))
        return x.reshape(B, V, self.embed_dim)

    def forward(self, points: torch.Tensor, points_mask: torch.Tensor,
                text_feats: torch.Tensor, text_mask: torch.Tensor,
                img_feat: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """points (B, N, 3), points_mask (B, N), text_feats (B, L, C),
        text_mask (B, L), img_feat (B, V, H, W, C_img) the deepest image
        level → (new_points (B, N, 3), new_mask (B, N))."""
        center, cluster, idx = self._deformable_cluster(points, points_mask,
                                                        train)
        cluster, center, idx, drop_idx = self._dynamic_dropout(
            cluster, center, idx)
        b, m, k, _ = cluster.shape
        point_proxy = self.simple_encoder(center, cluster, train)

        tx = point_proxy
        for blk, norm in zip(self.textformer, self.text_norm):
            tx = norm(blk(point_proxy, text_feats, text_mask, train,
                          generator))
        translate = self.text_trans_norm.flax(self.text_trans(tx), train)

        img_proxy = self._img_proxy(img_feat)
        ix = point_proxy
        for blk, norm in zip(self.imgformer, self.img_norm):
            ix = norm(blk(point_proxy, img_proxy, None, train, generator))
        transform = self.img_trans_norm.flax(self.img_trans(ix), train)

        transform = transform.reshape(b, m, 3, 3)
        rel = cluster - center[:, :, None, :]
        new_cluster = (torch.einsum('bmij,bmkj->bmki', transform, rel)
                       + center[:, :, None, :] + translate[:, :, None, :])
        new_points = scatter_replace(points, idx, new_cluster)
        return new_points, mask_drop(points_mask, drop_idx)


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (B, R) of `a` (B, M, ...) — `take_along_axis` over axis 1."""
    idx = idx.long().reshape(*idx.shape, *([1] * (a.ndim - 2)))
    return torch.take_along_dim(a, idx, dim=1)


def scatter_replace(points: torch.Tensor, idx: torch.Tensor,
                    cluster: torch.Tensor) -> torch.Tensor:
    """points[b, idx] = cluster where idx >= 0; of duplicate indices the
    LAST write in flattened (m, k) order wins, as in the reference's
    scatter on the CPU. Resolved deterministically: the winner of each
    point is the largest flat position that names it."""
    B, N, _ = points.shape
    ix = idx.reshape(B, -1).long()
    cl = cluster.reshape(B, -1, 3)
    valid = ix >= 0
    pos = torch.arange(ix.shape[1], device=points.device)[None].expand_as(ix)
    # invalid entries go to a spare row N that is dropped
    safe = torch.where(valid, ix, torch.full_like(ix, N))
    winner = torch.full((B, N + 1), -1, dtype=torch.int64,
                        device=points.device)
    winner.scatter_reduce_(1, safe, torch.where(valid, pos, -1), 'amax')
    winner = winner[:, :N]
    hit = winner >= 0
    vals = torch.gather(cl, 1, torch.clamp(winner, min=0)[..., None]
                        .expand(B, N, 3))
    return torch.where(hit[..., None], vals, points)


def mask_drop(mask: torch.Tensor, drop_idx: torch.Tensor) -> torch.Tensor:
    """mask[b, drop_idx] = False where drop_idx >= 0."""
    B, N = mask.shape
    d = drop_idx.long()
    safe = torch.where(d >= 0, d, torch.full_like(d, N))
    out = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
    return out.scatter(1, safe, False)[:, :N]
