"""The smaller components (the JAX package's models/misc.py).

- `ExpMomentumEMA` (reference models/layers/ema.py:123-189): the EMA
  hook's weight average, on dicts of float32 tensors.
- `Anchor3DRangeGenerator` / `AlignedAnchor3DRangeGenerator` (reference
  models/task_modules/anchor/anchor_3d_generator.py:11-354): mmdet3d's
  anchor grids, which the grounding path does not use.
- `ChannelMapper` (reference models/necks/channel_mapper.py:18-90): one
  linear map a sparse level to a common width.
- `TransformerEncoder` and `get_sine_pos_embed` (reference
  models/necks/transformer.py:10-305; out of the final config).
- `focal_loss_cost`, `token_map_cost` (reference
  models/losses/match_cost.py:116-211, 78-93).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..data.native import fma32
from ..device import full_float32, resolve_device
from ..ops.common import recip32
from ..ops.sparse import SparseLevel
from ..utils.registry import MODELS, TASK_UTILS
from .decoder import FFN, MultiheadAttention
from .layers import linear
from .norms import layer_norm


class ExpMomentumEMA:
    """EMA with an exponentially ramped momentum: after optimizer step
    `step` (0 for the first), `m = (1 - momentum) * exp(-(1 + step) /
    gamma) + momentum` and `ema = (1 - m) * ema + m * p`, in float32."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 2000):
        self.momentum = momentum
        self.gamma = gamma

    def exponent(self, step: int) -> np.float32:
        """-(1 + step) / gamma in float32 as the JAX package's jitted
        train step computes it: XLA folds the division by the constant
        gamma into a multiplication by its float32 reciprocal."""
        return np.float32(-(1 + int(step))) * np.float32(recip32(self.gamma))

    def momentum_at(self, step: int) -> np.float32:
        """m in float32 as the jitted step computes it: XLA's CPU code
        multiplies and adds in one fused multiply-add, and its exp is
        within an ulp of the correctly rounded one taken here."""
        e = np.float32(np.exp(np.float64(self.exponent(step))))
        return fma32(np.float32(1 - self.momentum), e,
                     np.float32(self.momentum))[()]

    @torch.no_grad()
    def update(self, ema: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], step: int) -> None:
        """Advance `ema` in place towards `params` (same keys)."""
        m = self.momentum_at(step)
        names = list(ema)
        avg = [ema[n] for n in names]
        # (1 - m) * ema and m * p each rounded, then summed
        torch._foreach_mul_(avg, float(np.float32(1) - m))
        torch._foreach_add_(avg, torch._foreach_mul(
            [params[n] for n in names], float(m)))


# --------------------------------------------------------------------------
def linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in float32 as XLA's CPU code gives
    it for up to 34 points: with c = f32(1 / (num - 1)), point i is
    fma(i, f32(stop · c), f32(start · (1 - f32(i · c)))) (XLA moves stop
    into the constant and LLVM fuses the sum), but point 1 is
    fma(start, 1 - c, f32(stop · c)), and the last is `stop`. Longer
    ranges take a vector loop there that also fuses 1 - i · c on some
    lanes: points up to two float32 steps of max(|start|, |stop|) apart
    (none at the ranges of the repository's configs)."""
    s, e = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([s], np.float32)
    div = num - 1
    c = np.float32(1) / np.float32(div)
    ec = np.float32(e * c)
    i = np.arange(div, dtype=np.float32)
    keep = np.float32(1) - i * c
    out = fma32(i, ec, s * keep)
    if div > 1:
        out[1] = fma32(s, keep[1], ec)
    return np.append(out, e).astype(np.float32)


@TASK_UTILS.register_module()
class Anchor3DRangeGenerator:
    """A uniform 3D anchor grid over each range: (x, y, z, dx, dy, dz, yaw)
    for every centre, size and rotation."""

    def __init__(self, ranges: Sequence[Sequence[float]],
                 sizes: Sequence[Sequence[float]] = ((3.9, 1.6, 1.56), ),
                 rotations: Sequence[float] = (0.0, 1.5707963),
                 align_corner: bool = False):
        self.ranges = ranges
        self.sizes = sizes
        self.rotations = rotations
        self.align_corner = align_corner

    def grid_anchors(self, featmap_size, device=None) -> List[torch.Tensor]:
        """(W·H·D·sizes·rotations, 7) float32 anchors a range, on `device`
        (None: the card, raising when there is none)."""
        device = resolve_device(device)
        extra = 0 if self.align_corner else 1
        out = []
        for rng in self.ranges:
            axes = []
            for a, n in zip(range(3), featmap_size):
                x = linspace32(rng[a], rng[a + 3], n + extra)
                if not self.align_corner:
                    x = (x[:-1] + x[1:]) / np.float32(2)
                axes.append(torch.from_numpy(x))
            grid = torch.meshgrid(*axes, indexing='ij')
            ctr = torch.stack(grid, -1).reshape(-1, 3)
            anchors = [torch.cat([
                ctr, torch.tensor(size, dtype=torch.float32).expand(
                    ctr.shape[0], 3),
                torch.full((ctr.shape[0], 1), rot, dtype=torch.float32)], -1)
                for size in self.sizes for rot in self.rotations]
            out.append(torch.stack(anchors, 1).reshape(-1, 7).to(device))
        return out


@TASK_UTILS.register_module()
class AlignedAnchor3DRangeGenerator(Anchor3DRangeGenerator):

    def __init__(self, *args, **kw):
        kw.setdefault('align_corner', False)
        super().__init__(*args, **kw)


# --------------------------------------------------------------------------
@MODELS.register_module()
class ChannelMapper(nn.Module):
    """One linear map (`convs.{i}`) a sparse level to `out_channels`, 0 at
    masked slots. `device=None` builds it on the card (raising when there
    is none)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.convs = nn.ModuleList(linear(c, out_channels)
                                       for c in in_channels)

    def forward(self, levels: List[SparseLevel]) -> List[SparseLevel]:
        out = []
        with full_float32():
            for conv, lvl in zip(self.convs, levels):
                f = conv(lvl.feats)
                out.append(lvl._replace(feats=torch.where(
                    lvl.mask[..., None], f, torch.zeros_like(f))))
        return out


# --------------------------------------------------------------------------
def get_sine_pos_embed(pos: torch.Tensor, num_feats: int = 128,
                       temperature: int = 10000) -> torch.Tensor:
    """(..., D) positions → (..., D · num_feats) sines and cosines
    (reference transformer.py:~270-305)."""
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                            / num_feats)
    emb = pos[..., None] * (2 * math.pi) / dim_t
    emb = torch.cat([torch.sin(emb[..., 0::2]), torch.cos(emb[..., 1::2])],
                    -1)
    return emb.reshape(pos.shape[:-1] + (-1, ))


class _EncoderLayer(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads)
        self.norm1 = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self.norm2 = layer_norm(embed_dims)

    def forward(self, x, key_padding_mask=None):
        x = self.norm1(self.attn(x, x, x, key_padding_mask=key_padding_mask))
        return self.norm2(self.ffn(x))


@MODELS.register_module()
class TransformerEncoder(nn.Module):
    """The cross-view interactor (reference transformer.py:10-305): layers
    of post-norm self-attention and FFN over (B, N, C) tokens, the padded
    ones (`mask` False) left out as keys. Float32 with TF32 off.
    `device=None` builds it on the card (raising when there is none)."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 3,
                 num_heads: int = 8, feedforward_channels: int = 1024,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.layers = nn.ModuleList(
                _EncoderLayer(embed_dims, num_heads, feedforward_channels)
                for _ in range(num_layers))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding = None if mask is None else ~mask
        with full_float32():
            for layer in self.layers:
                x = layer(x, padding)
        return x


# --------------------------------------------------------------------------
def focal_loss_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-12) -> torch.Tensor:
    """FocalLossCost (Q, G) for hard integer labels (reference
    :142-159)."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return pos[:, gt_labels] - neg[:, gt_labels]


def token_map_cost(pred_logits: torch.Tensor,
                   gt_logits: torch.Tensor) -> torch.Tensor:
    """TokenMapCost (reference :78-93)."""
    return pred_logits @ gt_logits.T
