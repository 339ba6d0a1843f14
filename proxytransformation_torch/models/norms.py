"""Normalization layers in eval mode, under the upstream key names.

Counterpart of proxytransformation_tpu/models/norms.py plus the eval
BatchNorms the JAX package writes inline. The JAX package computes the
same normalization in three orders (flax BatchNorm, MaskedBatchNorm and
the ResNet's folded affine); `BatchNormParams` keeps one method for each
so the float32 rounding follows the reference.
"""
from __future__ import annotations

import torch
from torch import nn


class BatchNormParams(nn.Module):
    """weight / bias / running_mean / running_var of a torch BatchNorm
    (`num_batches_tracked` in a checkpoint is accepted and ignored)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        state_dict.pop(prefix + 'num_batches_tracked', None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def flax(self, x: torch.Tensor) -> torch.Tensor:
        """flax `nn.BatchNorm(use_running_average=True)` over the last axis."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias

    def masked(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """`MaskedBatchNorm` in eval mode: running stats, 0 at masked rows."""
        y = ((x.float() - self.running_mean)
             / torch.sqrt(self.running_var + self.eps) * self.weight
             + self.bias)
        return torch.where(mask[..., None], y, torch.zeros_like(y)).to(x.dtype)

    def folded(self, x: torch.Tensor) -> torch.Tensor:
        """The 2D ResNet's `_BN`: one scale and shift over the last axis."""
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x.float() * scale + shift).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """MinkowskiBatchNorm analog (keys `<name>.bn.*`), eval mode over the
    valid rows of a (B, V, C) array."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNormParams(channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.bn.masked(x, mask)


class MaskedInstanceNorm(nn.Module):
    """InstanceNorm: per-sample statistics over that sample's valid
    voxels, affine `weight`/`bias`."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m = mask[..., None].float()
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (xf * m).sum(dim=1, keepdim=True) / cnt
        var = (torch.square(xf - mean) * m).sum(dim=1, keepdim=True) / cnt
        y = (xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, torch.zeros_like(y)).to(x.dtype)


def layer_norm(channels: int) -> nn.LayerNorm:
    """flax `nn.LayerNorm` defaults (epsilon 1e-6)."""
    return nn.LayerNorm(channels, eps=1e-6)
