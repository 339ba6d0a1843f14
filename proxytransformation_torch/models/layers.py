"""Small parameter holders that keep the upstream checkpoint layouts,
and the compute-dtype rules of flax's `nn.Dense(dtype=...)`."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)` over the last axis with float32
    parameters: in float32 the input is promoted and one `F.linear` runs;
    in bfloat16 the input, weight and bias are cast to it, the product
    is rounded to it and the bias added after (one more rounding), and
    the output stays bfloat16."""
    if dtype == torch.float32:
        return F.linear(x.float(), weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`jnp.einsum(..., preferred_element_type=float32)` of two operands
    of any float type: exact products, float32 sums and output."""
    return a.float() @ b.float()


class Conv1x1(nn.Module):
    """A 1x1 Conv1d/Conv2d of the reference (weight (out, in, 1[, 1]))
    applied as a linear map over the last axis of channels-last input,
    computed in `dtype` (see `dense`)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 spatial_dims: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, *([1] * spatial_dims)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter('bias', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return dense(x, w, self.bias, self.dtype)


class Linear(nn.Linear):
    """nn.Linear computed in `compute_dtype` (see `dense`); its
    parameters stay float32."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


def linear(in_features: int, out_features: int, bias: bool = True,
           dtype: torch.dtype = torch.float32) -> Linear:
    """`Linear` with zero parameters; weights come from a checkpoint or
    from `random_init_`."""
    m = Linear(in_features, out_features, bias=bias, compute_dtype=dtype)
    nn.init.zeros_(m.weight)
    if bias:
        nn.init.zeros_(m.bias)
    return m


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Seeded random weights: every parameter ~ N(0, std²) except
    normalization scales (1 + small noise); running statistics are set
    to mean 0, variance 1."""
    for name, p in module.named_parameters():
        leaf = name.rsplit('.', 1)[-1]
        noise = torch.randn(p.shape, generator=generator,
                            device=generator.device).to(p.device)
        if p.ndim == 1 and leaf == 'weight':
            p.copy_(1.0 + 0.1 * std * noise)
        else:
            p.copy_(std * noise)
    for name, b in module.named_buffers():
        if name.endswith('running_mean'):
            b.zero_()
        elif name.endswith('running_var'):
            b.fill_(1.0)
    return module
