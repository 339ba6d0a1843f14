"""Small parameter holders that keep the upstream checkpoint layouts."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv1x1(nn.Module):
    """A 1x1 Conv1d/Conv2d of the reference (weight (out, in, 1[, 1]))
    applied as a linear map over the last axis of channels-last input."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 spatial_dims: int = 2):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_channels, in_channels, *([1] * spatial_dims)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter('bias', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x, w, self.bias)


def linear(in_features: int, out_features: int, bias: bool = True
           ) -> nn.Linear:
    """nn.Linear with zero parameters; weights come from a checkpoint or
    from `random_init_`."""
    m = nn.Linear(in_features, out_features, bias=bias)
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
