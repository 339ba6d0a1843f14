"""2D ResNet backbone (mmdet/torchvision layout), eval-mode BatchNorm.

Counterpart of proxytransformation_tpu/models/resnet.py: ResNet-50 with
base 16 in the flagship (stage widths 64/128/256/512), `style='pytorch'`
(stride on the 3x3 conv). The public boundary is NHWC like the JAX
package; inside, the convolutions run NCHW through
`torch.nn.functional.conv2d` (the JAX package leaves them to XLA too).
In `dtype` bfloat16 the input, the convolutions and the activations are
bfloat16 (reference models/resnet.py:100-125); the folded BatchNorm
computes in float32 and returns the input's dtype. `remat` recomputes
each bottleneck block in the backward (reference models/resnet.py:120-121).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .norms import BatchNormParams, checkpoint_block


class _Conv2d(nn.Conv2d):
    """Conv2d in its input's dtype (flax `nn.Conv(dtype=...)` casts the
    float32 kernel to the compute dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    conv = _Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    nn.init.zeros_(conv.weight)
    return conv


def _bn(x: torch.Tensor, bn: BatchNormParams) -> torch.Tensor:
    """The folded eval BN on an NCHW tensor (channels last for the math)."""
    return bn.folded(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNormParams(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNormParams(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNormParams(planes * 4)
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.ModuleList(
                [_conv(inplanes, planes * 4, 1, stride),
                 BatchNormParams(planes * 4)])
        else:
            self.downsample = None

    def forward(self, x):
        out = torch.relu(_bn(self.conv1(x), self.bn1))
        out = torch.relu(_bn(self.conv2(out), self.bn2))
        out = _bn(self.conv3(out), self.bn3)
        identity = x
        if self.downsample is not None:
            identity = _bn(self.downsample[0](x), self.downsample[1])
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """mmdet-style bottleneck ResNet; NHWC in, the 4 stage outputs NHWC
    out, in `dtype` (float32 or bfloat16)."""

    arch_settings = {50: (3, 4, 6, 3)}

    def __init__(self, depth: int = 50, base_channels: int = 16,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.conv1 = _conv(3, base_channels, 7, 2)
        self.bn1 = BatchNormParams(base_channels)
        inpl = base_channels
        for i, n_blocks in enumerate(self.arch_settings[depth]):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(Bottleneck(inpl, planes, stride))
                inpl = planes * 4
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, n_stages: int = 4) -> List[torch.Tensor]:
        """The outputs of the first `n_stages` stages (a caller that reads
        only the first stage skips the rest, as XLA drops what no output
        reads)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        x = torch.relu(_bn(self.conv1(x), self.bn1))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i in range(n_stages):
            for block in getattr(self, f'layer{i + 1}'):
                x = checkpoint_block(block, x) if self.remat else block(x)
            outs.append(x.permute(0, 2, 3, 1))
        return outs
