"""2D ResNet backbone (mmdet/torchvision layout), eval-mode BatchNorm.

Counterpart of proxytransformation_tpu/models/resnet.py:72-138: depths 18
and 34 of basic blocks, 50 and 101 of bottlenecks (the JAX
`arch_settings`); the flagship takes ResNet-50 at base 16 (stage widths
64/128/256/512), `style='pytorch'` (stride on the 3x3 conv). The public
boundary is NHWC like the JAX package; inside, the convolutions run NCHW
through `torch.nn.functional.conv2d` (the JAX package leaves them to XLA
too). In `dtype` bfloat16 the input, the convolutions and the
activations are bfloat16 (reference models/resnet.py:100-125); the
folded BatchNorm computes in float32 and returns the input's dtype.
`remat` recomputes each block in the backward (reference
models/resnet.py:120-121). Parameter names are the upstream state_dict's
(`layerS.J.conv1/bn1/conv2/bn2[/conv3/bn3]/downsample.{0,1}`).
"""
from __future__ import annotations

from typing import List, Tuple

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


class BasicBlock2D(nn.Module):
    """Two 3x3 convs (reference models/resnet.py:72-93)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNormParams(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNormParams(planes)
        if stride != 1 or inplanes != planes:
            self.downsample = nn.ModuleList(
                [_conv(inplanes, planes, 1, stride), BatchNormParams(planes)])
        else:
            self.downsample = None

    def forward(self, x):
        out = torch.relu(_bn(self.conv1(x), self.bn1))
        out = _bn(self.conv2(out), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = _bn(self.downsample[0](x), self.downsample[1])
        return torch.relu(out + identity)


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


def check_img_depth_for_neck(depth: int, where: str) -> None:
    """The grounders' neck and the detector's head are built for the
    painted image widths of a bottleneck ResNet (base · 4 · 2^i, JAX
    models/detector.py:134, models/embodied_det3d.py:48): a basic-block
    depth paints base · 2^i channels, and the JAX package fails there at
    the up-block's sum (models/sparse_neck.py:164-169,
    models/fcaf3d_head.py:130-134). Raise at construction instead."""
    block_cls, _ = ResNet.block_settings(depth)
    if block_cls.expansion != 4:
        raise ValueError(
            f'{where} with img_depth={depth}: the neck\'s input widths '
            'assume the bottleneck\'s expansion of 4 (depth 50 or 101); '
            f'depth {depth}\'s basic blocks paint base * 2**i channels, and '
            'the JAX package fails there too (models/detector.py:134, '
            'models/embodied_det3d.py:48; the sum at '
            'models/sparse_neck.py:164-169, models/fcaf3d_head.py:130-134)')


class ResNet(nn.Module):
    """mmdet-style ResNet; NHWC in, the 4 stage outputs NHWC out, in
    `dtype` (float32 or bfloat16)."""

    arch_settings = {
        18: (BasicBlock2D, (2, 2, 2, 2)),
        34: (BasicBlock2D, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
    }

    def __init__(self, depth: int = 50, base_channels: int = 16,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        block_cls, stage_blocks = self.block_settings(depth)
        self.depth = depth
        self.dtype = dtype
        self.remat = remat
        self.out_channels = self.stage_channels(depth, base_channels)
        self.conv1 = _conv(3, base_channels, 7, 2)
        self.bn1 = BatchNormParams(base_channels)
        inpl = base_channels
        for i, n_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(inpl, planes, stride))
                inpl = planes * block_cls.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))

    @classmethod
    def block_settings(cls, depth: int) -> Tuple[type, Tuple[int, ...]]:
        """(block class, blocks a stage) of `depth`; another depth raises."""
        if depth not in cls.arch_settings:
            raise ValueError(f'ResNet depth {depth!r}: the 2D ResNet has '
                             f'depths {sorted(cls.arch_settings)}')
        return cls.arch_settings[depth]

    @classmethod
    def stage_channels(cls, depth: int, base_channels: int
                       ) -> Tuple[int, ...]:
        """The four stage outputs' widths, base · expansion · 2^i."""
        block_cls, _ = cls.block_settings(depth)
        return tuple(base_channels * block_cls.expansion * 2 ** i
                     for i in range(4))

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
