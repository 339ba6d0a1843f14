"""Sparse 3D ResNet backbone (MinkResNet) on the port's voxel engine.

Counterpart of proxytransformation_tpu/models/sparse_resnet.py, cell
format only (the JAX package's 2x2x2 brick stages are off by default and
not ported). Parameters carry MinkowskiEngine's key names
(`conv1.kernel`, `layer1.0.norm1.bn.weight`, `layer1.0.downsample.0.kernel`).

    conv1 k3 s2 (→2 cm) → InstanceNorm → ReLU → maxpool k2 s2 (→4 cm)
    → 4 stages of BasicBlocks, each starting with stride 2,
      channels 64/128/256/512.

With `dtype` bfloat16 the stem conv still reads the float32 xyz features
(the float32 kernel); its output is cast to bfloat16 and every later
conv, norm output and activation is bfloat16 (reference
models/sparse_resnet.py:254-259), so the stages run the bf16 form of the
sparse-conv kernels.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..ops.sparse import (SparseLevel, build_neighbor_map, conv_plan,
                          downsample_coords, sparse_conv, sparse_max_pool)
from .norms import MaskedBatchNorm, MaskedInstanceNorm


class SparseConv(nn.Module):
    """Sparse convolution parameters (`kernel` (K³, C_in, C_out), or
    (C_in, C_out) for K³ = 1 as MinkowskiEngine stores it); the geometry
    comes in as a neighbor map. `self_map` marks a conv whose map is a
    stride-1 map of a level onto itself (it picks the backward's formula,
    reference models/sparse_resnet.py:48). `plan` is the map's
    `conv_plan`, built once with the map."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int, self_map: bool = False):
        super().__init__()
        shape = ((in_channels, out_channels) if kernel_volume == 1 else
                 (kernel_volume, in_channels, out_channels))
        self.kernel = nn.Parameter(torch.zeros(shape))
        self.self_map = self_map

    def forward(self, feats, nbr, out_mask, plan=None):
        w = self.kernel if self.kernel.ndim == 3 else self.kernel[None]
        return sparse_conv(feats, nbr, w, out_mask, self_map=self.self_map,
                           plan=plan)


class SparseBasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN (+1x1 downsample) + ReLU (ME BasicBlock)."""

    def __init__(self, in_channels: int, planes: int, downsample: bool):
        super().__init__()
        # the stage's first block (the one with a downsample) reads the
        # strided map, every other conv its level's self map
        self.conv1 = SparseConv(in_channels, planes, 27,
                                self_map=not downsample)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, self_map=True)
        self.norm2 = MaskedBatchNorm(planes)
        if downsample:
            self.downsample = nn.ModuleList(
                [SparseConv(in_channels, planes, 1), MaskedBatchNorm(planes)])
        else:
            self.downsample = None

    def forward(self, feats, out_mask, nbr_conv1, nbr_conv2, nbr_down=None,
                train: bool = False, plan_conv1=None, plan_conv2=None):
        x = torch.relu(self.norm1(
            self.conv1(feats, nbr_conv1, out_mask, plan_conv1), out_mask,
            train))
        x = self.norm2(self.conv2(x, nbr_conv2, out_mask, plan_conv2),
                       out_mask, train)
        identity = feats
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = norm(conv(feats, nbr_down, out_mask), out_mask, train)
        return torch.relu(x + identity)


class MinkResNet(nn.Module):
    """Sparse ResNet over a voxelized cloud; returns the 4 stage levels,
    their self maps and the self maps' plans. Each map's `conv_plan` is
    built once, beside it, and serves every conv over it. Capacities are the static
    per-sample voxel budgets of the 6 internal levels (conv1, pool,
    stage 1..4)."""

    arch_settings = {
        14: (1, 1, 1, 1),
        18: (2, 2, 2, 2),
        34: (3, 4, 6, 3),
    }

    def __init__(self, depth: int = 34, in_channels: int = 3,
                 capacities: Sequence[int] = (100_000, 80_000, 50_000,
                                              20_000, 6_000, 2_000),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.capacities = tuple(capacities)
        self.dtype = dtype
        self.stage_blocks = self.arch_settings[depth]
        self.conv1 = SparseConv(in_channels, 64, 27)
        self.norm1 = MaskedInstanceNorm(64)
        inpl = 64
        for i, n_blocks in enumerate(self.stage_blocks):
            planes = 64 * 2 ** i
            self.add_module(f'layer{i + 1}', nn.ModuleList(
                SparseBasicBlock(inpl if j == 0 else planes, planes, j == 0)
                for j in range(n_blocks)))
            inpl = planes

    def forward(self, level0: SparseLevel, train: bool = False):
        caps = self.capacities
        lvl = downsample_coords(level0, caps[0])
        nbr = build_neighbor_map(level0, lvl, kernel_size=3, stride=2)
        x = self.conv1(level0.feats, nbr, lvl.mask, conv_plan(nbr))
        x = torch.relu(self.norm1(x.to(self.dtype), lvl.mask))
        plvl = downsample_coords(lvl, caps[1])
        pnbr = build_neighbor_map(lvl, plvl, kernel_size=2, stride=2)
        x = sparse_max_pool(x, pnbr, plvl.mask)
        lvl = plvl

        outs: List[SparseLevel] = []
        self_maps, self_plans = [], []
        for i in range(len(self.stage_blocks)):
            new_lvl = downsample_coords(lvl, caps[2 + i])
            nbr_stride3 = build_neighbor_map(lvl, new_lvl, 3, 2)
            # the 1x1 stride-2 map is the k3 map's center offset (index 13)
            nbr_stride1 = nbr_stride3[..., 13:14]
            nbr_self = build_neighbor_map(new_lvl, new_lvl, 3, 1)
            plan_stride3 = conv_plan(nbr_stride3)
            plan_self = conv_plan(nbr_self)
            for j, block in enumerate(getattr(self, f'layer{i + 1}')):
                first = j == 0
                x = block(x, new_lvl.mask, nbr_stride3 if first else nbr_self,
                          nbr_self, nbr_stride1 if first else None, train,
                          plan_stride3 if first else plan_self, plan_self)
            lvl = new_lvl
            outs.append(lvl._replace(feats=x))
            self_maps.append(nbr_self)
            self_plans.append(plan_self)
        return outs, self_maps, self_plans
