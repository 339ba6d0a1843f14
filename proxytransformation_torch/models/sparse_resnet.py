"""Sparse 3D ResNet backbone (MinkResNet) on the port's voxel engine.

Counterpart of proxytransformation_tpu/models/sparse_resnet.py.
Parameters carry MinkowskiEngine's key names (`conv1.kernel`,
`layer1.0.norm1.bn.weight`, `layer1.0.downsample.0.kernel`).

    conv1 k3 s2 (→2 cm) → InstanceNorm (or BatchNorm: norm='batch') → ReLU
    → maxpool k2 s2 (→4 cm; pool=False skips it)
    → up to 4 stages (num_stages), each starting with stride 2: BasicBlocks
      of 64/128/256/512 channels (depth 14/18/34) or Bottlenecks of
      256/512/1024/2048 (depth 50/101).

A bottleneck's 1x1 convs over a level's identity map are a plain product
(the JAX package leaves K³ = 1 to XLA); its 3x3 conv, like every 3x3
conv, takes the sparse-conv kernels. `brick_stages` runs the stride-1
convs of those basic stages in the 2x2x2 brick format (ops/brick.py): the
same parameters, the cell conv's function up to the order of float32
sums; a brick stage returns no self map.

With `dtype` bfloat16 the stem conv still reads the float32 xyz features
(the float32 kernel); its output is cast to bfloat16 and every later
conv, norm output and activation is bfloat16 (reference
models/sparse_resnet.py:254-259), so the stages run the bf16 form of the
sparse-conv kernels. `remat` recomputes each `SparseBasicBlock` in the
backward, its running statistics untouched by the recompute (reference
models/sparse_resnet.py:306-308).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..ops.brick import (brick_expand, brick_pack, brick_unpack,
                         build_brick_level)
from ..ops.sparse import (SparseLevel, build_neighbor_map, conv_plan,
                          downsample_coords, sparse_conv, sparse_max_pool)
from .norms import (MaskedBatchNorm, MaskedInstanceNorm,
                    checkpoint_block)


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


class SparseBottleneck(nn.Module):
    """conv1x1-BN-ReLU-conv3-BN-ReLU-conv1x1-BN (+1x1 downsample) + ReLU
    (ME Bottleneck, expansion 4). conv1 runs at the block's input level,
    conv2 is strided in a stage's first block."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, first: bool):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseConv(in_channels, planes, 1)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, self_map=not first)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = SparseConv(planes, out, 1)
        self.norm3 = MaskedBatchNorm(out)
        # a stage's first block changes the level and the width (a block
        # after it keeps both, so the JAX package's identity-map
        # downsample never arises)
        if first:
            self.downsample = nn.ModuleList(
                [SparseConv(in_channels, out, 1), MaskedBatchNorm(out)])
        else:
            self.downsample = None

    def forward(self, feats, in_mask, out_mask, nbr_conv2, nbr_down=None,
                train: bool = False, plan_conv2=None):
        x = self.conv1(feats, self_map_k1(in_mask), in_mask)
        x = torch.relu(self.norm1(x, in_mask, train))
        x = self.conv2(x, nbr_conv2, out_mask, plan_conv2)
        x = torch.relu(self.norm2(x, out_mask, train))
        x = self.conv3(x, self_map_k1(out_mask), out_mask)
        x = self.norm3(x, out_mask, train)
        identity = feats
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = norm(conv(feats, nbr_down, out_mask), out_mask, train)
        return torch.relu(x + identity)


def self_map_k1(mask: torch.Tensor) -> torch.Tensor:
    """The identity map of a 1x1 conv on a level: (B, V, 1), v at valid
    rows, -1 elsewhere."""
    B, V = mask.shape
    idx = torch.arange(V, dtype=torch.int32, device=mask.device)
    return torch.where(mask, idx, -1)[..., None]


class BrickConv(SparseConv):
    """A 3x3 self conv over bricks: the parameter is the cell kernel
    (27, C_in, C_out), lifted by `brick_expand` at each call."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 27, self_map=True)

    def forward(self, bfeats, bnbr, brick_mask, plan=None):
        return sparse_conv(bfeats, bnbr, brick_expand(self.kernel),
                           brick_mask, self_map=True, plan=plan)


def _brick_norm(norm: MaskedBatchNorm, bx, slot_mask, train):
    """A cell-format norm over the brick view: (B, Vb, 8C) as (B, Vb·8, C)
    rows under the slot mask (the same rows, statistics and parameters)."""
    B, Vb, c8 = bx.shape
    y = norm(bx.reshape(B, Vb * 8, c8 // 8), slot_mask.reshape(B, Vb * 8),
             train)
    return y.reshape(B, Vb, c8)


class BrickBasicBlock(SparseBasicBlock):
    """A stride-1 `SparseBasicBlock` over bricks (the same parameters)."""

    def __init__(self, planes: int):
        super().__init__(planes, planes, downsample=False)
        self.conv1 = BrickConv(planes, planes)
        self.conv2 = BrickConv(planes, planes)

    def forward(self, bx, bnbr, brick_mask, slot_mask, train: bool = False,
                plan=None):
        x = self.conv1(bx, bnbr, brick_mask, plan)
        x = torch.relu(_brick_norm(self.norm1, x, slot_mask, train))
        x = self.conv2(x, bnbr, brick_mask, plan)
        x = _brick_norm(self.norm2, x, slot_mask, train)
        return torch.relu(x + bx)


class BrickEntryBlock(SparseBasicBlock):
    """A brick stage's first block (the parameters of `SparseBasicBlock`):
    the strided conv1 and the 1x1 downsample run over cells, their
    outputs are packed once, conv2 and the residual run over bricks."""

    def __init__(self, in_channels: int, planes: int):
        super().__init__(in_channels, planes, downsample=True)
        self.conv2 = BrickConv(planes, planes)

    def forward(self, feats, out_mask, brick_mask, slot_mask, nbr_stride3,
                nbr_stride1, pmap, unb8, bnbr, train: bool = False,
                plan_stride3=None, plan_brick=None):
        x = self.conv1(feats, nbr_stride3, out_mask, plan_stride3)
        x = torch.relu(self.norm1(x, out_mask, train))
        bx = brick_pack(x, pmap, unb8, brick_mask, out_mask)
        bx = self.conv2(bx, bnbr, brick_mask, plan_brick)
        bx = _brick_norm(self.norm2, bx, slot_mask, train)
        conv, norm = self.downsample
        identity = norm(conv(feats, nbr_stride1, out_mask), out_mask, train)
        return torch.relu(
            bx + brick_pack(identity, pmap, unb8, brick_mask, out_mask))


class MinkResNet(nn.Module):
    """Sparse ResNet over a voxelized cloud; returns the stage levels,
    their self maps and the self maps' plans (None for a brick stage).
    Each map's `conv_plan` is built once, beside it, and serves every conv
    over it. Capacities are the static per-sample voxel budgets of the 6
    internal levels (conv1, pool, stage 1..4); a brick stage i takes
    capacities[3 + i] for its bricks."""

    arch_settings = {
        14: ('basic', (1, 1, 1, 1)),
        18: ('basic', (2, 2, 2, 2)),
        34: ('basic', (3, 4, 6, 3)),
        50: ('bottleneck', (3, 4, 6, 3)),
        101: ('bottleneck', (3, 4, 23, 3)),
    }

    def __init__(self, depth: int = 34, in_channels: int = 3,
                 capacities: Sequence[int] = (100_000, 80_000, 50_000,
                                              20_000, 6_000, 2_000),
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 *, num_stages: int = 4, pool: bool = True,
                 norm: str = 'instance', brick_stages: Sequence[int] = ()):
        super().__init__()
        if depth not in self.arch_settings:
            raise ValueError(f'MinkResNet depth {depth}: one of '
                             f'{sorted(self.arch_settings)}')
        if norm not in ('instance', 'batch'):
            raise ValueError(f"norm must be 'instance' or 'batch', got {norm!r}")
        self.capacities = tuple(capacities)
        self.dtype = dtype
        self.remat = remat
        self.pool = pool
        self.block_type, blocks = self.arch_settings[depth]
        self.stage_blocks = blocks[:num_stages]
        # the JAX package's gate: basic stages with a brick capacity
        self.brick_stages = tuple(
            i for i in brick_stages if self.block_type == 'basic'
            and i < len(self.stage_blocks) and 3 + i < len(self.capacities))
        self.conv1 = SparseConv(in_channels, 64, 27)
        self.norm1 = (MaskedBatchNorm(64) if norm == 'batch'
                      else MaskedInstanceNorm(64))
        inpl = 64
        for i, n_blocks in enumerate(self.stage_blocks):
            planes = 64 * 2 ** i
            if self.block_type == 'bottleneck':
                out = planes * SparseBottleneck.expansion
                blocks = [SparseBottleneck(inpl if j == 0 else out, planes,
                                           j == 0)
                          for j in range(n_blocks)]
                inpl = out
            elif i in self.brick_stages:
                blocks = [BrickEntryBlock(inpl, planes)] + [
                    BrickBasicBlock(planes) for _ in range(1, n_blocks)]
                inpl = planes
            else:
                blocks = [SparseBasicBlock(inpl if j == 0 else planes,
                                           planes, j == 0)
                          for j in range(n_blocks)]
                inpl = planes
            self.add_module(f'layer{i + 1}', nn.ModuleList(blocks))

    def _block(self, block, *args):
        return checkpoint_block(block, *args) if self.remat else block(*args)

    def forward(self, level0: SparseLevel, train: bool = False):
        caps = self.capacities
        lvl = downsample_coords(level0, caps[0])
        nbr = build_neighbor_map(level0, lvl, kernel_size=3, stride=2)
        x = self.conv1(level0.feats, nbr, lvl.mask, conv_plan(nbr))
        x = x.to(self.dtype)
        if isinstance(self.norm1, MaskedBatchNorm):
            x = self.norm1(x, lvl.mask, train)
        else:
            x = self.norm1(x, lvl.mask)
        x = torch.relu(x)
        if self.pool:
            plvl = downsample_coords(lvl, caps[1])
            pnbr = build_neighbor_map(lvl, plvl, kernel_size=2, stride=2)
            x = sparse_max_pool(x, pnbr, plvl.mask)
            lvl = plvl

        outs: List[SparseLevel] = []
        self_maps, self_plans = [], []
        for i in range(len(self.stage_blocks)):
            blocks = getattr(self, f'layer{i + 1}')
            new_lvl = downsample_coords(lvl, caps[2 + i])
            nbr_stride3 = build_neighbor_map(lvl, new_lvl, 3, 2)
            # the 1x1 stride-2 map is the k3 map's center offset (index 13)
            nbr_stride1 = nbr_stride3[..., 13:14]
            plan_stride3 = conv_plan(nbr_stride3)
            if i in self.brick_stages:
                x = self._brick_stage(blocks, x, lvl, new_lvl, caps[3 + i],
                                      nbr_stride3, nbr_stride1, plan_stride3,
                                      train)
                nbr_self = plan_self = None
            else:
                nbr_self = build_neighbor_map(new_lvl, new_lvl, 3, 1)
                plan_self = conv_plan(nbr_self)
                for j, block in enumerate(blocks):
                    first = j == 0
                    if self.block_type == 'bottleneck':
                        args = (x, lvl.mask if first else new_lvl.mask,
                                new_lvl.mask,
                                nbr_stride3 if first else nbr_self,
                                nbr_stride1 if first else None, train,
                                plan_stride3 if first else plan_self)
                    else:
                        args = (x, new_lvl.mask,
                                nbr_stride3 if first else nbr_self, nbr_self,
                                nbr_stride1 if first else None, train,
                                plan_stride3 if first else plan_self,
                                plan_self)
                    x = self._block(block, *args)
            lvl = new_lvl
            outs.append(lvl._replace(feats=x))
            self_maps.append(nbr_self)
            self_plans.append(plan_self)
        return outs, self_maps, self_plans

    def _brick_stage(self, blocks, x, lvl, new_lvl, brick_capacity,
                     nbr_stride3, nbr_stride1, plan_stride3, train):
        """A basic stage over bricks: the entry block packs after its
        strided conv1, the stride-1 convs run over the brick level's self
        map, and the stage's output is unpacked to cells."""
        blvl, pmap, unb8, slot_mask = build_brick_level(new_lvl,
                                                        brick_capacity)
        bnbr = build_neighbor_map(blvl, blvl, 3, 1)
        bplan = conv_plan(bnbr)
        x = self._block(blocks[0], x, new_lvl.mask, blvl.mask, slot_mask,
                        nbr_stride3, nbr_stride1, pmap, unb8, bnbr, train,
                        plan_stride3, bplan)
        for block in blocks[1:]:
            x = self._block(block, x, bnbr, blvl.mask, slot_mask, train,
                            bplan)
        return brick_unpack(x, pmap, unb8, blvl.mask, new_lvl.mask)


def check_backbone3d_depth(depth: int) -> None:
    """The grounders and the detector feed MinkResNet's stages to a neck
    or head of 64/128/256/512 input channels (as the JAX package's
    hard-coded `mink_chans`): a bottleneck depth's 256-2048 do not fit."""
    if MinkResNet.arch_settings.get(depth, ('basic', ))[0] != 'basic':
        raise ValueError(
            f'backbone3d_depth={depth}: the neck takes the 64/128/256/512 '
            'channels of a basic MinkResNet (depth 14, 18 or 34); depth '
            f'{depth} gives 256/512/1024/2048')
