"""2x2x2 brick format for the sparse voxel engine.

Counterpart of proxytransformation_tpu/ops/brick.py. A brick level
groups each 2-cell cube of a level into one row holding its 8 sub-cells'
features: (B, Vb, 8C), block s = ((x%2)·2 + y%2)·2 + z%2 (kernel_offsets(2)
order). The brick coordinates are `downsample_coords` of the cell level,
so the maps and the conv kernels serve bricks unchanged. A 3³ conv over
bricks with `brick_expand`-ed weights computes the cell conv exactly (up
to the order of float32 sums): a missing cell is a zero block.

Pack and unpack are sparse convs of 0/1 selection weights over the
8-offset maps (on the card the conv kernel, as the JAX package sends
them to its Pallas kernel), and each is the other's exact gradient.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .sparse import (SparseLevel, build_neighbor_map, downsample_coords,
                     kernel_offsets, sparse_conv)


def build_brick_level(level: SparseLevel, capacity: int
                      ) -> Tuple[SparseLevel, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(blvl, pmap, unb8, slot_mask) of `level`: the brick level (sorted
    keys, placeholder feats); pmap (B, Vb, 8) the cell of each sub-slot
    (-1: absent); unb8 (B, V, 8) its inverse (unb8[v, s] = the brick row
    of cell v where v sits in slot s, else -1); slot_mask = pmap >= 0."""
    blvl = downsample_coords(level, capacity)
    pmap = build_neighbor_map(level, blvl, kernel_size=2, stride=2)
    slot_mask = pmap >= 0
    B, Vb, _ = pmap.shape
    V = level.mask.shape[1]
    dev = pmap.device
    # one int32 scatter; absent slots write to a spare slot past the end
    b = torch.arange(B, device=dev)[:, None, None]
    s = torch.arange(8, device=dev)[None, None, :]
    spare = B * V * 8
    dst = torch.where(slot_mask, (b * V + pmap) * 8 + s, spare)
    rows = torch.arange(Vb, dtype=torch.int32, device=dev)[None, :, None]
    unb8 = torch.full((spare + 1, ), -1, dtype=torch.int32, device=dev)
    unb8.scatter_(0, dst.reshape(-1), rows.expand(B, Vb, 8).reshape(-1))
    return blvl, pmap, unb8[:spare].view(B, V, 8), slot_mask


@functools.lru_cache(maxsize=None)
def _pack_weights(c: int) -> np.ndarray:
    """(8, C, 8C) selection blocks: slot s writes channel block s."""
    w = np.zeros((8, c, 8 * c), np.float32)
    for s in range(8):
        w[s, :, s * c:(s + 1) * c] = np.eye(c, dtype=np.float32)
    return w


@functools.lru_cache(maxsize=None)
def _unpack_weights(c: int) -> np.ndarray:
    """(8, 8C, C) selection blocks: slot s reads channel block s."""
    return np.ascontiguousarray(_pack_weights(c).transpose(0, 2, 1))


def _select(feats, nbr, weights: np.ndarray, mask) -> torch.Tensor:
    w = torch.as_tensor(weights, device=feats.device)
    return sparse_conv(feats, nbr, w.to(feats.dtype), mask)


def _pack(feats, pmap, brick_mask):
    return _select(feats, pmap, _pack_weights(feats.shape[-1]), brick_mask)


def _unpack(bfeats, unb8, cell_mask):
    return _select(bfeats, unb8, _unpack_weights(bfeats.shape[-1] // 8),
                   cell_mask)


class _BrickPack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, pmap, unb8, brick_mask, cell_mask):
        ctx.save_for_backward(unb8, cell_mask)
        return _pack(feats, pmap, brick_mask)

    @staticmethod
    def backward(ctx, g):
        unb8, cell_mask = ctx.saved_tensors
        return _unpack(g.contiguous(), unb8, cell_mask), None, None, None, \
            None


class _BrickUnpack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bfeats, pmap, unb8, brick_mask, cell_mask):
        ctx.save_for_backward(pmap, brick_mask)
        return _unpack(bfeats, unb8, cell_mask)

    @staticmethod
    def backward(ctx, g):
        pmap, brick_mask = ctx.saved_tensors
        return _pack(g.contiguous(), pmap, brick_mask), None, None, None, \
            None


def brick_pack(feats: torch.Tensor, pmap: torch.Tensor, unb8: torch.Tensor,
               brick_mask: torch.Tensor, cell_mask: torch.Tensor
               ) -> torch.Tensor:
    """(B, V, C) cell feats → (B, Vb, 8C) brick feats (0 at absent
    sub-cells); its gradient is `brick_unpack` of the output's."""
    return _BrickPack.apply(feats, pmap, unb8, brick_mask, cell_mask)


def brick_unpack(bfeats: torch.Tensor, pmap: torch.Tensor,
                 unb8: torch.Tensor, brick_mask: torch.Tensor,
                 cell_mask: torch.Tensor) -> torch.Tensor:
    """(B, Vb, 8C) brick feats → (B, V, C) cell feats; its gradient is
    `brick_pack` of the output's."""
    return _BrickUnpack.apply(bfeats, pmap, unb8, brick_mask, cell_mask)


@functools.lru_cache(maxsize=None)
def brick_mix() -> np.ndarray:
    """(27 brick offsets, 8 sp, 8 sq) int: the block (bo, sp, sq) of a
    brick weight is the cell weight d where 2·off(bo) + sub(sp) - sub(sq)
    is the cell offset d, else 27 (a zero block); 216 of the 1728 blocks
    are cell weights."""
    offs = kernel_offsets(3)
    subs = kernel_offsets(2)
    m = np.full((27, 8, 8), 27, np.int64)
    for bo in range(27):
        for sp in range(8):
            for sq in range(8):
                d = 2 * offs[bo] + subs[sp] - subs[sq]
                if np.all(np.abs(d) <= 1):
                    m[bo, sp, sq] = (d[0] + 1) * 9 + (d[1] + 1) * 3 + d[2] + 1
    return m


def brick_expand(w: torch.Tensor) -> torch.Tensor:
    """Cell weights (27, C_in, C_out) → brick weights (27, 8·C_in,
    8·C_out), differentiable: each block is a copy of one cell weight or
    zero (an index, so exact whatever the matmul precision)."""
    k3, c_in, c_out = w.shape
    if k3 != 27:
        raise ValueError(f'brick_expand: a 3^3 kernel, got K3 = {k3}')
    idx = torch.as_tensor(brick_mix(), device=w.device)
    w_ext = torch.cat([w, w.new_zeros((1, c_in, c_out))])
    wb = w_ext[idx]                        # (27, 8_p, 8_q, C_in, C_out)
    return wb.permute(0, 1, 3, 2, 4).reshape(27, 8 * c_in, 8 * c_out)
