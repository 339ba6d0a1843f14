"""Dense voxel scatter and per-voxel slots of a point cloud.

Counterpart of proxytransformation_tpu/ops/voxelize.py (the reference's
mmcv `dynamic_scatter` / `hard_voxelize`): points are quantized into an
(X, Y, Z) grid over `point_cloud_range`, out-of-range or masked points go
to a spare bucket that is dropped, and the features are reduced per voxel
with `index_add_` / `scatter_reduce_`. The flat index is
`(x * Y + y) * Z + z`, as in the JAX package.

The quantization `q = floor((p - lo) / voxel)` decides integers, so it
rounds as the JAX package's jitted function does. XLA turns a division by
a compile-time constant into a multiplication by the constant's float32
reciprocal, so the voxel size is (hi - lo) times the reciprocal of
[X, Y, Z] in both of the function's uses, and then:

- a range given as numbers (a tuple, as the occupancy model passes its
  `voxel_range`) is a constant inside the model's jit: the points are
  multiplied by the reciprocal of the voxel size;
- a range given as a tensor is a run-time value (the JAX function called
  alone, with its range as an argument): the points are divided by it.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Range = Union[Sequence[float], torch.Tensor]


def quantize(points: torch.Tensor, point_cloud_range: Range,
             grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(N, 3) points → (N, 3) int64 voxel coordinates, rounded as the
    JAX package's jitted code rounds them (see the module docstring)."""
    inv_dims = np.float32(1.0) / np.asarray(grid_shape, np.float32)
    if isinstance(point_cloud_range, torch.Tensor):
        r = point_cloud_range.to(device=points.device, dtype=torch.float32)
        lo = r[:3]
        voxel = (r[3:6] - lo) * torch.from_numpy(inv_dims).to(points.device)
        return torch.floor((points - lo) / voxel).long()
    r = np.asarray(point_cloud_range, np.float32)
    voxel = (r[3:6] - r[:3]) * inv_dims
    lo = torch.from_numpy(r[:3]).to(points.device)
    inv = torch.from_numpy(np.float32(1.0) / voxel).to(points.device)
    return torch.floor((points - lo) * inv).long()


def _flat_index(points, mask, point_cloud_range, grid_shape):
    """(flat voxel index, in-range-and-valid) of every point."""
    X, Y, Z = grid_shape
    q = quantize(points, point_cloud_range, grid_shape)
    hi = torch.tensor([X, Y, Z], device=points.device)
    ok = mask & torch.all((q >= 0) & (q < hi), dim=-1)
    return (q[:, 0] * Y + q[:, 1]) * Z + q[:, 2], ok


def dynamic_scatter_3d(points: torch.Tensor, feats: torch.Tensor,
                       mask: torch.Tensor, point_cloud_range: Range,
                       grid_shape: Tuple[int, int, int],
                       reduce: str = 'mean'
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter point features into a dense voxel grid.

    points (N, 3), feats (N, C), mask (N,) → grid (X, Y, Z, C) (the mean,
    max or sum of the features of each voxel's points; 0 where a voxel has
    none) and count (X, Y, Z) float32.
    """
    if reduce not in ('mean', 'max', 'sum'):
        raise ValueError(f'reduce must be mean, max or sum, got {reduce!r}')
    X, Y, Z = grid_shape
    n_seg = X * Y * Z + 1
    idx, ok = _flat_index(points, mask, point_cloud_range, grid_shape)
    idx = torch.where(ok, idx, torch.full_like(idx, n_seg - 1))
    C = feats.shape[-1]
    if reduce == 'max':
        vals = torch.where(ok[:, None], feats,
                           torch.full_like(feats, float('-inf')))
        grid = torch.full((n_seg, C), float('-inf'), dtype=feats.dtype,
                          device=feats.device)
        grid.scatter_reduce_(0, idx[:, None].expand(-1, C), vals, 'amax')
        grid = torch.where(torch.isfinite(grid), grid, torch.zeros_like(grid))
    else:
        vals = torch.where(ok[:, None], feats, torch.zeros_like(feats))
        grid = torch.zeros((n_seg, C), dtype=feats.dtype, device=feats.device)
        grid = grid.index_add(0, idx, vals)
    count = torch.zeros(n_seg, dtype=torch.float32, device=feats.device)
    count = count.index_add(0, idx, ok.float())
    if reduce == 'mean':
        grid = grid / torch.clamp(count[:, None], min=1.0)
    return grid[:-1].reshape(X, Y, Z, C), count[:-1].reshape(X, Y, Z)


def hard_voxelize(points: torch.Tensor, mask: torch.Tensor,
                  point_cloud_range: Range,
                  grid_shape: Tuple[int, int, int], max_points: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's flat voxel id (-1 when out of range or masked) and its
    slot among its voxel's points in input order (-1 past `max_points`),
    both (N,) int32: the first `max_points` points of a voxel keep it."""
    idx, ok = _flat_index(points, mask, point_cloud_range, grid_shape)
    idx = torch.where(ok, idx, torch.full_like(idx, -1))
    big = torch.iinfo(torch.int32).max
    order = torch.argsort(torch.where(ok, idx, torch.full_like(idx, big)),
                          stable=True)
    sorted_idx = idx[order]
    first = torch.ones_like(sorted_idx, dtype=torch.bool)
    first[1:] = sorted_idx[1:] != sorted_idx[:-1]
    pos = torch.arange(len(order), device=points.device)
    # the start of each run of equal ids, carried forward
    run_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                             dim=0).values
    slot = torch.empty_like(pos)
    slot[order] = pos - run_start
    slot = torch.where(ok & (slot < max_points), slot, torch.full_like(slot, -1))
    return idx.to(torch.int32), slot.to(torch.int32)
