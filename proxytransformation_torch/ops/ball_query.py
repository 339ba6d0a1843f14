"""Ball query: the first K points (in point order) within a radius.

Counterpart of proxytransformation_tpu/ops/ball_query.py. A CUDA tensor
goes through the hand-written kernel `csrc/ball_query.cu`; a CPU tensor
through `ball_query_idx_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .common import masked_gather

BALL_QUERY = _cuda.CudaKernel(
    'ball_query', 'ball_query', 'ptt_ball_query',
    [_cuda.ptr, _cuda.ptr, _cuda.ptr, _cuda.i32, _cuda.i32, _cuda.i32,
     _cuda.i32, _cuda.f32, _cuda.ptr, _cuda.ptr],
    source='proxytransformation_torch/csrc/ball_query.cu',
    replaces='proxytransformation_tpu/ops/ball_query_pallas.py:100')
# points per step of the plain version: bounds its (B, M, chunk) temporaries
_PLAIN_CHUNK = 2048


def radius_squared(radius: float) -> float:
    """r² in float32, as `jnp.asarray(radius, f32) ** 2` rounds it."""
    r = np.float32(radius)
    return float(r * r)


def ball_query_idx_plain(centers: torch.Tensor, points: torch.Tensor,
                         points_mask: torch.Tensor, radius2: float,
                         K: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (reference `_ball_query_idx`).

    Streams the points in chunks and keeps the K smallest in-radius
    point indices seen so far; "first K in point order" equals "K
    smallest indices among in-radius points".
    """
    B, M, _ = centers.shape
    N = points.shape[1]
    sentinel = N
    best = torch.full((B, M, K), sentinel, dtype=torch.int64,
                      device=centers.device)
    for s in range(0, N, _PLAIN_CHUNK):
        pts = points[:, s:s + _PLAIN_CHUNK]
        msk = points_mask[:, s:s + _PLAIN_CHUNK]
        dx = pts[:, None, :, 0] - centers[:, :, None, 0]
        dy = pts[:, None, :, 1] - centers[:, :, None, 1]
        dz = pts[:, None, :, 2] - centers[:, :, None, 2]
        d2 = dx * dx + dy * dy + dz * dz
        within = (d2 < radius2) & msk[:, None, :]
        ids = torch.arange(s, s + pts.shape[1], device=centers.device)
        keys = torch.where(within, ids, torch.full_like(ids, sentinel))
        cand = torch.cat([best, keys], dim=-1)
        best = torch.topk(cand, K, dim=-1, largest=False, sorted=True).values
    return torch.where(best >= sentinel, -1, best).to(torch.int32)


def ball_query_idx_cuda(centers: torch.Tensor, points: torch.Tensor,
                        points_mask: torch.Tensor, radius2: float,
                        K: int) -> torch.Tensor:
    """Launch `csrc/ball_query.cu`; returns (B, M, K) int32."""
    B, M, _ = centers.shape
    N = points.shape[1]
    _cuda.check_cuda('centers', centers, torch.float32, (B, M, 3))
    _cuda.check_cuda('points', points, torch.float32, (B, N, 3))
    _cuda.check_cuda('points_mask', points_mask, torch.bool, (B, N))
    out = torch.empty((B, M, K), dtype=torch.int32, device=centers.device)
    BALL_QUERY(centers.data_ptr(), points.data_ptr(), points_mask.data_ptr(),
               B, M, N, K, ctypes.c_float(radius2), out.data_ptr(),
               _cuda.current_stream(centers))
    return out


def ball_query_idx(centers: torch.Tensor, points: torch.Tensor,
                   points_mask: torch.Tensor, radius2: float,
                   K: int) -> torch.Tensor:
    """(B, M, K) int32 indices, -1-padded: kernel on CUDA, plain on CPU."""
    if centers.is_cuda:
        return ball_query_idx_cuda(centers, points, points_mask, radius2, K)
    return ball_query_idx_plain(centers, points, points_mask, radius2, K)


def ball_query(centers: torch.Tensor, points: torch.Tensor, K: int,
               radius: float, points_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ball query over padded point clouds (strict `<` like pytorch3d).

    Returns idx (B, M, K) int32 indices into N, -1-padded, and grouped
    (B, M, K, 3) gathered points, 0 where padded.
    """
    if points_mask is None:
        points_mask = torch.ones(points.shape[:2], dtype=torch.bool,
                                 device=points.device)
    idx = ball_query_idx(centers.float().contiguous(),
                         points.float().contiguous(),
                         points_mask.contiguous(), radius_squared(radius), K)
    return idx, masked_gather(points, idx)
