"""Farthest point sampling.

Counterpart of proxytransformation_tpu/ops/fps.py::sample_farthest_points:
start at the first valid point (the JAX package's `rng=None`) or, given a
`generator`, at a point drawn uniformly from the valid ones (its `rng`,
pytorch3d's random_start_point; the draws differ, the law is the same),
then repeatedly pick the point farthest from the selected set (first
index on ties, like argmax in both frameworks).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.dist import global_shape, local_rows
from .common import masked_gather


def random_start(mask: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """(B,) start indices uniform over each row's valid points: the draw
    is the global batch's, of which each rank keeps its rows."""
    u = local_rows(torch.rand(global_shape(mask.shape), generator=generator,
                              device=mask.device))
    return torch.argmax(torch.where(mask, u, torch.full_like(u, -1.0)), dim=1)


def fps_idx(points: torch.Tensor, mask: torch.Tensor, K: int,
            start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K) int32 indices of the farthest-point sample from `start`
    ((B,) indices; default the first valid point)."""
    B, P, _ = points.shape
    if start is None:
        start = torch.argmax(mask.to(torch.int32), dim=1)
    start = start.long()
    out = torch.full((B, K), -1, dtype=torch.int64, device=points.device)
    out[:, 0] = start
    inf = torch.tensor(float('inf'), device=points.device)
    closest = torch.where(mask, inf, -inf)
    last = start
    for i in range(1, K):
        last_xyz = torch.gather(points, 1, last[:, None, None].expand(B, 1, 3))
        d2 = torch.sum((points - last_xyz) ** 2, dim=-1)
        d2 = torch.where(mask, d2, -inf)
        closest = torch.minimum(closest, d2)
        last = torch.argmax(closest, dim=1)
        out[:, i] = last
    return out.to(torch.int32)


def sample_farthest_points(points: torch.Tensor, K: int,
                           mask: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns sampled (B, K, 3) points and their (B, K) int32 indices;
    with `generator` the start is drawn from it."""
    if mask is None:
        mask = torch.ones(points.shape[:2], dtype=torch.bool,
                          device=points.device)
    start = None if generator is None else random_start(mask, generator)
    idx = fps_idx(points.float(), mask, K, start)
    return masked_gather(points, idx), idx
