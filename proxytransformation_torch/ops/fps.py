"""Farthest point sampling with the deterministic start.

Counterpart of proxytransformation_tpu/ops/fps.py::sample_farthest_points
with `rng=None`: start at the first valid point, then repeatedly pick the
point farthest from the selected set (first index on ties, like argmax
in both frameworks). The Gumbel random start is train-only and is not
ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import masked_gather


def fps_idx(points: torch.Tensor, mask: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K) int32 indices of the farthest-point sample."""
    B, P, _ = points.shape
    start = torch.argmax(mask.to(torch.int32), dim=1)
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
                           mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns sampled (B, K, 3) points and their (B, K) int32 indices."""
    if mask is None:
        mask = torch.ones(points.shape[:2], dtype=torch.bool,
                          device=points.device)
    idx = fps_idx(points.float(), mask, K)
    return masked_gather(points, idx), idx
