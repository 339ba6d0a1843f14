"""Masked tensor helpers shared across ops and models.

Counterpart of proxytransformation_tpu/ops/common.py: static-shape
masked equivalents of the reference's ragged list idioms.
"""
from __future__ import annotations

import numpy as np
import torch


def masked_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of `points` (B, P, D) at `idx` (B, K) or (B, M, K);
    idx == -1 gives zero rows."""
    mask = idx >= 0
    safe = torch.where(mask, idx, torch.zeros_like(idx)).long()
    B, P, D = points.shape
    flat = safe.reshape(B, -1, 1).expand(-1, -1, D)
    out = torch.gather(points, 1, flat).reshape(*idx.shape, D)
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim, keepdim=False,
                eps: float = 1e-6) -> torch.Tensor:
    """Mean of `x` over `dim` counting only mask==True positions."""
    m = mask.to(x.dtype)
    num = torch.sum(x * m, dim=dim, keepdim=keepdim)
    den = torch.sum(m, dim=dim, keepdim=keepdim)
    return num / torch.clamp(den, min=eps)


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim,
               initial: float = -1e30) -> torch.Tensor:
    """Max of `x` over `dim` where mask==True (masked-out → `initial`)."""
    return torch.amax(torch.where(mask, x, torch.full_like(x, initial)),
                      dim=dim)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax with masked positions receiving ~0 probability."""
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    e = torch.exp(logits - torch.amax(logits, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def recip32(s: float) -> float:
    """The float32 reciprocal of `s`, as XLA computes it.

    XLA folds a division by a compile-time constant into a multiplication
    by the constant's float32 reciprocal. Where an integer result (a
    voxel key, a grid point, a pixel index) depends on such a quotient,
    the port multiplies by this value to round the same way.
    """
    return float(np.float32(1.0) / np.float32(s))
