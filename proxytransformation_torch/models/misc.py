"""The EMA weight average of the EMA hook.

Counterpart of proxytransformation_tpu/models/misc.py::ExpMomentumEMA
(reference models/layers/ema.py:123-189), on dicts of float32 tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ExpMomentumEMA:
    """EMA with an exponentially ramped momentum: after optimizer step
    `step` (0 for the first), `m = (1 - momentum) * exp(-(1 + step) /
    gamma) + momentum` and `ema = (1 - m) * ema + m * p`, in float32."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 2000):
        self.momentum = momentum
        self.gamma = gamma

    def momentum_at(self, step: int) -> np.float32:
        """m in float32, as the JAX package computes it from its int32
        step (the exponential may differ from XLA's by an ulp)."""
        one = np.float32(1)
        t = np.float32(-(1 + int(step))) / np.float32(self.gamma)
        return ((one - np.float32(self.momentum)) * np.exp(t)
                + np.float32(self.momentum))

    @torch.no_grad()
    def update(self, ema: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], step: int) -> None:
        """Advance `ema` in place towards `params` (same keys)."""
        m = self.momentum_at(step)
        names = list(ema)
        avg = [ema[n] for n in names]
        # (1 - m) * ema and m * p each rounded, then summed
        torch._foreach_mul_(avg, float(np.float32(1) - m))
        torch._foreach_add_(avg, torch._foreach_mul(
            [params[n] for n in names], float(m)))
