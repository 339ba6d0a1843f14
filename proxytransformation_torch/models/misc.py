"""The EMA weight average of the EMA hook.

Counterpart of proxytransformation_tpu/models/misc.py::ExpMomentumEMA
(reference models/layers/ema.py:123-189), on dicts of float32 tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.native import fma32
from ..ops.common import recip32


class ExpMomentumEMA:
    """EMA with an exponentially ramped momentum: after optimizer step
    `step` (0 for the first), `m = (1 - momentum) * exp(-(1 + step) /
    gamma) + momentum` and `ema = (1 - m) * ema + m * p`, in float32."""

    def __init__(self, momentum: float = 0.0002, gamma: int = 2000):
        self.momentum = momentum
        self.gamma = gamma

    def exponent(self, step: int) -> np.float32:
        """-(1 + step) / gamma in float32 as the JAX package's jitted
        train step computes it: XLA folds the division by the constant
        gamma into a multiplication by its float32 reciprocal."""
        return np.float32(-(1 + int(step))) * np.float32(recip32(self.gamma))

    def momentum_at(self, step: int) -> np.float32:
        """m in float32 as the jitted step computes it: XLA's CPU code
        multiplies and adds in one fused multiply-add, and its exp is
        within an ulp of the correctly rounded one taken here."""
        e = np.float32(np.exp(np.float64(self.exponent(step))))
        return fma32(np.float32(1 - self.momentum), e,
                     np.float32(self.momentum))[()]

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
