"""Normalization layers under the upstream key names.

Counterpart of proxytransformation_tpu/models/norms.py plus the
BatchNorms the JAX package writes inline. The JAX package computes the
same normalization in three orders (flax BatchNorm, MaskedBatchNorm and
the ResNet's folded affine, which is always in eval mode); `BatchNormParams`
keeps one method for each so the float32 rounding follows the reference.
In train mode the first two normalize with batch statistics and update
the running buffers in place. `torch.nn.BatchNorm*` is not used: its
running variance is unbiased and its momentum means the other fraction.

The batch statistics are the global batch's under data parallelism, as
the JAX package's are: its step is one `jit` over a batch sharded on the
`data` mesh, so XLA reduces over every device (PARITY.md deviation 4;
the "per-device local" of proxytransformation_tpu/models/norms.py:5-6
does not hold under `jit`). With more than one rank the sums behind the
statistics go through `parallel.all_reduce_sum`, whose backward sums the
incoming gradients over ranks, so the gradients are the global batch's
too; every rank issues the same collectives in the same order, whatever
its rows hold. Eval mode and `folded` stay local and issue none.

`checkpoint_block` is the JAX package's `nn.remat` of a block: its
backward recomputes the block's forward, and the recompute leaves the
running statistics as they are, since flax's functional `batch_stats`
take the update once.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.dist import all_reduce_sum, world_size

_RECOMPUTE = threading.local()


@contextlib.contextmanager
def running_stats_frozen() -> Iterator[None]:
    """Inside the block, train-mode norms normalize with the batch's
    statistics but do not update the running ones (the recompute runs on
    whichever thread runs the backward, and the flag is that thread's)."""
    saved = getattr(_RECOMPUTE, 'frozen', False)
    _RECOMPUTE.frozen = True
    try:
        yield
    finally:
        _RECOMPUTE.frozen = saved


def checkpoint_block(fn, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward, with the running
    statistics frozen. Without grad mode it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen()))


class BatchNormParams(nn.Module):
    """weight / bias / running_mean / running_var of a torch BatchNorm
    (`num_batches_tracked` in a checkpoint is accepted and ignored)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        state_dict.pop(prefix + 'num_batches_tracked', None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor,
                momentum: float) -> None:
        """running = momentum * running + (1 - momentum) * batch stat;
        nothing inside `running_stats_frozen`."""
        if getattr(_RECOMPUTE, 'frozen', False):
            return
        keep = 1.0 - momentum
        self.running_mean.copy_(momentum * self.running_mean + keep * mean)
        self.running_var.copy_(momentum * self.running_var + keep * var)

    def flax(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """flax `nn.BatchNorm` over the last axis. Eval: running stats.
        Train (flax 0.12 defaults): batch stats over every other axis,
        var = E[x²] - E[x]² clipped at 0, the running stats updated in
        place with momentum 0.99 (the fraction of the old value kept).
        With more than one rank: one all-reduce of the sums of x and x²
        and of the row count, the moments from the global sums."""
        if train:
            dims = tuple(range(x.ndim - 1))
            if world_size() == 1:
                mean = x.mean(dim=dims)
                sq = (x * x).mean(dim=dims)
            else:
                C = x.shape[-1]
                sums = all_reduce_sum(torch.cat([
                    x.sum(dim=dims), (x * x).sum(dim=dims),
                    x.new_tensor([x.numel() // C])]))
                mean, sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
            var = torch.maximum(sq - mean * mean, torch.zeros_like(mean))
            self._update(mean, var, 0.99)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias

    def masked(self, x: torch.Tensor, mask: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """`MaskedBatchNorm`, 0 at masked rows. Eval: running stats.
        Train: two-pass mean and variance over the valid rows of every
        sample, the running stats updated in place with momentum 0.9.
        With more than one rank each pass all-reduces its sums (the
        masked sum and count, then the masked squared deviations)."""
        xf = x.float()
        if train:
            m = mask[..., None].float()
            dims = tuple(range(x.ndim - 1))
            sums = all_reduce_sum(torch.cat([(xf * m).sum(dim=dims),
                                             m.sum().reshape(1)]))
            cnt = torch.clamp(sums[-1], min=1.0)
            mean = sums[:-1] / cnt
            var = all_reduce_sum(
                (torch.square(xf - mean) * m).sum(dim=dims)) / cnt
            self._update(mean, var, 0.9)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, torch.zeros_like(y)).to(x.dtype)

    def folded(self, x: torch.Tensor) -> torch.Tensor:
        """The 2D ResNet's `_BN`: one scale and shift over the last axis."""
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x.float() * scale + shift).to(x.dtype)


class MaskedBatchNorm(nn.Module):
    """MinkowskiBatchNorm analog (keys `<name>.bn.*`), eval mode over the
    valid rows of a (B, V, C) array."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNormParams(channels)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        return self.bn.masked(x, mask, train)


class MaskedInstanceNorm(nn.Module):
    """InstanceNorm: per-sample statistics over that sample's valid
    voxels, affine `weight`/`bias`."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m = mask[..., None].float()
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (xf * m).sum(dim=1, keepdim=True) / cnt
        var = (torch.square(xf - mean) * m).sum(dim=1, keepdim=True) / cnt
        y = (xf - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, torch.zeros_like(y)).to(x.dtype)


def layer_norm(channels: int) -> nn.LayerNorm:
    """flax `nn.LayerNorm` defaults (epsilon 1e-6)."""
    return nn.LayerNorm(channels, eps=1e-6)
