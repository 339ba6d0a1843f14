"""Data parallelism on torch.distributed: the process group, the batch's
split over ranks, and the collectives the train step needs.

Counterpart of proxytransformation_tpu/parallel/mesh.py. The JAX package
shards the batch over a 1-D `data` mesh and jits the whole step, so XLA
computes the same function as one device does on the global batch:
batch statistics, loss normalisers and random draws are the global
batch's. Stock `DistributedDataParallel` computes another function (norms
and normalisers per rank), so the port builds those semantics here:

- topology: one process is one rank on one device, and a node's ranks
  together are one JAX host. torchrun's `RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `LOCAL_WORLD_SIZE` and `GROUP_RANK` give the context; the
  loader is sharded by node and each local rank takes its contiguous
  slice of the node's batch (`shard_batch` puts that slice on device r);
- `all_reduce_sum`: a differentiable sum over ranks, whose backward sums
  the incoming gradients over ranks, for the train-mode norms'
  statistics (`models/norms.py`);
- `synced_normaliser`: a loss normaliser as the global count over the
  world size, so that the rank mean of `local_sum / normaliser` is
  `global_sum / global_count`;
- `average_gradients`: one flat all-reduce of the gradients a step, whose
  rank mean is then the global loss's gradient;
- `broadcast_state`: rank 0's parameters, buffers and EMA copy on every
  rank (the counterpart of `replicate`);
- `global_shape` / `local_rows`: random draws at the global batch's shape,
  of which each rank keeps its rows, so every rank's generator advances
  alike and the masks are those of the one-process run.

At world size 1 (no process group) every collective is the identity and
issues no call. Every process group takes a timeout, so that a rank that
waits on a collective the others never call fails instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a collective that waits longer than this fails (seconds); the config's
# `env_cfg.dist_cfg.timeout` overrides it
DEFAULT_TIMEOUT_S = 300.0
_ENV_KEYS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
             'GROUP_RANK')


@dataclass(frozen=True)
class DistContext:
    """Where this process stands: `world` ranks, `local_world` of them on
    each of `world // local_world` nodes; this one is `rank`, the
    `local_rank`-th of node `node`."""
    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1
    node: int = 0

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0


_CTX: Optional[DistContext] = None
# the group that carries host objects and barriers (gloo); None: the
# default group is gloo already
_CPU_GROUP = None


def env_context() -> DistContext:
    """The context torchrun's environment describes (one process without
    it). Raises on an environment that is not one homogeneous job."""
    env = os.environ
    if 'WORLD_SIZE' not in env:
        return DistContext()
    missing = [k for k in _ENV_KEYS if k not in env]
    if missing:
        raise RuntimeError(f'--launcher pytorch: {missing} not set (run '
                           'under python -m torch.distributed.run)')
    world, rank, local_rank, local_world, node = (
        int(env[k]) for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK',
                              'LOCAL_WORLD_SIZE', 'GROUP_RANK'))
    if world % local_world or rank != node * local_world + local_rank:
        raise RuntimeError(
            f'RANK={rank} WORLD_SIZE={world} LOCAL_RANK={local_rank} '
            f'LOCAL_WORLD_SIZE={local_world} GROUP_RANK={node}: the port '
            'runs the same number of ranks on every node')
    return DistContext(world, rank, local_rank, local_world, node)


def context() -> DistContext:
    """The active context: world size 1 without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return DistContext()
    if _CTX is not None:
        return _CTX
    # a group made by the caller: one node
    world, rank = dist.get_world_size(), dist.get_rank()
    return DistContext(world, rank, rank, world, 0)


def world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def init_process_group(ctx: DistContext, backend: str,
                       init_method: str = 'env://',
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> DistContext:
    """Join the process group of `ctx` (host objects and barriers go over
    a gloo group of their own when `backend` is not gloo)."""
    global _CTX, _CPU_GROUP
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=ctx.world, rank=ctx.rank,
                            timeout=timeout)
    _CTX = ctx
    _CPU_GROUP = (None if backend == 'gloo'
                  else dist.new_group(backend='gloo', timeout=timeout))
    return ctx


def destroy_process_group() -> None:
    global _CTX, _CPU_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _CTX = _CPU_GROUP = None


def cpu_group():
    """The group for host tensors and objects."""
    return _CPU_GROUP


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_CPU_GROUP)


# --------------------------------------------------------------------------
# the host batch's split
# --------------------------------------------------------------------------
def global_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """The global batch's shape of a draw whose first axis is the rank's
    batch."""
    shape = tuple(shape)
    return (shape[0] * world_size(), ) + shape[1:]


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (every rank holds an
    equal slice, in rank order)."""
    world = world_size()
    if world == 1:
        return t
    b = t.shape[0] // world
    return t[context().rank * b:(context().rank + 1) * b]


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
# what the collectives cost: calls, host seconds and, for the gradients,
# bytes. With TIMING['sync'] the device is synchronized before each clock
# starts, so that a call's seconds are its own and not the queued work's.
STATS: Dict[str, float] = {}
TIMING = {'sync': False}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(norm_calls=0, norm_s=0.0, grad_calls=0, grad_s=0.0,
                 grad_bytes=0, other_calls=0, other_s=0.0)


reset_stats()


def _timed_all_reduce(t: torch.Tensor, kind: str, op=None,
                      group=None) -> None:
    sync = TIMING['sync'] and t.is_cuda
    if sync:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    if sync:
        torch.cuda.synchronize(t.device)
    STATS[f'{kind}_calls'] += 1
    STATS[f'{kind}_s'] += time.perf_counter() - t0


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the incoming gradient over ranks
    (each rank's loss reads the sum, so its gradient is every rank's)."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        out = x.clone()
        _timed_all_reduce(out, kind)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        _timed_all_reduce(g, ctx.kind)
        return g, None


def all_reduce_sum(x: torch.Tensor, kind: str = 'norm') -> torch.Tensor:
    """Differentiable sum of `x` over ranks (the identity at world size
    1); `kind` names the counter the call adds to."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x, kind)


def synced_normaliser(count: torch.Tensor, floor: float) -> torch.Tensor:
    """A loss normaliser from each rank's `count`: max(Σ count, floor) over
    the world size (at world size 1, max(count, floor)). A rank's loss
    local_sum / normaliser then averages over ranks to the one-process
    global_sum / max(global_count, floor), and so do its gradients."""
    count = count.detach().float()
    world = world_size()
    if world == 1:
        return torch.clamp(count, min=floor)
    total = count.clone()
    _timed_all_reduce(total, 'other')
    return torch.clamp(total, min=floor) / world


def all_reduce_mean(values: torch.Tensor) -> torch.Tensor:
    """The rank mean of a tensor (no gradient; the identity at world size
    1)."""
    world = world_size()
    if world == 1:
        return values
    out = values.detach().clone()
    _timed_all_reduce(out, 'other')
    return out / world


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every parameter's `.grad` becomes its rank mean, in one flat
    all-reduce in parameter order. A parameter without a gradient on this
    rank takes zeros when another rank has one (the union is agreed
    first), so every rank sends the same layout."""
    if world_size() == 1:
        return
    params = [p for p in params if p.requires_grad]
    have = torch.tensor([p.grad is not None for p in params],
                        dtype=torch.int32)
    _timed_all_reduce(have, 'other', op=dist.ReduceOp.MAX, group=_CPU_GROUP)
    live = [p for p, h in zip(params, have.tolist()) if h]
    if not live:
        return
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype: Dict[torch.dtype, List[torch.nn.Parameter]] = {}
    for p in live:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    world = world_size()
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        _timed_all_reduce(flat, 'grad')
        STATS['grad_bytes'] += flat.numel() * flat.element_size()
        flat /= world
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0
                      ) -> None:
    """Rank `src`'s values into `tensors` on every rank, in place, one
    flat broadcast per dtype and device."""
    if world_size() == 1:
        return
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src,
                       group=_CPU_GROUP if flat.device.type == 'cpu'
                       and _CPU_GROUP is not None else None)
        offset = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def broadcast_state(module: torch.nn.Module,
                    extra: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Rank 0's parameters, buffers and `extra` tensors (the EMA copy) on
    every rank (the JAX package's `replicate`)."""
    tensors = [*module.parameters(), *module.buffers()]
    if extra:
        tensors += [extra[k] for k in sorted(extra)]
    broadcast_tensors(tensors)
