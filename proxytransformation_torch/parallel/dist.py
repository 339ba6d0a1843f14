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
  `LOCAL_RANK`, `LOCAL_WORLD_SIZE` and `GROUP_RANK` give the context (or
  SLURM's and Open MPI's variables, `slurm_context` / `mpi_context`); the
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
import re
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


# SLURM's and Open MPI's variables (the ones jax.distributed.initialize's
# cluster detection reads, jax/_src/clusters/{slurm,ompi}_cluster.py, and
# the node count and index the port's homogeneity rule needs)
_SLURM_KEYS = ('SLURM_JOB_ID', 'SLURM_STEP_NODELIST', 'SLURM_NTASKS',
               'SLURM_PROCID', 'SLURM_LOCALID', 'SLURM_STEP_NUM_NODES',
               'SLURM_NODEID')
_OMPI_KEYS = ('OMPI_MCA_orte_hnp_uri', 'OMPI_COMM_WORLD_SIZE',
              'OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_LOCAL_RANK',
              'OMPI_COMM_WORLD_LOCAL_SIZE')
# JAX's coordinator port range when none is named: [65535 - 2^12 + 1, 65535]
_PORT_BASE = 65535 - 2**12 + 1
_RUNNERS = {'slurm': 'srun', 'mpi': 'mpirun'}


def _require(keys: Sequence[str], launcher: str) -> Dict[str, str]:
    missing = [k for k in keys if k not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher {launcher}: {missing} not set (run '
                           f'the command under {_RUNNERS[launcher]})')
    return {k: os.environ[k] for k in keys}


def first_slurm_host(node_list: str) -> str:
    """The first host of a SLURM node list ('node001', 'node001,host2',
    'node[001-015],host2', 'node[001,007-015]'), parsed as JAX's
    `SlurmCluster.get_coordinator_address` parses it, without `scontrol`
    (the closing bracket of a one-host range such as 'node[7]' is
    dropped, where JAX keeps it)."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ',['),
               len(node_list))
    if cut == len(node_list) or node_list[cut] == ',':
        return node_list[:cut]
    rest = node_list[cut + 1:]
    end = next((i for i, ch in enumerate(rest) if ch in ',-]'), len(rest))
    return node_list[:cut] + rest[:end]


def _coordinator_port(job_id: int) -> int:
    """`MASTER_PORT` where it is set, else the port JAX derives from the
    job id (every task of the job computes the same one)."""
    if 'MASTER_PORT' in os.environ:
        return int(os.environ['MASTER_PORT'])
    return job_id % 2**12 + _PORT_BASE


def _homogeneous(world: int, rank: int, local_rank: int, local_world: int,
                 node: int, names: str) -> DistContext:
    if (local_world < 1 or world % local_world
            or rank != node * local_world + local_rank):
        raise RuntimeError(
            f'{names} = {world}, {rank}, {local_rank}, {local_world}, '
            f'{node}: the port runs the same number of ranks on every node, '
            'a node\'s ranks numbered contiguously')
    return DistContext(world, rank, local_rank, local_world, node)


def slurm_context() -> Tuple[DistContext, str]:
    """(context, coordinator 'host:port') of a task started by `srun`:
    rank `SLURM_PROCID` of `SLURM_NTASKS`, local rank `SLURM_LOCALID` on
    node `SLURM_NODEID` of `SLURM_STEP_NUM_NODES`; the coordinator is the
    first host of `SLURM_STEP_NODELIST` at `MASTER_PORT`, else at JAX's
    port for the job, `SLURM_JOB_ID` mod 4096 + 61440. A missing variable
    raises and names itself."""
    env = _require(_SLURM_KEYS, 'slurm')
    world, nodes = int(env['SLURM_NTASKS']), int(env['SLURM_STEP_NUM_NODES'])
    ctx = _homogeneous(
        world, int(env['SLURM_PROCID']), int(env['SLURM_LOCALID']),
        world // nodes if nodes > 0 and world % nodes == 0 else 0,
        int(env['SLURM_NODEID']), 'SLURM_NTASKS, SLURM_PROCID, '
        'SLURM_LOCALID, ranks a node, SLURM_NODEID')
    host = first_slurm_host(env['SLURM_STEP_NODELIST'])
    return ctx, f'{host}:{_coordinator_port(int(env["SLURM_JOB_ID"]))}'


def mpi_context() -> Tuple[DistContext, str]:
    """(context, coordinator 'host:port') of a process started by Open
    MPI's `mpirun`: rank `OMPI_COMM_WORLD_RANK` of `OMPI_COMM_WORLD_SIZE`,
    local rank `OMPI_COMM_WORLD_LOCAL_RANK` of `OMPI_COMM_WORLD_LOCAL_SIZE`
    (node = rank // local size); the coordinator is the launcher's address
    in `OMPI_MCA_orte_hnp_uri` at `MASTER_PORT`, else at JAX's port for the
    job, (job id // 4096) mod 4096 + 61440. A missing variable raises and
    names itself."""
    env = _require(_OMPI_KEYS, 'mpi')
    world, rank = (int(env['OMPI_COMM_WORLD_SIZE']),
                   int(env['OMPI_COMM_WORLD_RANK']))
    local_world = int(env['OMPI_COMM_WORLD_LOCAL_SIZE'])
    ctx = _homogeneous(
        world, rank, int(env['OMPI_COMM_WORLD_LOCAL_RANK']), local_world,
        rank // max(local_world, 1), 'OMPI_COMM_WORLD_{SIZE, RANK, '
        'LOCAL_RANK, LOCAL_SIZE}, node')
    uri = env['OMPI_MCA_orte_hnp_uri']
    found = re.search(r'tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]', uri)
    if found is None:
        raise RuntimeError(f'--launcher mpi: no launcher address in '
                           f'OMPI_MCA_orte_hnp_uri={uri!r}')
    host = next(g for g in found.groups() if g is not None)
    if ':' in host:   # an IPv6 address
        host = f'[{host}]'
    job = int(uri.split('.', 1)[0]) // 2**12
    return ctx, f'{host}:{_coordinator_port(job)}'


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
