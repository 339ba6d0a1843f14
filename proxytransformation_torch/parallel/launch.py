"""The CLIs' `--launcher` (the reference's mmengine `init_dist`,
tools/train.py:51-54; the JAX CLIs keep the flag, tools/train.py:30-45).

- `none`: one process, as without the flag;
- `pytorch`: the process group from torchrun's environment
  (`python -m torch.distributed.run --nproc_per_node N -m
  proxytransformation_torch.tools.train CONFIG --launcher pytorch`), with
  the backend, timeout and rendezvous of the config's
  `env_cfg.dist_cfg` (mmengine's key; backend default `nccl`);
- `slurm`: a task of `srun` (`srun -N NODES --ntasks-per-node N python -m
  proxytransformation_torch.tools.train CONFIG --launcher slurm`), its
  rank, world and local rank from SLURM's environment as
  `jax.distributed.initialize()` detects them (`dist.slurm_context`);
- `mpi`: a process of Open MPI's `mpirun` (`dist.mpi_context`).

Under `slurm` and `mpi` the rendezvous is `tcp://` at the coordinator,
the first host of the job at `MASTER_PORT` (else the port JAX derives from
the job id), unless `env_cfg.dist_cfg.init_method` names another. A
variable the launcher needs and does not find raises and names itself;
nothing falls back to one process.

Each rank runs on `--device`, by default `cuda:{LOCAL_RANK}`. NCCL needs
a card of its own for every rank of a node: a CPU device, one named
device for several ranks, or more ranks than cards raise and name the
backend option; nothing falls back from one backend to another.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch

from .dist import (DEFAULT_TIMEOUT_S, DistContext, destroy_process_group,
                   env_context, init_process_group, mpi_context,
                   slurm_context)

LAUNCHERS = ('none', 'pytorch', 'slurm', 'mpi')
_DIST_CFG_KEYS = {'backend', 'timeout', 'init_method'}
_CLUSTERS = {'slurm': slurm_context, 'mpi': mpi_context}
_GLOO_OPTION = '--cfg-options env_cfg.dist_cfg.backend=gloo'


def dist_cfg_of(cfg) -> Dict[str, Any]:
    """`env_cfg.dist_cfg` with its defaults; another key raises."""
    dist_cfg = dict((cfg.get('env_cfg') or {}).get('dist_cfg') or {})
    unknown = sorted(set(dist_cfg) - _DIST_CFG_KEYS)
    if unknown:
        raise NotImplementedError(f'env_cfg.dist_cfg keys {unknown}: the '
                                  f'port takes {sorted(_DIST_CFG_KEYS)}')
    return dict(backend=dist_cfg.get('backend', 'nccl'),
                timeout=float(dist_cfg.get('timeout', DEFAULT_TIMEOUT_S)),
                init_method=dist_cfg.get('init_method'))


def launcher_context(launcher: str, cfg) -> tuple:
    """(context, rendezvous) of `launcher` ('pytorch', 'slurm' or 'mpi')
    from this process's environment; the config's `init_method` wins over
    the launcher's own (`env://` for torchrun, `tcp://` at the coordinator
    for SLURM and Open MPI)."""
    named = dist_cfg_of(cfg)['init_method']
    if launcher == 'pytorch':
        return env_context(), named or 'env://'
    ctx, coordinator = _CLUSTERS[launcher]()
    return ctx, named or f'tcp://{coordinator}'


def rank_device(ctx: DistContext, device: Optional[str], backend: str
                ) -> str:
    """This rank's device: `device`, or `cuda:{local_rank}` when it names
    none (or the bare 'cuda'); raises where NCCL would share a device."""
    named = device not in (None, 'cuda')
    dev = torch.device(device if named else f'cuda:{ctx.local_rank}')
    if backend == 'nccl':
        if dev.type != 'cuda':
            raise ValueError(
                f'--device {device}: the nccl backend runs on CUDA devices; '
                f'CPU ranks take {_GLOO_OPTION}')
        if named and ctx.local_world > 1:
            raise ValueError(
                f'--device {device} for the {ctx.local_world} ranks of a '
                'node: the nccl backend cannot run two ranks on one device; '
                f'take {_GLOO_OPTION}, or one card a rank (no --device)')
        cards = torch.cuda.device_count()
        if torch.cuda.is_available() and (dev.index or 0) >= cards:
            raise ValueError(
                f'rank {ctx.rank} on {dev}: the node has {cards} card(s) for '
                f'{ctx.local_world} ranks, and the nccl backend cannot run '
                f'two ranks on one device; take {_GLOO_OPTION} with '
                '--device cuda:0')
    return str(dev)


@contextlib.contextmanager
def launched(launcher: str, cfg, device: Optional[str]
             ) -> Iterator[Optional[str]]:
    """Inside the block this process belongs to the launcher's process
    group (left again on exit); yields the device the rank runs on. A
    group the caller made already is used as it is."""
    if launcher in ('none', ''):
        yield device
        return
    if launcher not in LAUNCHERS:
        raise ValueError(f'--launcher {launcher!r}: one of {LAUNCHERS}')
    if torch.distributed.is_initialized():
        yield device
        return
    ctx, init_method = launcher_context(launcher, cfg)
    opts = dist_cfg_of(cfg)
    rank_dev = rank_device(ctx, device, opts['backend'])
    if rank_dev.startswith('cuda') and torch.cuda.is_available():
        torch.cuda.set_device(rank_dev)
    init_process_group(ctx, opts['backend'], init_method, opts['timeout'])
    try:
        yield rank_dev
    finally:
        destroy_process_group()
