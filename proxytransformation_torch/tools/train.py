"""Training CLI (the port's twin of tools/train.py).

    python -m proxytransformation_torch.tools.train CONFIG [--work-dir DIR]
        [--resume [auto|PATH]] [--amp] [--device cpu|cuda]
        [--launcher none|pytorch|slurm|mpi] [--cfg-options k=v ...]

Without `--device` it runs on the card and raises when there is none.
`main(argv)` returns the Runner, for callers in the same process.

Data-parallel, one rank a process (`parallel/`):

    python -m torch.distributed.run --nproc_per_node N \
        -m proxytransformation_torch.tools.train CONFIG --launcher pytorch
        [--device cpu --cfg-options env_cfg.dist_cfg.backend=gloo]

or on a SLURM cluster (Open MPI: `mpirun ... --launcher mpi`), one task
a card, the rendezvous at the first node's `MASTER_PORT` (else a port
derived from the job id):

    srun -N NODES --ntasks-per-node N python -m \
        proxytransformation_torch.tools.train CONFIG --launcher slurm

The config's batch size is a node's, split over its ranks.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..engine.runner import Runner, apply_amp
from ..parallel.launch import LAUNCHERS, launched
from ..utils.config import Config


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Train a grounder')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume', nargs='?', const='auto', default=None,
                        help='resume from latest (auto) or a path')
    parser.add_argument('--amp', action='store_true',
                        help='bfloat16 compute path (the reference\'s AMP): '
                             'sets model.compute_dtype=bfloat16 and '
                             'checkpoints the painting; geometry, norm '
                             'statistics and losses stay float32')
    parser.add_argument('--device', default=None,
                        help='torch device; default: the card (with '
                             'a launcher: cuda:LOCAL_RANK)')
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none',
                        help='job launcher: pytorch joins the process '
                             'group of python -m torch.distributed.run, '
                             'slurm that of srun\'s tasks, mpi that of '
                             'Open MPI\'s mpirun (backend: '
                             'env_cfg.dist_cfg.backend, default nccl)')
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def work_dir_of(args, cfg) -> str:
    return args.work_dir or cfg.get(
        'work_dir', os.path.join('work_dirs', os.path.splitext(
            os.path.basename(args.config))[0]))


def add_wandb(cfg) -> None:
    """--use_wandb: a wandb backend beside the local one (reference
    tools/train.py:138-149); it degrades to the local one offline."""
    vis = cfg.setdefault('visualizer', {})
    backends = vis.setdefault('vis_backends', [])
    if not backends:
        backends.append({'type': 'LocalVisBackend'})
    if not any(b.get('type') == 'WandbVisBackend' for b in backends):
        backends.append({'type': 'WandbVisBackend'})


def main(argv: Optional[Sequence[str]] = None) -> Runner:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(Config.parse_cfg_options(args.cfg_options))
    if args.amp:
        apply_amp(cfg)
    if args.use_wandb:
        add_wandb(cfg)
    with launched(args.launcher, cfg, args.device) as device:
        runner = Runner.from_cfg(cfg, work_dir_of(args, cfg), device)
        runner.train(resume=args.resume)
    return runner


if __name__ == '__main__':
    main()
