"""Test CLI (the port's twin of tools/test.py): the test split through
the Runner, with the config's test loader and evaluator (a format_only
evaluator writes `test_results.json` to the work dir); `--tta` predicts
the augmented copies of the config's `tta_cfg` and merges them
(grounding configs only).

    python -m proxytransformation_torch.tools.test CONFIG [CHECKPOINT]
        [--work-dir DIR] [--tta] [--device cpu|cuda]
        [--launcher none|pytorch|slurm|mpi] [--cfg-options k=v ...]

Under `--launcher pytorch` the ranks predict the loader's batches in
turn and rank 0 scores them all and writes the result files.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..engine.runner import Runner
from ..parallel.launch import LAUNCHERS, launched
from ..utils.config import Config
from .train import work_dir_of


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description='Test a grounder, a detector or an occupancy model')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--work-dir')
    parser.add_argument('--tta', action='store_true',
                        help='test-time augmentation (grounding only)')
    parser.add_argument('--device', default=None,
                        help='torch device; default: the card (with '
                             'a launcher: cuda:LOCAL_RANK)')
    parser.add_argument('--launcher', choices=LAUNCHERS, default='none',
                        help='job launcher: pytorch joins the process '
                             'group of python -m torch.distributed.run, '
                             'slurm that of srun\'s tasks, mpi that of '
                             'Open MPI\'s mpirun (backend: '
                             'env_cfg.dist_cfg.backend, default nccl)')
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(Config.parse_cfg_options(args.cfg_options))
    if 'test_dataloader' in cfg:
        cfg['val_dataloader'] = cfg['test_dataloader']
    if 'test_evaluator' in cfg:
        cfg['val_evaluator'] = cfg['test_evaluator']
    with launched(args.launcher, cfg, args.device) as device:
        runner = Runner.from_cfg(cfg, work_dir_of(args, cfg), device)
        return runner.test(resume=args.checkpoint, tta=args.tta)


if __name__ == '__main__':
    main()
