"""Evaluation CLI (the port's twin of tools/eval.py): the val split and
its metric through the Runner, on the weights of `--resume`.

    python -m proxytransformation_torch.tools.eval CONFIG
        [--resume CHECKPOINT] [--work-dir DIR] [--device cpu|cuda]
        [--cfg-options k=v ...]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..engine.runner import Runner
from ..utils.config import Config
from .train import add_wandb, work_dir_of


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Evaluate a grounder')
    parser.add_argument('config')
    parser.add_argument('--work-dir')
    parser.add_argument('--resume', default=None,
                        help='checkpoint to load weights from')
    parser.add_argument('--device', default=None,
                        help='torch device; default: the card')
    parser.add_argument('--use_wandb', action='store_true')
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_dict(Config.parse_cfg_options(args.cfg_options))
    if args.use_wandb:
        add_wandb(cfg)
    runner = Runner.from_cfg(cfg, work_dir_of(args, cfg), args.device)
    return runner.val(resume=args.resume)


if __name__ == '__main__':
    main()
