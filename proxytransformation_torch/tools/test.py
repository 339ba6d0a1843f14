"""Test CLI (the port's twin of tools/test.py): the test split through
the Runner, with the config's test loader and evaluator (a format_only
evaluator writes `test_results.json` to the work dir).

    python -m proxytransformation_torch.tools.test CONFIG [CHECKPOINT]
        [--work-dir DIR] [--device cpu|cuda] [--cfg-options k=v ...]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..engine.runner import Runner
from ..utils.config import Config
from .train import work_dir_of


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description='Test a grounder')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--work-dir')
    parser.add_argument('--tta', action='store_true',
                        help='test-time augmentation (not ported: raises)')
    parser.add_argument('--device', default=None,
                        help='torch device; default: the card')
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
    runner = Runner.from_cfg(cfg, work_dir_of(args, cfg), args.device)
    return runner.test(resume=args.checkpoint, tta=args.tta)


if __name__ == '__main__':
    main()
