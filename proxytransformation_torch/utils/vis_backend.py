"""Experiment-tracking backends (wandb / local JSONL).

The port's own copy of proxytransformation_tpu/utils/vis_backend.py:
mmengine's `LocalVisBackend` (configs/...clip.py:238-244) and the wandb
logger of the reference's `tools/train.py --use_wandb` (:138-149).
`WandbVisBackend` uses wandb where it is importable and configured and
otherwise degrades to a warning; `LocalVisBackend` appends scalar dicts
to `scalars.jsonl` in the work dir.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional, Sequence

from .registry import VISBACKENDS

logger = logging.getLogger('proxytransformation_torch')


@VISBACKENDS.register_module()
class LocalVisBackend:
    """Append-only JSONL scalar log."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self._path = os.path.join(save_dir, 'scalars.jsonl')

    def add_scalars(self, scalars: Dict[str, float],
                    step: Optional[int] = None) -> None:
        rec = {'time': time.time(), 'step': step}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self._path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def add_config(self, cfg: Dict) -> None:
        with open(os.path.join(self.save_dir, 'config.json'), 'w') as f:
            json.dump(cfg, f, default=str, indent=1)

    def close(self) -> None:
        pass


@VISBACKENDS.register_module()
class WandbVisBackend:
    """wandb logger; degrades to a no-op with a warning when wandb is
    unavailable (zero-egress images can't reach the service anyway)."""

    def __init__(self, save_dir: str, project: str = 'proxytransformation',
                 name: Optional[str] = None, **init_kw):
        self._run = None
        try:
            import wandb
            self._run = wandb.init(project=project, name=name,
                                   dir=save_dir, **init_kw)
        except Exception as e:  # ImportError or offline init failure
            logger.warning('wandb unavailable (%s); scalars only go to '
                           'the local backend', e)

    def add_scalars(self, scalars: Dict[str, float],
                    step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(dict(scalars), step=step)

    def add_config(self, cfg: Dict) -> None:
        if self._run is not None:
            self._run.config.update(cfg, allow_val_change=True)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


def build_vis_backends(cfg, work_dir: str) -> Sequence:
    """From the reference-style `visualizer.vis_backends` config list,
    built through the VISBACKENDS registry (reference registry.py:11-36
    has a dedicated VISBACKENDS registry; same surface here)."""
    specs = (cfg.get('visualizer', {}) or {}).get(
        'vis_backends', [{'type': 'LocalVisBackend'}])
    out = []
    for spec in specs:
        spec = dict(spec)
        t = spec.get('type', 'LocalVisBackend')
        if t == 'WandbVisBackend':
            out.append(VISBACKENDS.build(spec, save_dir=work_dir))
        else:
            kw = {k: v for k, v in spec.items() if k != 'type'}
            out.append(LocalVisBackend(kw.pop('save_dir', work_dir)))
            if kw:
                logger.warning('LocalVisBackend: ignoring unsupported '
                               'config keys %s', sorted(kw))
    return out
