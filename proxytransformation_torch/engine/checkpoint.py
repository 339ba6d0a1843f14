"""Checkpoint save / restore with rotation, auto-resume and warm start.

Counterpart of proxytransformation_tpu/engine/checkpoint.py (the
reference's CheckpointHook: interval 1 epoch, max_keep_ckpts, `--resume
auto|path`, warm start through `load_from`; configs/...clip.py:226-227,
tools/train.py:119-125). The same `ckpt_{step:08d}` directories, each
holding one `state.pth` written by `torch.save`: the model's state_dict
(running statistics included), the AdamW state (each group's `count`,
lr multiplier, weight decay and clip norm with it), the global `step`,
the `epoch` to start from, the `iteration` reached inside it (0 at an
epoch's end), the dropout generator's state and, with the EMA hook, the
EMA weights (name → tensor; None without the hook).
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch
from torch import nn

_STATE_FILE = 'state.pth'


def _ckpt_dir(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f'ckpt_{step:08d}')


def save_checkpoint(work_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int, epoch: int,
                    max_keep: int = 2, iteration: int = 0,
                    generator: Optional[torch.Generator] = None,
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Save the train state after `step` optimizer steps and keep the
    newest `max_keep` checkpoints. `iteration` > 0 marks a mid-epoch
    checkpoint: on resume the runner skips that many consumed batches of
    `epoch` (the reference's FastResumeIterBasedTrainLoop,
    runner/loops.py:55-67)."""
    path = os.path.abspath(_ckpt_dir(work_dir, step))
    os.makedirs(path, exist_ok=True)
    payload = {
        'model': model.state_dict(),
        'optimizer': optimizer.state_dict(),
        'step': int(step),
        'epoch': int(epoch),
        'iteration': int(iteration),
        'generator': None if generator is None else generator.get_state(),
        'ema': ema,
    }
    tmp = os.path.join(path, _STATE_FILE + '.tmp')
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    for old in sorted(list_checkpoints(work_dir))[:-max_keep]:
        shutil.rmtree(os.path.join(work_dir, old), ignore_errors=True)
    return path


def list_checkpoints(work_dir: str):
    if not os.path.isdir(work_dir):
        return []
    return [d for d in os.listdir(work_dir)
            if re.fullmatch(r'ckpt_\d+', d)]


def latest_checkpoint(work_dir: str) -> Optional[str]:
    ckpts = sorted(list_checkpoints(work_dir))
    return os.path.join(work_dir, ckpts[-1]) if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint directory, its tensors on the CPU."""
    return torch.load(os.path.join(path, _STATE_FILE), map_location='cpu',
                      weights_only=True)


def restore_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                  payload: Dict[str, Any],
                  generator: Optional[torch.Generator] = None,
                  ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Full resume: the model's parameters and buffers, the optimizer's
    moments and group values, the generator's state and the EMA weights,
    in place."""
    model.load_state_dict(payload['model'])
    optimizer.load_state_dict(payload['optimizer'])
    if generator is not None:
        if payload.get('generator') is None:
            raise ValueError('the checkpoint holds no generator state')
        generator.set_state(payload['generator'])
    if ema is not None:
        if payload.get('ema') is None:
            raise ValueError('the checkpoint holds no EMA weights')
        with torch.no_grad():
            for name, e in ema.items():
                e.copy_(payload['ema'][name])


@torch.no_grad()
def warm_start_params(model: nn.Module, state_dict: Dict[str, Any]) -> int:
    """`load_from` semantics: copy the parameters whose name and shape
    match an entry of `state_dict`; every other parameter, and every
    buffer, keeps its value. Returns the number copied."""
    copied = 0
    for name, p in model.named_parameters():
        src = state_dict.get(name)
        if src is not None and tuple(src.shape) == tuple(p.shape):
            p.copy_(torch.as_tensor(src))
            copied += 1
    return copied


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A PyTorch .pth state_dict (an upstream checkpoint's 'state_dict'
    entry where it has one), as CPU tensors."""
    sd = torch.load(path, map_location='cpu', weights_only=False)
    if 'state_dict' in sd:
        sd = sd['state_dict']
    return {k: torch.as_tensor(v) for k, v in sd.items()}
