"""Training step: optimizer, learning-rate schedule, one AdamW step.

Counterpart of proxytransformation_tpu/engine/train.py (the reference
recipe, configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py:
204-221): AdamW lr 5e-4, weight decay 5e-4, parameter groups with lr
multipliers (text tower and the 2D stem and stage 1 frozen, decoder
×0.1), gradient clipping at norm 10, MultiStep milestones [8, 11] γ=0.1.

The update follows the reference's optax chain element for element, in
float32: clip_by_global_norm(clip_norm) → scale_by_adam →
add_decayed_weights(weight_decay) → scale by -lr. The constants below
are the flagship recipe's; `build_optimizer` and `build_lr_schedule` take
a config's values in their place (`engine.runner` reads them from it).
As `optax.multi_transform` masks each group, the clipping norm is each
group's own, not the global one; the `grad_norm` metric is global over
every parameter, the frozen ones included. Frozen parameters
keep `requires_grad` (their gradients enter `grad_norm`) but are not in
the optimizer, so they stay bit for bit as they are.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import full_float32

Schedule = Callable[[int], float]

# the recipe above, with optax's scale_by_adam defaults for β and eps
BASE_LR = 5e-4
WEIGHT_DECAY = 5e-4
DECODER_LR_MULT = 0.1
CLIP_NORM = 10.0
BETAS = (0.9, 0.999)
EPS = 1e-8
MILESTONES = (8, 11)
GAMMA = 0.1


def build_lr_schedule(base_lr: float, steps_per_epoch: int,
                      max_epochs: int = 12,
                      milestones: Sequence[int] = MILESTONES,
                      gamma: float = GAMMA) -> Schedule:
    """MultiStep lr by epoch: step → float32 lr, `base_lr` scaled by
    `gamma` at each of `milestones` × steps_per_epoch (optax's
    piecewise_constant_schedule; `max_epochs` is kept for the reference
    signature and bounds nothing)."""
    boundaries = sorted({m * steps_per_epoch: gamma for m in milestones}
                        .items())

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for threshold, scale in boundaries:
            if step >= threshold:
                v = np.float32(scale) * v
        return float(v)

    return schedule


def param_label(name: str) -> str:
    """Parameter group of a state_dict name (reference `_label_params`,
    :48): 'frozen', 'decoder' or 'default'."""
    if name.startswith('text_encoder.'):
        return 'frozen'
    if name.startswith(('backbone.conv1.', 'backbone.bn1.',
                        'backbone.layer1.')):
        return 'frozen'
    if name.startswith('decoder.'):
        return 'decoder'
    return 'default'


class AdamW(torch.optim.Optimizer):
    """optax's clip → adam → decoupled weight decay → -lr chain, per
    parameter group. Each group holds 'lr_mult', 'weight_decay' and
    'clip_norm' (the recipe's values unless given) and 'lr', the base lr
    a step takes when no schedule is given; with one, the lr of a step is
    schedule(count) × lr_mult, count being the number of earlier steps."""

    def __init__(self, param_groups, lr: float = BASE_LR,
                 weight_decay: float = WEIGHT_DECAY,
                 clip_norm: float = CLIP_NORM):
        super().__init__(param_groups, dict(lr=lr, lr_mult=1.0,
                                            weight_decay=weight_decay,
                                            clip_norm=clip_norm))

    @torch.no_grad()
    def step(self, schedule: Optional[Schedule] = None):
        b1, b2 = BETAS
        for group in self.param_groups:
            params = group['params']
            if not params:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            clip = group['clip_norm']
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            if not bool(g_norm < clip):
                grads = [(g / g_norm) * clip for g in grads]
            count = group.setdefault('count', 0)
            if schedule is None:
                # optax: a Python float lr times the multiplier, rounded
                # to float32 once
                lr = np.float32(group['lr'] * group['lr_mult'])
            else:
                lr = (np.float32(schedule(count))
                      * np.float32(group['lr_mult']))
            bc1 = 1 - np.float32(b1) ** np.float32(count + 1)
            bc2 = 1 - np.float32(b2) ** np.float32(count + 1)
            for p, g in zip(params, grads):
                st = self.state[p]
                if not st:
                    st['mu'] = torch.zeros_like(p)
                    st['nu'] = torch.zeros_like(p)
                mu = (1 - b1) * g + b1 * st['mu']
                nu = (1 - b2) * (g * g) + b2 * st['nu']
                st['mu'], st['nu'] = mu, nu
                u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + EPS)
                u = u + group['weight_decay'] * p
                p.add_(float(-lr) * u)
            group['count'] = count + 1


def build_optimizer(model: nn.Module, base_lr: float = BASE_LR,
                    weight_decay: float = WEIGHT_DECAY,
                    decoder_lr_mult: float = DECODER_LR_MULT,
                    clip_norm: float = CLIP_NORM) -> AdamW:
    """AdamW over the 'default' and 'decoder' groups of `param_label`
    (the decoder's lr × `decoder_lr_mult`); the frozen group stays out.
    The defaults are the flagship recipe's."""
    groups = {'default': [], 'decoder': []}
    for name, p in model.named_parameters():
        label = param_label(name)
        if label != 'frozen':
            groups[label].append(p)
    return AdamW([{'params': groups['default'], 'name': 'default',
                   'lr_mult': 1.0},
                  {'params': groups['decoder'], 'name': 'decoder',
                   'lr_mult': decoder_lr_mult}],
                 lr=base_lr, weight_decay=weight_decay, clip_norm=clip_norm)


def make_train_step(model: nn.Module, optimizer: AdamW,
                    schedule: Optional[Schedule] = None) -> Callable:
    """train_step(batch, generator=None) → metrics: the losses,
    'total_loss' (their sum) and 'grad_norm' (the global norm of every
    gradient), as float32 scalar tensors; the update takes its lr from
    `schedule` (`build_lr_schedule`; None: the optimizer's constant base
    lr). The loss, its backward and the update run with TF32 off."""

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        model.zero_grad(set_to_none=True)
        with full_float32():
            losses = model.loss(batch, generator)
            # the reference sums the loss dict's leaves in key order
            total = sum(losses[k] for k in sorted(losses))
            total.backward()
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            optimizer.step(schedule)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['total_loss'] = total.detach()
        metrics['grad_norm'] = grad_norm
        return metrics

    return train_step
