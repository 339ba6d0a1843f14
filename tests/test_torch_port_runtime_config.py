"""The port's config, model builder and recipe against the JAX package's.

`Config.fromfile` of both grounding configs, with and without
`--cfg-options`, gives the JAX `Config`'s dicts. From both configs, the
port's state_dict keys and shapes (the model built on the meta device:
no memory) equal `state_dict_from_jax` of the JAX-built model's
parameter shapes (`jax.eval_shape` of its init on a one-view batch of a
few points: the shapes do not depend on the input's size). The
optimizer and schedule the Runner builds take every recipe value of the
config: lr, weight decay, clip norm, milestones and gamma (the values
the JAX Runner reads, engine/runner.py:330-351) and the decoder's lr
multiplier; on a toy parameter set the port's AdamW with those values
steps as JAX's `build_optimizer` does, bit for bit, across both
milestones, with one group clipped and one not, and without a schedule.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from proxytransformation_tpu.engine import train as jtrain
from proxytransformation_tpu.engine.runner import (
    apply_amp as japply_amp, build_model_from_cfg as jbuild)
from proxytransformation_tpu.utils.config import Config as JConfig
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine import train as ttrain
from proxytransformation_torch.engine.runner import (
    Runner, apply_amp, build_model_from_cfg)
from proxytransformation_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / 'configs/grounding/synthetic_smoke.py')
FLAGSHIP = str(ROOT / 'configs/grounding/'
               'proxy-tiblock33-gs12-wbias-ddr0.6-clip.py')
OPTIONS = ['lr=3e-4', 'optim_wrapper.optimizer.lr=3e-4',
           'optim_wrapper.optimizer.weight_decay=0.002',
           'optim_wrapper.clip_grad.max_norm=0.5',
           'param_scheduler.milestones=[1,2]', 'param_scheduler.gamma=0.5',
           'train_cfg.max_epochs=3',
           "optim_wrapper.paramwise_cfg={'custom_keys': {'decoder': "
           "{'lr_mult': 0.25}}}",
           "train_dataloader.dataset.type='SyntheticGroundingDataset'",
           'model.remat=True', 'seed=4']


@pytest.mark.parametrize('path', [SMOKE, FLAGSHIP])
@pytest.mark.parametrize('options', [[], OPTIONS])
def test_config_matches_jax(path, options):
    parsed = Config.parse_cfg_options(options)
    assert parsed == JConfig.parse_cfg_options(options)
    got, want = Config.fromfile(path), JConfig.fromfile(path)
    got.merge_from_dict(parsed)
    want.merge_from_dict(parsed)
    apply_amp(got)
    japply_amp(want)
    assert got.to_dict() == want.to_dict()
    assert got.filename == want.filename


def _jax_shapes(model):
    S = model.img_spacial_dim * 32
    B, V, N, L = 1, 1, 256, 8
    f32, b = jnp.float32, jnp.bool_
    batch = {'imgs': jax.ShapeDtypeStruct((B, V, S, S, 3), f32),
             'points': jax.ShapeDtypeStruct((B, N, 3), f32),
             'points_mask': jax.ShapeDtypeStruct((B, N), b),
             'input_ids': jax.ShapeDtypeStruct((B, L), jnp.int32),
             'text_mask': jax.ShapeDtypeStruct((B, L), b),
             'proj_mats': jax.ShapeDtypeStruct((B, V, 4, 4), f32),
             'views_mask': jax.ShapeDtypeStruct((B, V), b)}
    shapes = jax.eval_shape(
        lambda bt: model.init(jax.random.PRNGKey(0), bt, mode='predict'),
        batch)
    # zero-stride arrays: the converter's layout work without the memory
    return state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes))


@pytest.mark.parametrize('path', [SMOKE, FLAGSHIP])
def test_state_dict_shapes_match_jax(path):
    cfg = Config.fromfile(path)
    apply_amp(cfg)
    port = build_model_from_cfg(cfg['model'], device='meta')
    want = _jax_shapes(jbuild(JConfig.fromfile(path)['model']))
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    # the knobs reach the built model
    assert port.compute_dtype == 'bfloat16' and port.remat_painting
    if path == FLAGSHIP:
        assert port.remat and port.use_xyz_feat
        assert port.backbone.remat and port.backbone_3d.remat \
            and port.decoder.remat
        assert port.n_points == 100_000 and port.max_text_len == 256
    else:
        assert not port.remat and port.n_points == 2048


def test_runner_recipe_takes_the_config(tmp_path):
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_dict(Config.parse_cfg_options(OPTIONS))
    runner = Runner(cfg, str(tmp_path), device='cpu')
    assert runner.model.remat
    runner._steps_per_epoch = 2
    runner._init_state()
    groups = {g['name']: g for g in runner.optimizer.param_groups}
    for g in groups.values():
        assert g['weight_decay'] == 0.002 and g['clip_norm'] == 0.5
        assert g['lr'] == 3e-4
    assert groups['default']['lr_mult'] == 1.0
    assert groups['decoder']['lr_mult'] == 0.25
    want = jtrain.build_lr_schedule(3e-4, 2, max_epochs=3, milestones=[1, 2],
                                    gamma=0.5)
    for step in range(8):
        assert runner.schedule(step) == float(np.float32(want(step))), step
    # without options: the tiny config's own lr of 1e-4 (not the
    # flagship's 5e-4), and its weight decay and clip norm
    assert cfg['lr'] == 3e-4 and Config.fromfile(SMOKE)['lr'] == 1e-4
    plain = Runner(Config.fromfile(SMOKE), str(tmp_path / 'p'), device='cpu')
    plain._init_state()
    assert plain.schedule(0) == float(np.float32(1e-4))
    g = plain.optimizer.param_groups[0]
    assert (g['weight_decay'], g['clip_norm']) == (ttrain.WEIGHT_DECAY,
                                                   ttrain.CLIP_NORM)


class _Toy(nn.Module):
    """Parameters named like the grounder's groups: frozen (text tower,
    2D stem and stage 1), default and decoder."""

    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            mod = self
            *path, leaf = name.split('.')
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(torch.tensor(a)))


@pytest.mark.parametrize('scheduled', [True, False])
def test_adamw_steps_match_optax(scheduled):
    """Four steps across both milestones (one step an epoch), the default
    group's gradients over the clip norm and the decoder's under it;
    without a schedule both sides step at the constant base lr."""
    rng = np.random.RandomState(0)
    names = {'text_encoder.w': ('text_encoder', 'w'),
             'backbone.conv1.weight': ('backbone', 'conv1', 'kernel'),
             'backbone.layer1.0.w': ('backbone', 'layer1_0', 'w'),
             'backbone.layer2.0.w': ('backbone', 'layer2_0', 'w'),
             'neck_3d.w': ('neck_3d', 'w'),
             'decoder.w': ('decoder', 'w')}
    arrays = {n: rng.randn(3, 4).astype(np.float32) for n in names}
    recipe = dict(base_lr=3e-4, weight_decay=0.002, clip_norm=0.5)
    sched_kw = dict(milestones=(1, 2), gamma=0.5)

    params = {}
    for n, path in names.items():
        d = params
        for part in path[:-1]:
            d = d.setdefault(part, {})
        d[path[-1]] = jnp.asarray(arrays[n])
    tx = jtrain.build_optimizer(
        params, decoder_lr_mult=0.25,
        schedule=(jtrain.build_lr_schedule(3e-4, 1, **sched_kw)
                  if scheduled else None), **recipe)
    opt_state = tx.init(params)
    toy = _Toy(arrays)
    opt = ttrain.build_optimizer(toy, decoder_lr_mult=0.25, **recipe)
    schedule = (ttrain.build_lr_schedule(3e-4, 1, **sched_kw)
                if scheduled else None)
    for step in range(4):
        grads_np = {n: (rng.randn(3, 4) * (0.05 if 'decoder' in n else 3.0))
                    .astype(np.float32) for n in names}
        jgrads = jax.tree_util.tree_map(jnp.zeros_like, params)
        for n, path in names.items():
            d = jgrads
            for part in path[:-1]:
                d = d[part]
            d[path[-1]] = jnp.asarray(grads_np[n])
        updates, opt_state = jax.jit(tx.update)(jgrads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in toy.named_parameters():
            p.grad = torch.tensor(grads_np[n])
        opt.step(schedule)
        for n, path in names.items():
            want = params
            for part in path:
                want = want[part]
            got = dict(toy.named_parameters())[n].detach().numpy()
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f'{n} step {step}')
    assert np.array_equal(dict(toy.named_parameters())['text_encoder.w']
                          .detach().numpy(), arrays['text_encoder.w'])
