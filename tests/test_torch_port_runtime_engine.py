"""The port's runtime on the CPU: remat, the grounder's config knobs,
checkpoints and resume.

- `remat=True` and `remat=False` give equal losses, gradients and
  running statistics after a train step (a checkpointed block's
  recompute must not update the running statistics a second time), and
  with remat each checkpointed block runs its forward twice.
- The model builder and the Runner raise on what the port cannot honour
  rather than dropping it; the detection configs build the detector, and
  its builder raises on a key it does not take and on `--amp`; TTA
  raises outside grounding and runs on a grounding config.
- Checkpoints: rotation, `latest_checkpoint`, a warm start that copies
  only parameters of matching name and shape (also from an upstream
  `.pth` through `load_from`). A run resumed from a mid-epoch checkpoint
  (fast resume) and one resumed with `--resume auto` at an epoch's end
  equal the uninterrupted runs bit for bit: parameters, running
  statistics, AdamW moments and counts, and the dropout generator.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from proxytransformation_torch.engine import checkpoint as ckpt
from proxytransformation_torch.engine.runner import (
    Runner, apply_amp, build_model_from_cfg)
from proxytransformation_torch.engine.train import (
    build_lr_schedule, build_optimizer, make_train_step)
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)
from proxytransformation_torch.models.embodied_det3d import (
    Embodied3DDetector)
from proxytransformation_torch.models.layers import random_init_
from proxytransformation_torch.utils.config import Config

from test_detector import tiny_batch
from test_torch_port_detector import TINY

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / 'configs/grounding/synthetic_smoke.py')
DET_SMOKE = str(ROOT / 'configs/detection/synthetic_smoke.py')
DET_FULL = str(ROOT / 'configs/detection/embodied-det3d-resnet50.py')
# two steps an epoch, no validation unless asked
SHORT = ['train_dataloader.dataset.length=4', 'train_cfg.val_interval=99',
         'val_dataloader.dataset.length=2']


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def smoke_cfg(*options):
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_dict(Config.parse_cfg_options(list(options)))
    return cfg


# --------------------------------------------------------------------------
# remat and the grounder's knobs
# --------------------------------------------------------------------------
def test_remat_equals_no_remat():
    batch = batch_to_device({k: np.asarray(v) for k, v in
                             tiny_batch(np.random.RandomState(1)).items()},
                            'cpu')
    out, runs = {}, {}
    for remat in (False, True):
        model = TGrounder(**TINY, remat=remat, device='cpu')
        random_init_(model, torch.Generator().manual_seed(3))
        blocks = (model.backbone.layer2[0], model.backbone_3d.layer1[0],
                  model.decoder.layers[0])
        calls = []
        for blk in blocks:
            # a pre-hook: the recompute stops once it has every saved
            # tensor, before the block's forward hooks would run
            blk.register_forward_pre_hook(
                lambda m, a, blk=blk: calls.append(blk))
        step = make_train_step(model, build_optimizer(model),
                               build_lr_schedule(1e-4, 1))
        metrics = step(batch, torch.Generator().manual_seed(0))
        runs[remat] = [sum(c is b for c in calls) for b in blocks]
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        out[remat] = (metrics, grads, model.state_dict())
    assert runs == {False: [1, 1, 1], True: [2, 2, 2]}
    (m0, g0, s0), (m1, g1, s1) = out[False], out[True]
    assert set(m0) == set(m1) and set(g0) == set(g1) and set(s0) == set(s1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:   # parameters after the step and the running statistics
        assert torch.equal(s0[k], s1[k]), k
    assert any('running_var' in k and not torch.equal(v, torch.ones_like(v))
               for k, v in s1.items())


def test_use_xyz_feat_false_voxelizes_the_colour():
    model = TGrounder(**TINY, use_xyz_feat=False, device='cpu')
    random_init_(model, torch.Generator().manual_seed(2))
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1)).items()}
    with pytest.raises(ValueError, match='>3 channels'):
        model(batch_to_device(batch, 'cpu'))
    rng = np.random.RandomState(5)
    outs = []
    for colour in (rng.rand(2, 1024, 3), rng.rand(2, 1024, 3)):
        b = dict(batch, points=np.concatenate([batch['points'], colour], -1)
                 .astype(np.float32))
        outs.append(model(batch_to_device(b, 'cpu'))['scores_3d'])
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize('change,error,match', [
    # every t_type of the JAX package's dispatch builds; others raise
    ({'t_type': 'word2vec'}, ValueError, 'unknown t_type'),
    # the neck takes the basic MinkResNet's widths only
    ({'backbone_3d': {'depth': 50, 'in_channels': 3}}, ValueError,
     '64/128/256/512'),
    # the detector's builder takes none of the grounder's keys
    ({'type': 'Embodied3DDetector'}, ValueError, "'preshape'"),
    # the occupancy builder takes none of the grounder's keys either
    ({'type': 'EmbodiedOccPredictor'}, ValueError, "'preshape'"),
    # the baseline grounder takes no preshape block
    ({'type': 'SparseFeatureFusion3DGrounder'}, ValueError,
     'model.preshape'),
    ({'type': 'SomethingElse'}, KeyError, 'unknown model type'),
    ({'use_preshape': False}, ValueError, 'use_preshape'),
    ({'backbone_3d': {'depth': 14, 'in_channels': 6}}, NotImplementedError,
     'in_channels'),
    ({'decoder': {'num_layers': 2, 'return_intermediate': False}},
     NotImplementedError, 'return_intermediate'),
    ({'neck_3d': {'voxel_size': 0.1}}, ValueError, 'voxel_size'),
    ({'backbone': {'depth': 50, 'base_channels': 4, 'frozen_stages': 2}},
     ValueError, 'frozen_stages'),
])
def test_model_builder_drops_nothing(change, error, match):
    cfg = smoke_cfg()['model']
    cfg.update(change)
    with pytest.raises(error, match=match):
        build_model_from_cfg(cfg, device='meta')


@pytest.mark.parametrize('config,option,match', [
    (SMOKE, "custom_hooks=[{'type':'EMAHook','ema_type':"
     "'ExponentialMovingAverage'}]", 'ExpMomentumEMA hook only'),
    (SMOKE, "optim_wrapper.optimizer.type='SGD'", 'AdamW only'),
    # --amp on the detector: the JAX package's has no bfloat16 mode
    (DET_SMOKE, None, 'no bfloat16 mode'),
], ids=["custom_hooks=[{'type':'EMAHook','ema_type':"
        "'ExponentialMovingAverage'}]-ExpMomentumEMA hook only",
        "optim_wrapper.optimizer.type='SGD'-AdamW only",
        'detection --amp-no bfloat16 mode'])
def test_runner_raises_on_what_it_cannot_honour(tmp_path, config, option,
                                                match):
    cfg = Config.fromfile(config)
    if option is None:
        apply_amp(cfg)
    else:
        cfg.merge_from_dict(Config.parse_cfg_options([option]))
    with pytest.raises(NotImplementedError, match=match):
        Runner(cfg, str(tmp_path), device='cpu').train()


@pytest.mark.parametrize('config', [DET_SMOKE, DET_FULL],
                         ids=['synthetic_smoke', 'embodied_det3d'])
def test_detection_configs_build_the_detector(config):
    """Both detection configs build `Embodied3DDetector` (on the meta
    device) with every key they hold; 12 regression outputs or the RotMat
    head give the 6-D rotation."""
    model_cfg = Config.fromfile(config)['model']
    model = build_model_from_cfg(model_cfg, device='meta')
    head = model.bbox_head
    assert isinstance(model, Embodied3DDetector)
    assert head.num_classes == model_cfg['num_classes']
    assert head.rot_param == 'euler'
    assert model.n_points == model_cfg['n_points']
    assert head.conv_reg.kernel.shape[-1] == 9
    plain = {k: v for k, v in model_cfg['bbox_head'].items()
             if k != 'num_reg_outs'}
    for head_cfg in (dict(plain, num_reg_outs=12),
                     dict(plain, type='FCAF3DHeadRotMat')):
        cfg = dict(model_cfg, bbox_head=head_cfg)
        rot = build_model_from_cfg(cfg, device='meta').bbox_head
        assert rot.rot_param == 'ortho6d'
        assert rot.conv_reg.kernel.shape[-1] == 12


@pytest.mark.parametrize('change,error,match', [
    ({'bbox_head': {'loss_cls': {'type': 'FocalLoss'}}}, ValueError,
     'bbox_head.loss_cls'),
    ({'test_cfg': {'use_rotation': False}}, ValueError,
     'test_cfg.use_rotation'),
    ({'bbox_head': {'type': 'FCAF3DHeadRotMat', 'num_reg_outs': 9}},
     ValueError, 'num_reg_outs'),
    ({'bbox_head': {'num_classes': 3}}, ValueError, 'num_classes'),
    ({'backbone_3d': {'depth': 14, 'in_channels': 6}}, NotImplementedError,
     'in_channels'),
    ({'compute_dtype': 'bfloat16'}, NotImplementedError, 'no bfloat16'),
])
def test_detection_builder_raises_on_what_it_cannot_honour(change, error,
                                                           match):
    cfg = Config.fromfile(DET_SMOKE)['model']
    for k, v in change.items():
        cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
    with pytest.raises(error, match=match):
        build_model_from_cfg(cfg, device='meta')


def test_tta_raises(tmp_path):
    """TTA raises outside grounding (the occupancy config), and on the
    grounding config scores the merged copies."""
    occ = Config.fromfile(str(ROOT / 'configs/occupancy/synthetic_smoke.py'))
    with pytest.raises(NotImplementedError, match='grounding-path'):
        Runner(occ, str(tmp_path), device='cpu').test(tta=True)
    results = Runner(smoke_cfg('val_dataloader.dataset.length=2'),
                     str(tmp_path), device='cpu').test(tta=True)
    assert 'Overall@0.25' in results


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _tiny_model(seed):
    model = TGrounder(**TINY, device='cpu')
    return random_init_(model, torch.Generator().manual_seed(seed))


def test_checkpoint_rotation_and_latest(tmp_path):
    model = _tiny_model(0)
    opt = build_optimizer(model)
    gen = torch.Generator().manual_seed(1)
    os.makedirs(tmp_path / 'not_a_ckpt')
    for step in (3, 10, 7):
        ckpt.save_checkpoint(str(tmp_path), model, opt, step, epoch=1,
                             max_keep=2, generator=gen)
    assert sorted(ckpt.list_checkpoints(str(tmp_path))) == [
        'ckpt_00000007', 'ckpt_00000010']
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest == os.path.join(str(tmp_path), 'ckpt_00000010')
    payload = ckpt.load_checkpoint(latest)
    assert (payload['step'], payload['epoch'], payload['iteration']) == (
        10, 1, 0)
    assert torch.equal(payload['generator'], gen.get_state())
    assert ckpt.latest_checkpoint(str(tmp_path / 'missing')) is None


def test_warm_start_copies_matching_parameters_only(tmp_path):
    model, src = _tiny_model(0), _tiny_model(1)
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    sd['decoder.norm.weight'] = torch.zeros(7)            # wrong shape
    sd['no.such.parameter'] = torch.zeros(3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = ckpt.warm_start_params(model, sd)
    params = dict(model.named_parameters())
    assert n == len(params) - 1
    for k, v in model.state_dict().items():
        if k == 'decoder.norm.weight' or k not in params:   # kept
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, sd[k]), k


def test_load_from_pth_warm_starts_the_runner(tmp_path):
    cfg = smoke_cfg(*SHORT)
    donor = Runner(cfg, str(tmp_path / 'a'), device='cpu')
    donor._init_state()
    sd = {k: v + 1.0 for k, v in donor.model.state_dict().items()
          if k.startswith('decoder.')}
    torch.save({'state_dict': sd, 'meta': {'epoch': 12}},
               tmp_path / 'upstream.pth')
    cfg['load_from'] = str(tmp_path / 'upstream.pth')
    runner = Runner(cfg, str(tmp_path / 'b'), device='cpu')
    runner._init_state()
    got = runner.model.state_dict()
    for k, v in donor.model.state_dict().items():
        moved = k in sd and 'running' not in k
        assert torch.equal(got[k], sd[k] if moved else v), k
    cfg['load_from'] = str(tmp_path / 'missing.pth')
    with pytest.raises(FileNotFoundError):
        Runner(cfg, str(tmp_path / 'c'), device='cpu')._init_state()


def _train_state(runner):
    opt = runner.optimizer
    return {
        'model': {k: v.clone() for k, v in runner.model.state_dict().items()},
        'moments': [{k: v.clone() for k, v in opt.state[p].items()}
                    for g in opt.param_groups for p in g['params']],
        'counts': [g['count'] for g in opt.param_groups],
        'generator': runner.generator.get_state(),
        'step': runner.global_step,
    }


def assert_same_state(got, want):
    assert got['step'] == want['step']
    assert got['counts'] == want['counts']
    assert torch.equal(got['generator'], want['generator'])
    for k, v in want['model'].items():
        assert torch.equal(got['model'][k], v), k
    assert len(got['moments']) == len(want['moments'])
    for g, w in zip(got['moments'], want['moments']):
        assert set(g) == set(w) == {'mu', 'nu'}
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_fast_resume_mid_epoch_is_bit_equal(tmp_path):
    """Two steps uninterrupted (a checkpoint after each) against the
    second step resumed from the first step's mid-epoch checkpoint."""
    cfg = smoke_cfg(*SHORT, 'checkpoint_interval_iters=1')
    whole = Runner(cfg, str(tmp_path / 'whole'), device='cpu')
    whole.train()
    mid = tmp_path / 'whole' / 'ckpt_00000001'
    payload = ckpt.load_checkpoint(str(mid))
    assert (payload['epoch'], payload['iteration']) == (0, 1)
    resumed = Runner(cfg, str(tmp_path / 'resumed'), device='cpu')
    resumed.train(resume=str(mid))
    assert [r['iter'] for r in resumed.train_log] == [2]
    assert_same_state(_train_state(resumed), _train_state(whole))


def test_resume_auto_at_an_epoch_end_is_bit_equal(tmp_path):
    """Two epochs of one step uninterrupted against one epoch, then
    `--resume auto` with max_epochs=2 in the same work dir; the restored
    state equals the one saved."""
    one_step = (*SHORT, 'train_dataloader.dataset.length=2')
    whole = Runner(smoke_cfg(*one_step, 'train_cfg.max_epochs=2'),
                   str(tmp_path / 'whole'), device='cpu')
    whole.train()
    first = Runner(smoke_cfg(*one_step), str(tmp_path / 'split'),
                   device='cpu')
    first.train()
    saved = _train_state(first)
    second = Runner(smoke_cfg(*one_step, 'train_cfg.max_epochs=2'),
                    str(tmp_path / 'split'), device='cpu')
    restored = {}
    resume_from = second.resume_from

    def spy(path):
        out = resume_from(path)
        restored.update(_train_state(second))
        return out

    second.resume_from = spy
    second.train(resume='auto')
    assert_same_state(restored, saved)
    assert [(r['epoch'], r['iter']) for r in second.train_log] == [(1, 1)]
    assert_same_state(_train_state(second), _train_state(whole))
