"""The port's grounding test-time augmentation, baseline grounder and
random FPS start against the JAX package's, on the CPU.

- `merge_aug_bboxes_3d` (flips, scale and a rotation angle) within
  MERGE_TOL = 1e-6 · (1 + max|x|), the order of the merged set equal;
  `_tta_metas`, `_apply_tta_aug` and the stacked batch equal;
- the baseline `SparseFeatureFusion3DGrounder` (no preshape) on the tiny
  grounder of tests/test_torch_port_detector.py with its reference-layout
  weights less the preshape's: its state_dict keys are those of the JAX
  model's `init` tree, its predict within the flagship's tolerance (boxes
  and scores within 1e-5 absolute and 1e-4 relative, query masks
  equal);
- FPS from an injected start (the start the JAX package's Gumbel draw
  picks): indices equal; a drawn start uniform over the valid points, and
  the preshape drawing it in train mode only;
- the Runner: `test(tta=True)` on configs/grounding/synthetic_smoke.py,
  the JAX Runner's and the port's from the same converted initial
  weights (two compiles on the JAX side: init and the stacked predict):
  val_results.json equal.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxytransformation_tpu.data  # noqa: F401  (register datasets)
import proxytransformation_tpu.models  # noqa: F401  (register models)
from proxytransformation_tpu.converter.torch_weights import (
    convert_detector)
from proxytransformation_tpu.engine import runner as jrunner_mod
from proxytransformation_tpu.models import tta as jtta
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounder as JBaseline)
from proxytransformation_tpu.ops import fps as jfps
from proxytransformation_tpu.utils.config import Config as JConfig
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine import runner as trunner_mod
from proxytransformation_torch.engine.checkpoint import (latest_checkpoint,
                                                         load_checkpoint)
from proxytransformation_torch.engine.runner import (Runner,
                                                     build_model_from_cfg)
from proxytransformation_torch.models import tta as ttta
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounder, batch_to_device)
from proxytransformation_torch.models.layers import random_init_
from proxytransformation_torch.models.preshape import (
    ProxyTransformationNormReverse)
from proxytransformation_torch.ops import fps as tfps
from proxytransformation_torch.tools import test as ttest
from proxytransformation_torch.tools import train as ttrain_cli
from proxytransformation_torch.utils.config import Config

from test_detector import tiny_batch
from test_torch_port_detector import PREDICT_KEYS, TINY, tiny_state_dict

SMOKE = 'configs/grounding/synthetic_smoke.py'
FLAGSHIP = 'configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py'
MERGE_TOL = 1e-6
TTA_CFGS = {
    'default': {},
    'two_scales_both_flips': {'pts_scale_ratio': [0.9, 1.1], 'flip': True,
                              'flip_direction': ['horizontal', 'vertical']},
    'no_flip': {'pts_scale_ratio': 1.2, 'flip': False},
    'vertical': {'flip_direction': 'vertical'},
}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# merging and the augmented copies
# --------------------------------------------------------------------------
def _aug_results(rng, n_aug, n=12):
    return [{'bboxes_3d': np.concatenate([
        rng.uniform(-3, 3, (n, 3)), rng.uniform(0.2, 2, (n, 3)),
        rng.uniform(-1, 1, (n, 3))], -1).astype(np.float32),
        'scores_3d': rng.uniform(0, 1, n).astype(np.float32)}
        for _ in range(n_aug)]


@pytest.mark.parametrize('meta', [
    {'pcd_horizontal_flip': True},
    {'pcd_vertical_flip': True},
    {'pcd_scale_factor': 1.25},
    {'pcd_rotation_angle': 0.3},
    {'pcd_horizontal_flip': True, 'pcd_vertical_flip': True,
     'pcd_scale_factor': 0.8, 'pcd_rotation_angle': -0.7},
], ids=['h_flip', 'v_flip', 'scale', 'rotation', 'all_four'])
def test_merge_aug_bboxes_3d_matches_jax(meta):
    rng = np.random.RandomState(1)
    results = _aug_results(rng, 2)
    metas = [{'pcd_scale_factor': 1.0}, meta]
    for test_cfg in (None, {'max_num': 10}):
        want = jtta.merge_aug_bboxes_3d(results, metas, test_cfg)
        got = ttta.merge_aug_bboxes_3d(results, metas, test_cfg)
        np.testing.assert_array_equal(got['scores_3d'], want['scores_3d'])
        b, w = got['bboxes_3d'], np.asarray(want['bboxes_3d'])
        assert b.shape == w.shape == (len(got['scores_3d']), 9)
        assert np.abs(b - w).max() <= MERGE_TOL * (1 + np.abs(w).max())


@pytest.mark.parametrize('name', sorted(TTA_CFGS))
def test_tta_metas_equal_jax(name):
    cfg = {'tta_cfg': TTA_CFGS[name]}
    want = jrunner_mod.Runner._tta_metas(types.SimpleNamespace(cfg=cfg))
    got = Runner._tta_metas(types.SimpleNamespace(cfg=cfg))
    assert got == want and len(got) >= 1


def _host_batch(with_scale):
    b = {k: np.asarray(v) for k, v in
         tiny_batch(np.random.RandomState(2)).items()}
    if with_scale:
        b['pcd_scale_factor'] = np.array([[1.1], [0.9]], np.float32)
    b['eval_ann_info'] = [{'a': 1}, {'a': 2}]
    return b


@pytest.mark.parametrize('with_scale', [False, True])
def test_apply_tta_aug_and_stacked_batch_equal_jax(with_scale):
    batch = _host_batch(with_scale)
    metas = jrunner_mod.Runner._tta_metas(types.SimpleNamespace(
        cfg={'tta_cfg': TTA_CFGS['two_scales_both_flips']}))
    for meta in metas:
        want = jrunner_mod.Runner._apply_tta_aug(batch, meta)
        got = Runner._apply_tta_aug(batch, meta)
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k], k)
    want = jrunner_mod.Runner._stack_tta_batches(batch, metas)
    got = Runner._stack_tta_batches(batch, metas)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, k)
        else:
            assert got[k] == v, k
    assert got['points'].shape[0] == 2 * len(metas)


# --------------------------------------------------------------------------
# FPS with a random start
# --------------------------------------------------------------------------
@pytest.mark.parametrize('seed', [0, 1])
def test_fps_from_an_injected_start_matches_jax(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-2, 2, (3, 200, 3)).astype(np.float32)
    mask = rng.rand(3, 200) > 0.3
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jfps._fps_idx(jnp.asarray(pts), jnp.asarray(mask), 17,
                                    key))
    # the start the JAX function draws: its Gumbel argmax over valid points
    g = jax.random.gumbel(key, mask.shape)
    start = np.asarray(jnp.argmax(jnp.where(mask, g, -jnp.inf), axis=1))
    assert (want[:, 0] == start).all() and mask[np.arange(3), start].all()
    got = tfps.fps_idx(torch.from_numpy(pts), torch.from_numpy(mask), 17,
                       torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_random_start_is_uniform_over_the_valid_points():
    mask = torch.zeros(1, 50, dtype=torch.bool)
    mask[0, 10:20] = True
    gen = torch.Generator().manual_seed(0)
    starts = torch.stack([tfps.random_start(mask, gen) for _ in range(400)])
    assert starts.min() >= 10 and starts.max() < 20
    counts = torch.bincount(starts.ravel() - 10, minlength=10)
    assert counts.min() > 15
    pts = torch.rand(1, 50, 3, generator=gen)
    _, idx = tfps.sample_farthest_points(pts, 5, mask, generator=gen)
    assert mask[0, idx[0].long()].all()
    _, det = tfps.sample_farthest_points(pts, 5, mask)
    assert det[0, 0] == 10


def test_preshape_draws_the_fps_start_in_train_mode_only():
    """`fps_generator` moves the dynamic dropout's FPS start in train mode
    (other clusters are dropped, so other points are masked) and is
    ignored in eval mode; the default start stays the first valid
    centre."""
    pre = random_init_(ProxyTransformationNormReverse(
        embed_dim=64, num_heads=4, grid_size=4, dynamic_drop_radio=0.5,
        num_sub=8, input_dim=128, img_spacial_dim=2),
        torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    args = (torch.rand(2, 1024, 3, generator=g) * 3,
            torch.ones(2, 1024, dtype=torch.bool),
            torch.randn(2, 8, 64, generator=g),
            torch.ones(2, 8, dtype=torch.bool),
            torch.randn(2, 2, 2, 2, 128, generator=g))

    def masks(train, fps_seed):
        out = []
        for _ in range(2):
            fps = (None if fps_seed is None
                   else torch.Generator().manual_seed(fps_seed))
            out.append(pre(*args, train=train,
                           generator=torch.Generator().manual_seed(0),
                           fps_generator=fps)[1])
        assert torch.equal(out[0], out[1])
        return out[0]

    with torch.no_grad():
        assert not torch.equal(masks(True, None), masks(True, 5))
        assert torch.equal(masks(False, None), masks(False, 5))


# --------------------------------------------------------------------------
# the baseline grounder
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def baseline():
    """The JAX baseline's predict on the tiny grounder's reference-layout
    weights (tests/test_torch_port_detector.py) without the preshape's,
    and the shapes of its own `init` tree (traced, not compiled)."""
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1)).items()
             if k in PREDICT_KEYS}
    sd = {k: v for k, v in tiny_state_dict().items()
          if not k.startswith('preshape.')}
    variables = convert_detector(tiny_state_dict())
    for tree in variables.values():
        del tree['preshape']
    jmodel = JBaseline(**TINY)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, b: jmodel.apply(v, b, mode='predict'))(
        variables, jb)
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, mode='predict'),
                            jax.random.PRNGKey(0), jb)
    return batch, sd, shapes, {k: np.asarray(v) for k, v in want.items()}


def test_baseline_state_dict_is_the_jax_tree(baseline):
    _, sd, shapes, _ = baseline
    assert 'preshape' not in shapes['params']
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    model = SparseFeatureFusion3DGrounder(**TINY, device='meta')
    assert not hasattr(model, 'preshape')
    assert set(state_dict_from_jax(tree)) == set(model.state_dict()) == \
        set(sd)


def test_baseline_predict_matches_jax(baseline):
    batch, sd, _, want = baseline
    model = SparseFeatureFusion3DGrounder(**TINY, device='cpu')
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    got = model(batch_to_device(batch, 'cpu'))
    np.testing.assert_array_equal(got['query_mask'].numpy(),
                                  want['query_mask'])
    assert want['query_mask'].sum() > 0
    for k in ('bboxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize('config', [SMOKE, FLAGSHIP],
                         ids=['synthetic_smoke', 'flagship'])
def test_baseline_configs_build_without_a_preshape(config):
    cfg = dict(Config.fromfile(config)['model'])
    cfg.pop('preshape')
    cfg['type'] = 'SparseFeatureFusion3DGrounder'
    model = build_model_from_cfg(cfg, device='meta')
    assert type(model) is SparseFeatureFusion3DGrounder
    assert not any(k.startswith('preshape.') for k in model.state_dict())
    with pytest.raises(ValueError, match='model.preshape'):
        build_model_from_cfg(dict(Config.fromfile(config)['model'],
                                  type='SparseFeatureFusion3DGrounder'),
                             device='meta')


def test_baseline_trains_through_the_runner(tmp_path):
    """The smoke config as the baseline (no preshape block) through the
    Runner on the CPU: an epoch of one step, finite losses, a
    checkpoint without preshape weights."""
    cfg = Config.fromfile(SMOKE)
    del cfg['model']['preshape']
    cfg.merge_from_dict(Config.parse_cfg_options([
        "model.type='SparseFeatureFusion3DGrounder'",
        'train_dataloader.dataset.length=2', 'train_cfg.val_interval=9']))
    runner = Runner(cfg, str(tmp_path), device='cpu')
    runner.train()
    assert isinstance(runner.model, SparseFeatureFusion3DGrounder)
    assert [r['iter'] for r in runner.train_log] == [1]
    assert all(np.isfinite(r['total_loss']) for r in runner.train_log)
    saved = load_checkpoint(latest_checkpoint(str(tmp_path)))['model']
    assert saved and not any(k.startswith('preshape.') for k in saved)


# --------------------------------------------------------------------------
# the Runner's TTA, against the JAX Runner's
# --------------------------------------------------------------------------
def test_runner_tta_val_results_equal_jax(tmp_path):
    seen = {}
    mp = pytest.MonkeyPatch()
    init_state = jrunner_mod.Runner._init_state

    def rec_init(self, *a, **kw):
        state = init_state(self, *a, **kw)
        seen['init'] = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jax.device_get({'params': state.params,
                                        'batch_stats': state.batch_stats})))
        return state

    mp.setattr(jrunner_mod.Runner, '_init_state', rec_init)
    try:
        jrunner = jrunner_mod.Runner.from_cfg(JConfig.fromfile(SMOKE),
                                              str(tmp_path / 'jax'))
        want = jrunner.test(tta=True)
    finally:
        mp.undo()
    mp.setattr(trunner_mod, 'flax_init_',
               lambda model, gen: model.load_state_dict(seen['init']))
    merged = []
    merge = trunner_mod.merge_aug_bboxes_3d

    def rec_merge(results, metas, *a):
        merged.append(len(results))
        return merge(results, metas, *a)

    mp.setattr(trunner_mod, 'merge_aug_bboxes_3d', rec_merge)
    try:
        got = Runner(Config.fromfile(SMOKE), str(tmp_path / 'torch'),
                     device='cpu').test(tta=True)
    finally:
        mp.undo()
    assert got == want
    # one merge of the two copies (the default tta_cfg) a val scene
    assert merged == [2] * 4 and 'Overall@0.25' in got
    saved = json.loads((tmp_path / 'torch' / 'val_results.json').read_text())
    assert saved == got


@pytest.mark.parametrize('config', ['configs/detection/synthetic_smoke.py',
                                    'configs/occupancy/synthetic_smoke.py'],
                         ids=['detection', 'occupancy'])
def test_tta_outside_grounding_raises(tmp_path, config):
    with pytest.raises(NotImplementedError, match='grounding'):
        Runner(Config.fromfile(config), str(tmp_path),
               device='cpu').test(tta=True)


def test_test_cli_scores_merged_predictions(tmp_path):
    """tools/train.py then tools/test.py --tta on the checkpoint (CPU)."""
    work = str(tmp_path)
    ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', work,
                     '--cfg-options', 'train_dataloader.dataset.length=2',
                     'train_cfg.val_interval=9'])
    path = latest_checkpoint(work)
    plain = ttest.main([SMOKE, path, '--device', 'cpu', '--work-dir', work])
    tta = ttest.main([SMOKE, path, '--tta', '--device', 'cpu',
                      '--work-dir', work])
    assert set(tta) == set(plain) and 'Overall@0.25' in tta
