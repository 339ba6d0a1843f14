"""The port's occupancy path against the JAX package's, on the CPU.

Sizes are configs/occupancy/synthetic_smoke.py's (16x16x8 voxels, 6
classes, ResNet-50 at base 4, neck 16, 4 views of 96 px, B=2); the
quantization and the voxel centres are also held at
configs/occupancy/embodied-occ.py's range and grid, where the float32
voxel size (0.16) makes the rounding forms differ. Tolerances:

- integers bit for bit: dense scatter (its float grid too: each voxel's
  features are summed in input order on both sides), voxel ids and
  slots, the multiscale supervision, the 2x nearest upsample, the
  annotation extractor, the metric and the synthetic dataset;
- floats: the bilinear painting within 1e-6 · (1 + max|x|); the
  predictors' logits at every scale within 1e-5 · (1 + max|x|), and
  their argmax equal wherever the JAX logits' top two differ by more;
- LOSS_RTOL: every loss within 1e-6 relative (the Runner's first step
  too; the semantic affinity loss is vectorised over classes here, a
  loop over classes in the JAX package: its sums run in another order);
  head-level gradients within 1e-5 · (1 + max|g|);
- GRAD_TOL / GRAD_FLOOR: the first train step's gradients within 1e-3
  of each tensor's max plus 1e-6 of the largest gradient, as in the
  detection tests.

Whole-model parity runs the JAX Runner once a model (init, one train
step, val: three compiles, shared through a module-scoped fixture) with
its initial weights, gradients, trained weights and val logits recorded,
and the port's Runner from the same converted initial weights; val is
held on the JAX Runner's trained weights.
"""
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxytransformation_tpu.data  # noqa: F401  (register datasets)
import proxytransformation_tpu.models  # noqa: F401  (register models)
from proxytransformation_tpu.converter.occupancy import (
    extract_occupancy_annotations as jextract)
from proxytransformation_tpu.data.synthetic import (
    SyntheticOccupancyDataset as JOccDataset)
from proxytransformation_tpu.engine import runner as jrunner_mod
from proxytransformation_tpu.eval.occupancy_metric import (
    OccupancyMetric as JOccupancyMetric)
from proxytransformation_tpu.models import det_losses as jloss
from proxytransformation_tpu.models import occ as jocc
from proxytransformation_tpu.models import point_fusion as jfusion
from proxytransformation_tpu.ops import voxelize as jvox
from proxytransformation_tpu.utils.config import Config as JConfig
from proxytransformation_torch.converter.occupancy import (
    extract_occupancy_annotations)
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.data.synthetic import (
    SyntheticOccupancyDataset)
from proxytransformation_torch.engine import runner as trunner_mod
from proxytransformation_torch.engine.checkpoint import (latest_checkpoint,
                                                         load_checkpoint)
from proxytransformation_torch.engine.runner import (Runner,
                                                     apply_amp,
                                                     build_model_from_cfg)
from proxytransformation_torch.eval.occupancy_metric import OccupancyMetric
from proxytransformation_torch.models import det_losses as tloss
from proxytransformation_torch.models import occ as tocc
from proxytransformation_torch.models.init import flax_init_
from proxytransformation_torch.models.point_fusion import batch_point_sample
from proxytransformation_torch.ops import voxelize as tvox
from proxytransformation_torch.tools import eval as teval
from proxytransformation_torch.tools import test as ttest
from proxytransformation_torch.tools import train as ttrain_cli
from proxytransformation_torch.utils.config import Config

from test_torch_port_init import (MEAN_SIGMAS, STD_SIGMAS, TRUNC_MIN_N,
                                  TRUNC_RATIO)
from test_torch_port_train import _recording

SMOKE = 'configs/occupancy/synthetic_smoke.py'
FULL = 'configs/occupancy/embodied-occ.py'
# (voxel_range, n_voxels) of the two configs
RANGES = {'smoke': ((0.0, 0.0, 0.0, 5.0, 5.0, 2.5), (16, 16, 8)),
          'embodied_occ': ((-3.2, -3.2, -0.78, 3.2, 3.2, 1.78),
                           (40, 40, 16))}
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6
# one train step, then val (the smoke config's val loader: 2 scenes)
ONE_STEP = ['train_dataloader.dataset.length=2']
MODEL_TYPES = ('EmbodiedOccPredictor', 'DenseFusionOccPredictor')


def close(got, want, rel, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    tol = rel * (1 + (np.abs(want).max() if want.size else 0.0))
    assert err <= tol, (what, err, tol)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# voxelization: the rounding of floor((p - lo) / voxel)
# --------------------------------------------------------------------------
def boundary_points(voxel_range, grid, n_random=3000, seed=0):
    """Points on the voxel boundaries of both rounding forms of the voxel
    size, one float32 step to either side of each, and random points a
    little beyond the range; (N, 3) float32 and a mask."""
    r = np.asarray(voxel_range, np.float32)
    lo, hi = r[:3], r[3:]
    dims = np.asarray(grid, np.float32)
    rng = np.random.RandomState(seed)
    out = []
    for vox in ((hi - lo) / dims, (hi - lo) * (np.float32(1) / dims)):
        i = rng.randint(0, int(dims.max()) + 1, (1500, 3)).astype(np.float32)
        on = (lo + i * vox).astype(np.float32)
        # no step off exact zeros: XLA's CPU code flushes the subnormals
        # one step from zero to zero, PyTorch's keeps them
        nz = on != 0
        out += [on, np.where(nz, np.nextafter(on, np.float32(-9)), on),
                np.where(nz, np.nextafter(on, np.float32(9)), on)]
    out.append(rng.uniform(lo - 0.3, hi + 0.3, (n_random, 3)))
    pts = np.concatenate(out).astype(np.float32)
    mask = rng.rand(len(pts)) > 0.05
    return pts, mask


def _jax_scatter(reduce, context, voxel_range, grid):
    """The JAX function, jitted: alone (its range an argument) or called
    from a model's jit with a constant range, vmapped as the DenseFusion
    predictor's splat calls it. Its `reduce` is traced, not static, so
    'max' and 'sum' go through the function it wraps, jitted with
    `reduce` bound."""
    fn = (jvox.dynamic_scatter_3d if reduce == 'mean' else jax.jit(
        partial(jvox.dynamic_scatter_3d.__wrapped__, reduce=reduce),
        static_argnames=('grid_shape', )))
    if context == 'alone':
        return lambda p, f, m: fn(p, f, m, jnp.asarray(voxel_range,
                                                       jnp.float32), grid)
    batched = jax.jit(jax.vmap(
        lambda p, f, m: fn(p, f, m, jnp.asarray(voxel_range), grid)))
    return lambda p, f, m: jax.tree_util.tree_map(
        lambda x: x[0], batched(p[None], f[None], m[None]))


@pytest.mark.parametrize('reduce', ['mean', 'max', 'sum'])
@pytest.mark.parametrize('context', ['alone', 'in_model'])
@pytest.mark.parametrize('config', sorted(RANGES))
def test_dynamic_scatter_matches_jax_bit_for_bit(config, context, reduce):
    voxel_range, grid = RANGES[config]
    pts, mask = boundary_points(voxel_range, grid)
    feats = np.random.RandomState(1).randn(len(pts), 5).astype(np.float32)
    want = [np.asarray(x) for x in _jax_scatter(reduce, context, voxel_range,
                                                grid)(pts, feats, mask)]
    rng_arg = (torch.tensor(voxel_range, dtype=torch.float32)
               if context == 'alone' else voxel_range)
    got = tvox.dynamic_scatter_3d(torch.from_numpy(pts),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(mask), rng_arg, grid,
                                  reduce)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert want[1].sum() > 0.3 * mask.sum() and (want[1] > 1).any()


@pytest.mark.parametrize('context', ['alone', 'in_model'])
def test_the_two_rounding_forms_differ_at_the_full_grid(context):
    """At embodied-occ.py's grid each context's form gives other voxels
    than the other's on the boundary points: the test above could tell
    them apart."""
    voxel_range, grid = RANGES['embodied_occ']
    pts = torch.from_numpy(boundary_points(voxel_range, grid)[0])
    as_tensor = tvox.quantize(pts, torch.tensor(voxel_range), grid)
    as_numbers = tvox.quantize(pts, voxel_range, grid)
    assert (as_tensor != as_numbers).any(-1).sum() > 1000


@pytest.mark.parametrize('max_points', [1, 3])
@pytest.mark.parametrize('context', ['alone', 'in_model'])
def test_hard_voxelize_matches_jax(context, max_points):
    voxel_range, grid = RANGES['embodied_occ']
    pts, mask = boundary_points(voxel_range, grid, n_random=500)
    if context == 'alone':
        want = jvox.hard_voxelize(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(voxel_range, jnp.float32),
                                  grid, max_points)
        rng_arg = torch.tensor(voxel_range, dtype=torch.float32)
    else:
        want = jax.jit(lambda p, m: jvox.hard_voxelize(
            p, m, jnp.asarray(voxel_range), grid, max_points))(pts, mask)
        rng_arg = voxel_range
    got = tvox.hard_voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                             rng_arg, grid, max_points)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) == -1).any() and (np.asarray(want[1])
                                                 == max_points - 1).any()


# --------------------------------------------------------------------------
# the model's pieces
# --------------------------------------------------------------------------
@pytest.mark.parametrize('ratio', [1, 2, 4])
def test_occ_multiscale_supervision_matches_jax(ratio):
    """Duplicate cells (the larger label wins), negative and
    out-of-range coordinates, masked rows, a vis mask."""
    rng = np.random.RandomState(ratio)
    grid = tuple(s // ratio for s in (16, 16, 8))
    gt = np.concatenate([rng.randint(-2, 18, (300, 3)),
                         rng.randint(0, 6, (300, 1))], -1).astype(np.float32)
    gt[:50, :3] = gt[50:100, :3]
    mask = rng.rand(300) > 0.1
    vis = rng.rand(*grid) > 0.2
    for v in (None, vis):
        want = np.asarray(jocc.occ_multiscale_supervision(
            jnp.asarray(gt), jnp.asarray(mask), ratio, grid,
            None if v is None else jnp.asarray(v)))
        got = tocc.occ_multiscale_supervision(
            torch.from_numpy(gt), torch.from_numpy(mask), ratio, grid,
            None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() > 0


@pytest.mark.parametrize('shape', [(10, 10, 4), (20, 20, 8), (5, 3, 7)],
                         ids=['embodied_occ_coarse', 'embodied_occ_mid',
                              'odd'])
def test_upsample2x_matches_jax_image_resize(shape):
    x = np.random.RandomState(0).randn(2, *shape, 3).astype(np.float32)
    X, Y, Z = shape
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (2, 2 * X, 2 * Y, 2 * Z, 3),
                                       'nearest'))
    got = tocc.upsample2x(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), want)


@pytest.mark.parametrize('config', sorted(RANGES))
def test_voxel_centers_match_jax(config):
    """Bit for bit at the smoke grid; at embodied-occ.py's within one
    float32 step of the product (i + 0.5) · voxel: XLA's CPU code
    contracts lo + (i + 0.5) · voxel into a fused multiply-add on some
    lanes (the x and y axes), not on others."""
    voxel_range, grid = RANGES[config]
    jm = jocc.EmbodiedOccPredictor(n_voxels=grid, voxel_range=voxel_range)
    want = np.asarray(jax.jit(lambda: jm.apply(
        {}, method=lambda m: m._voxel_centers()))())
    got = tocc.voxel_centers(grid, voxel_range).numpy()
    if config == 'smoke':
        np.testing.assert_array_equal(got, want)
    else:
        r = np.asarray(voxel_range, np.float32)
        step = np.spacing(np.float32(np.abs(r[3:] - r[:3]).max()))
        assert np.abs(got - want).max() <= step
        assert (got == want).mean() > 0.5


def _painting_case():
    rng = np.random.RandomState(3)
    B, V, Hf, Wf, C, N, H, W = 2, 3, 24, 24, 8, 400, 96, 96
    feats = rng.randn(B, V, Hf, Wf, C).astype(np.float32)
    pts = rng.uniform([-2, -2, -0.5], [2, 2, 3], (B, N, 3)).astype(np.float32)
    # points that land on feature-grid nodes and at the map's far edges
    pts[:, :40, 2] = 1.0
    pts[:, :40, :2] = (rng.randint(0, 24, (B, 40, 2)) / 23 * W - W / 2) / 80
    proj = np.tile(np.array([[80, 0, W / 2, 0], [0, 80, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    proj[:, 1, 0, 3] = 7.0
    views = np.array([[True, True, False], [True, True, True]])
    return feats, pts, proj, (H, W), views


@pytest.mark.parametrize('aligned', [True, False],
                         ids=['bilinear', 'nearest'])
def test_batch_point_sample_matches_jax(aligned):
    feats, pts, proj, pad, views = _painting_case()
    fn = jax.jit(jax.vmap(lambda f, p, m, v: jfusion.batch_point_sample(
        f, p, m, pad, views_mask=v, aligned=aligned)))
    want = np.asarray(fn(feats, pts, proj, views))
    got = batch_point_sample(torch.from_numpy(feats), torch.from_numpy(pts),
                             torch.from_numpy(proj), pad,
                             views_mask=torch.from_numpy(views),
                             aligned=aligned).numpy()
    if aligned:
        close(got, want, 1e-6, 'bilinear')
    else:
        np.testing.assert_array_equal(got, want)
    assert (want != 0).any(-1).mean() > 0.3


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _logits_and_gt(seed, shape=(8, 8, 4), C=6, all_occupied=False):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(*shape, C)).astype(np.float32)
    gt = rng.randint(1 if all_occupied else 0, C, shape)
    gt[0, 0, :] = 0 if not all_occupied else 1
    mask = rng.rand(*shape) > 0.1
    return logits, gt.astype(np.int32), mask


@pytest.mark.parametrize('case', ['random', 'all_occupied', 'no_mask'])
def test_scene_class_affinity_losses_match_jax(case):
    """sem_scal_loss (vectorised over classes) and geo_scal_loss, values
    and gradients; with every voxel occupied the geometric precision is 1
    exactly, where jnp.clip's gradient splits at the bound."""
    logits, gt, mask = _logits_and_gt(5, all_occupied=case == 'all_occupied')
    m = None if case == 'no_mask' else mask

    def jtotal(x):
        jm = None if m is None else jnp.asarray(m)
        return (jloss.sem_scal_loss(x, jnp.asarray(gt), jm),
                jloss.geo_scal_loss(x, jnp.asarray(gt), 0, jm))

    want = jax.jit(jtotal)(logits)
    want_g = jax.jit(jax.grad(lambda x: sum(jtotal(x))))(logits)
    x = torch.tensor(logits, requires_grad=True)
    tm = None if m is None else torch.from_numpy(m)
    got = (tloss.sem_scal_loss(x, torch.from_numpy(gt).long(), tm),
           tloss.geo_scal_loss(x, torch.from_numpy(gt).long(), 0, tm))
    sum(got).backward()
    for g, w, name in zip(got, want, ('sem', 'geo')):
        assert abs(g.item() - float(w)) <= LOSS_RTOL * abs(float(w)), name
    close(x.grad.numpy(), np.asarray(want_g), 1e-5, 'grad')


@pytest.mark.parametrize('masked', [False, True])
def test_gaussian_kernel_loss_matches_jax(masked):
    rng = np.random.RandomState(6)
    off = rng.randn(7, 30, 3).astype(np.float32)
    mask = rng.rand(7, 30) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, want_g = jax.value_and_grad(
        lambda o: jloss.gaussian_kernel_loss(o, 0.7, jm))(jnp.asarray(off))
    x = torch.tensor(off, requires_grad=True)
    got = tloss.gaussian_kernel_loss(
        x, 0.7, None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    close(x.grad.numpy(), np.asarray(want_g), 1e-6, 'grad')


@pytest.mark.parametrize('use_semantic', [True, False],
                         ids=['ce_sem_geo', 'bce'])
def test_occ_head_loss_matches_jax(use_semantic):
    """The head's loss at three scales (CE + semantic + geometric, or the
    BCE branch) on the same logits and sparse gt: values and gradients."""
    rng = np.random.RandomState(7)
    C = 6 if use_semantic else 1
    preds = [(2 * rng.randn(2, 16 // s, 16 // s, 8 // s, C))
             .astype(np.float32) for s in (1, 2, 4)]
    preds[0][0, 0, 0, 0, 0] = 0.0          # a logit at |x|'s kink
    gt = np.concatenate([rng.randint(0, 16, (2, 64, 2)),
                         rng.randint(0, 8, (2, 64, 1)),
                         rng.randint(1, 6, (2, 64, 1))], -1).astype(np.float32)
    gmask = np.arange(64)[None] < np.array([[64], [50]])
    jhead = jocc.ImVoxelOccHead(num_classes=6, use_semantic=use_semantic)
    jfn = jax.jit(lambda ps: jhead.loss(ps, jnp.asarray(gt),
                                        jnp.asarray(gmask)))
    want = jfn(preds)
    want_g = jax.jit(jax.grad(lambda ps: sum(jfn(ps).values())))(preds)
    head = tocc.ImVoxelOccHead(4, 6, use_semantic)
    xs = [torch.tensor(p, requires_grad=True) for p in preds]
    got = head.loss(xs, torch.from_numpy(gt), torch.from_numpy(gmask))
    assert sorted(got) == sorted(want) == ['loss_occ_0', 'loss_occ_1',
                                           'loss_occ_2']
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= \
            LOSS_RTOL * abs(float(want[k])), k
    sum(got.values()).backward()
    for x, w in zip(xs, want_g):
        close(x.grad.numpy(), np.asarray(w), 1e-5, 'grad')
    pred = head.predict([torch.from_numpy(p) for p in preds]).numpy()
    want_pred = np.asarray(jhead.predict([jnp.asarray(p) for p in preds]))
    if use_semantic:
        np.testing.assert_array_equal(pred, want_pred)
    else:       # probabilities: the two sigmoids round apart
        close(pred, want_pred, 1e-6, 'sigmoid')


# --------------------------------------------------------------------------
# metric, data, annotations
# --------------------------------------------------------------------------
def test_occupancy_metric_equals_jax():
    rng = np.random.RandomState(8)
    samples = []
    for _ in range(3):
        gt = rng.randint(0, 7, (16, 16, 8))
        gt[rng.rand(16, 16, 8) < 0.1] = 255
        pred = np.where(rng.rand(16, 16, 8) < 0.6, gt % 255,
                        rng.randint(0, 6, (16, 16, 8)))
        samples.append({'pred_occupancy': pred, 'gt_occupancy_dense': gt})
    results = []
    for metric in (OccupancyMetric(num_classes=6),
                   JOccupancyMetric(num_classes=6)):
        for s in samples:
            metric.process(None, [s])
        results.append(metric.evaluate())
    assert results[0] == results[1]
    assert 0 < results[0]['mIoU'] < 1 and 'iou_cls_5' in results[0]
    assert OccupancyMetric(num_classes=6).evaluate() == {'mIoU': 0.0,
                                                         'IoU_geo': 0.0}


def test_synthetic_occupancy_dataset_equals_jax():
    kw = dict(length=3, n_points=512, n_views=2, img_size=32, seed=4,
              n_voxels=(40, 40, 16), num_classes=81, n_occupied=100)
    for idx in range(3):
        got = SyntheticOccupancyDataset(**kw)[idx]
        want = JOccDataset(**kw)[idx]
        assert set(got) == set(want)
        for k in ('points', 'imgs', 'gt_occupancy', 'gt_bboxes_3d'):
            np.testing.assert_array_equal(got[k], want[k], k)
        np.testing.assert_array_equal(got['eval_ann_info']['gt_occupancy'],
                                      want['eval_ann_info']['gt_occupancy'])
        assert got['text'] == want['text']


@pytest.mark.parametrize('min_points', [1, 3])
def test_extract_occupancy_annotations_equals_jax(min_points):
    voxel_range, grid = RANGES['embodied_occ']
    pts, _ = boundary_points(voxel_range, grid, n_random=4000, seed=9)
    labels = np.random.RandomState(9).randint(1, 5, len(pts))
    got = extract_occupancy_annotations(pts, labels, voxel_range, grid,
                                        min_points)
    want = jextract(pts, labels, voxel_range, grid, min_points)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(got) > 100


# --------------------------------------------------------------------------
# the model builder
# --------------------------------------------------------------------------
@pytest.mark.parametrize('config,mtype', [
    (SMOKE, 'EmbodiedOccPredictor'), (SMOKE, 'DenseFusionOccPredictor'),
    (FULL, 'EmbodiedOccPredictor'), (FULL, 'DenseFusionOccPredictor')])
def test_occupancy_configs_build_their_model(config, mtype):
    cfg = dict(Config.fromfile(config)['model'], type=mtype)
    model = build_model_from_cfg(cfg, device='meta')
    assert type(model).__name__ == mtype
    assert model.n_voxels == tuple(cfg['n_voxels'])
    assert model.bbox_head.occ_0.weight.shape[0] == cfg['num_classes']
    assert model.neck_3d.out_0.conv.weight.shape[0] == \
        cfg['neck_3d']['out_channels']
    assert hasattr(model, 'point_proj') == (mtype == 'DenseFusionOccPredictor')


@pytest.mark.parametrize('change,error,match', [
    ({'neck_3d': {'type': 'OtherNeck'}}, NotImplementedError, 'neck_3d.type'),
    ({'bbox_head': {'loss_occ': {'type': 'FocalLoss'}}}, ValueError,
     'bbox_head.loss_occ'),
    ({'bbox_head': {'num_classes': 7}}, ValueError, 'num_classes'),
    ({'backbone': {'frozen_stages': 2}}, ValueError, 'backbone.frozen_stages'),
    ({'use_xyz_feat': True}, ValueError, 'use_xyz_feat'),
    ({'compute_dtype': 'bfloat16'}, NotImplementedError, 'float32 only'),
])
def test_occupancy_builder_raises_on_what_it_cannot_honour(change, error,
                                                           match):
    cfg = Config.fromfile(SMOKE)['model']
    for k, v in change.items():
        cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
    with pytest.raises(error, match=match):
        build_model_from_cfg(cfg, device='meta')


def test_amp_on_an_occupancy_config_raises(tmp_path):
    cfg = Config.fromfile(SMOKE)
    apply_amp(cfg)
    with pytest.raises(NotImplementedError, match='no bfloat16 mode'):
        Runner(cfg, str(tmp_path), device='cpu')


# --------------------------------------------------------------------------
# the JAX Runner and the port's, from the same weights
# --------------------------------------------------------------------------
def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _sd(params, stats):
    return state_dict_from_jax({'params': params, 'batch_stats': stats})


def _jax_runner(mtype, work):
    """The JAX Runner on the smoke config (one step, val): its initial
    and trained weights, the first step's metrics and gradients, the val
    logits at every scale and val_results.json."""
    seen = {'logged': []}
    mp = pytest.MonkeyPatch()
    init_state = jrunner_mod.Runner._init_state

    def rec_init(self, *a, **kw):
        state = init_state(self, *a, **kw)
        seen.setdefault('init', _sd(_tree(state.params),
                                    _tree(state.batch_stats)))
        return state

    build_optimizer = jrunner_mod.build_optimizer
    predict = jocc.ImVoxelOccHead.predict

    def rec_predict(self, occ_preds):
        for i, p in enumerate(occ_preds):
            jax.debug.callback(lambda x, i=i: seen.setdefault(
                f'logits_{i}', np.asarray(x)), p)
        return predict(self, occ_preds)

    mp.setattr(jrunner_mod.Runner, '_init_state', rec_init)
    mp.setattr(jrunner_mod.Runner, '_log_scalars',
               lambda self, s, step=None: seen['logged'].append(dict(s)))
    mp.setattr(jrunner_mod, 'build_optimizer',
               lambda *a, **kw: _recording(build_optimizer(*a, **kw)))
    mp.setattr(jocc.ImVoxelOccHead, 'predict', rec_predict)
    try:
        cfg = JConfig.fromfile(SMOKE)
        cfg.merge_from_dict(JConfig.parse_cfg_options(
            ONE_STEP + [f'model.type={mtype!r}']))
        runner = jrunner_mod.Runner.from_cfg(cfg, str(work))
        state = _tree(runner.train())
        jax.effects_barrier()
    finally:
        mp.undo()
    seen['grads'] = _sd(state.opt_state[1], state.batch_stats)
    seen['trained'] = _sd(state.params, state.batch_stats)
    seen['val_results'] = json.loads((work / 'val_results.json').read_text())
    seen['metrics'] = next(s for s in seen['logged'] if 'total_loss' in s)
    return seen


@pytest.fixture(scope='module', params=MODEL_TYPES)
def runners(request, tmp_path_factory):
    """(model type, the JAX Runner's record, the port's Runner after one
    step from the same initial weights, its val logits on the JAX
    Runner's trained weights, its val_results)."""
    mtype = request.param
    want = _jax_runner(mtype, tmp_path_factory.mktemp('jax_' + mtype))
    work = tmp_path_factory.mktemp('torch_' + mtype)
    mp = pytest.MonkeyPatch()
    mp.setattr(trunner_mod, 'flax_init_',
               lambda model, gen: model.load_state_dict(want['init']))
    logits = {}
    predict = tocc.ImVoxelOccHead.predict

    def rec_predict(self, occ_preds):
        for i, p in enumerate(occ_preds):
            logits.setdefault(f'logits_{i}', p.numpy())
        return predict(self, occ_preds)

    mp.setattr(tocc.ImVoxelOccHead, 'predict', rec_predict)
    try:
        cfg = Config.fromfile(SMOKE)
        cfg.merge_from_dict(Config.parse_cfg_options(
            ONE_STEP + [f'model.type={mtype!r}', 'train_cfg.val_interval=9']))
        runner = Runner(cfg, str(work), device='cpu')
        runner.train()
        # a parameter no output reads has no gradient here (zero in JAX)
        grads = {n: np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.numpy().copy()
                 for n, p in runner.model.named_parameters()}
        after = {k: v.clone() for k, v in runner.model.state_dict().items()}
        runner.model.load_state_dict(want['trained'])
        results = runner.val(init_state=False)
    finally:
        mp.undo()
    return mtype, want, runner, grads, after, logits, results


def test_runner_first_step_losses_match_jax(runners):
    mtype, want, runner, *_ = runners
    assert isinstance(runner.model, getattr(tocc, mtype))
    got = runner.train_log[0]
    for k in ('loss_occ_0', 'loss_occ_1', 'loss_occ_2', 'total_loss'):
        w = want['metrics'][k]
        assert abs(got[k] - w) <= LOSS_RTOL * abs(w), (k, got[k], w)
    w = want['metrics']['grad_norm']
    assert abs(got['grad_norm'] - w) <= GRAD_TOL * w


def test_runner_gradients_and_running_stats_match_jax(runners):
    _, want, runner, grads, after, *_ = runners
    assert set(grads) | {k for k in after if 'running' in k} == set(
        want['grads'])
    want_grads = {n: want['grads'][n].numpy() for n in grads}
    top = max(np.abs(g).max() for g in want_grads.values())
    for n, g in grads.items():
        w = want_grads[n]
        tol = GRAD_TOL * np.abs(w).max() + GRAD_FLOOR * top
        assert np.abs(g - w).max() <= tol, n
    # the ResNet's stages after the first are read by no output
    assert not np.abs(want_grads['backbone.layer4.0.conv1.weight']).any()
    assert runner.model.backbone.layer4[0].conv1.weight.grad is None
    for n, v in after.items():
        if 'running' in n:
            close(v.numpy(), want['trained'][n].numpy(), 1e-5, n)


def test_runner_val_logits_at_every_scale_match_jax(runners):
    _, want, _, _, _, got, _ = runners
    for i in range(3):
        w, g = want[f'logits_{i}'], got[f'logits_{i}']
        close(g, w, 1e-5, f'scale {i}')
    w, g = want['logits_0'], got['logits_0']
    top2 = np.sort(w, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5 * (1 + np.abs(w).max())
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])


def test_runner_val_results_equal_jax(runners):
    *_, results = runners
    want = runners[1]['val_results']
    assert results == want
    assert 'mIoU' in results and 'IoU_geo' in results


def test_occupancy_state_dict_and_fresh_weight_laws(runners):
    """The converted JAX tree covers the port's state_dict; the port's
    fresh weights (`flax_init_`, what the Runner draws) follow the JAX
    initialisers' laws: constants equal, drawn leaves by their moments
    (the rules of tests/test_torch_port_init.py)."""
    mtype, want, runner, *_ = runners
    init = {k: v.numpy() for k, v in want['init'].items()}
    model = build_model_from_cfg(
        dict(Config.fromfile(SMOKE)['model'], type=mtype), 'cpu')
    assert set(init) == set(model.state_dict())
    got = {k: v.numpy() for k, v in flax_init_(
        model, torch.Generator().manual_seed(0)).state_dict().items()}
    drawn = 0
    for k, w in init.items():
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(got[k], w, k)
            continue
        drawn += 1
        w, g = w.astype(np.float64).ravel(), got[k].astype(np.float64).ravel()
        sw, sg = w.std(), g.std()
        assert abs(sg / sw - 1) <= STD_SIGMAS / np.sqrt(w.size), k
        for x, s in ((w, sw), (g, sg)):
            assert abs(x.mean()) <= MEAN_SIGMAS * s / np.sqrt(x.size), k
        if w.size >= TRUNC_MIN_N:
            assert np.abs(g).max() / sg <= TRUNC_RATIO, k
    assert drawn > 60


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------
def test_occupancy_clis_train_test_and_eval(tmp_path):
    """configs/occupancy/synthetic_smoke.py as it is through tools/train.py
    on the CPU (an epoch of two steps, a checkpoint, val with
    OccupancyMetric), then tools/test.py and tools/eval.py on the
    checkpoint, which score the same weights alike."""
    work = str(tmp_path)
    runner = ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', work])
    assert [r['iter'] for r in runner.train_log] == [1, 2]
    assert all(np.isfinite(r['total_loss']) for r in runner.train_log)
    trained = json.loads((tmp_path / 'val_results.json').read_text())
    assert 'mIoU' in trained and 0.0 <= trained['mIoU'] <= 1.0
    path = latest_checkpoint(work)
    assert load_checkpoint(path)['step'] == 2
    tested = ttest.main([SMOKE, path, '--device', 'cpu', '--work-dir',
                         work])
    assert tested == trained
    evaluated = teval.main([SMOKE, '--resume', path, '--device', 'cpu',
                            '--work-dir', work])
    assert evaluated == trained
    with pytest.raises(NotImplementedError, match='grounding'):
        ttest.main([SMOKE, path, '--tta', '--device', 'cpu', '--work-dir',
                    work])
