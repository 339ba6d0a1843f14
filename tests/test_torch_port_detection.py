"""The port's detection pretraining path against the JAX package's, on the
CPU.

The tiny detector of tests/test_detection_occ.py (5 classes, MinkResNet
depth 14, ResNet-50 at base 4, head width 32, prune 64, 1024 points) with
the JAX package's own initial weights (`model.init`, carried over by
`state_dict_from_jax`). The JAX side compiles three whole-model programs,
shared through module-scoped fixtures: init, predict and the train step.
Tolerances:

- FLOAT_TOL: float outputs within 1e-5 · (1 + max|x|) of the JAX ones
  (face distances, centerness, box coding, predicted boxes and scores,
  IoUs);
- LOSS_RTOL: the three losses and their sum within 1e-5 relative;
- GRAD_TOL / GRAD_FLOOR: each gradient within 1e-3 of its tensor's max
  plus 1e-6 of the largest gradient. Measured: 5.1e-4 on MinkResNet's
  stage-4 conv and 2.7e-3 on `out_block_3`'s kernel, whose gradient is
  9.4e-7 (rounding level: the coarsest level's train-mode BatchNorm over
  a few voxels); moving the port's weights by 1e-7 relative moves its
  own gradients by up to 6.9e-4 and 4.6e-3 of those maxima, so the step
  is conditioned no better than that at this size. The gradient norm is
  held within GRAD_TOL relative;
- integers bit for bit: voxel keys, the head's compacted indices, masks,
  `cls_targets`, NMS keeps, labels and valid masks.

The rotated IoU loss's gradient is held against `jax.grad` on random,
axis-aligned and identical boxes. At identical boxes IoU has a kink (its
maximum, 1, with every direction lowering it), and the gradient autodiff
returns depends on the order in which rounding places coincident
vertices: the JAX package's own eager and jitted gradients differ there.
For that case the test holds the loss and the finiteness of the
gradient on both sides.
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from proxytransformation_tpu.engine import train as jtrain
from proxytransformation_tpu.eval.indoor_eval import (
    IndoorDetMetric as JaxIndoorDetMetric)
from proxytransformation_tpu.models import det_losses as jloss
from proxytransformation_tpu.models import embodied_det3d as jdet_mod
from proxytransformation_tpu.models import fcaf3d_head as jhead_mod
from proxytransformation_tpu.models.embodied_det3d import (
    Embodied3DDetector as JDetector)
from proxytransformation_tpu.ops import box3d_overlap as jbox
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine import train as ttrain
from proxytransformation_torch.engine.checkpoint import (latest_checkpoint,
                                                         load_checkpoint)
from proxytransformation_torch.eval.indoor_eval import IndoorDetMetric
from proxytransformation_torch.models import det_losses as tloss
from proxytransformation_torch.models import embodied_det3d as tdet_mod
from proxytransformation_torch.models import fcaf3d_head as thead_mod
from proxytransformation_torch.models.detector import batch_to_device
from proxytransformation_torch.models.embodied_det3d import (
    Embodied3DDetector as TDetector)
from proxytransformation_torch.ops import box3d_overlap as tbox
from proxytransformation_torch.ops import nms3d as tnms
from proxytransformation_torch.tools import train as ttrain_cli

from test_torch_port_train import _capture, _recording

# the module: the package's `ops/__init__.py` exports the function nms3d
jnms = importlib.import_module('proxytransformation_tpu.ops.nms3d')

TINY_DET = dict(voxel_size=0.05, n_points=1024, num_classes=5,
                img_base_channels=4, backbone3d_depth=14,
                sparse_capacities=(1024, 800, 512, 256, 128, 64),
                voxel_extent=(128, 128, 128), head_out_channels=32,
                pts_prune_threshold=64)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-6
SMOKE = 'configs/detection/synthetic_smoke.py'


def float_close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    tol = 1e-5 * (1 + (np.abs(want).max() if want.size else 0.0))
    assert err <= tol, (what, err, tol)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def det_batch(seed=0, B=2, V=2, H=64, W=64, N=1024, G=4, C=5):
    """A seeded detection batch: masked points and gts, an augmentation
    to undo in the painting."""
    rng = np.random.RandomState(seed)
    proj = np.tile(np.array([[50, 0, W / 2, 0], [0, 50, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    gt = np.concatenate([
        rng.uniform(0.5, 2.5, (B, G, 3)), rng.uniform(0.3, 1.0, (B, G, 3)),
        rng.uniform(-0.5, 0.5, (B, G, 3))], -1).astype(np.float32)
    a = rng.uniform(-0.1, 0.1, B)
    rot = np.zeros((B, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(a)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(a), np.sin(a)
    rot[:, 2, 2] = 1
    return {
        'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
        'points': rng.uniform(0, 3.0, (B, N, 3)).astype(np.float32),
        'points_mask': np.arange(N)[None] < np.array([[N], [N - 100]]),
        'proj_mats': proj, 'views_mask': np.ones((B, V), bool),
        'pcd_rotation': rot,
        'pcd_scale_factor': rng.uniform(0.9, 1.1, (B, 1)).astype(np.float32),
        'pcd_trans': rng.uniform(-0.1, 0.1, (B, 3)).astype(np.float32),
        'gt_bboxes': gt,
        'gt_labels': rng.randint(0, C, (B, G)).astype(np.int32),
        'gt_masks': np.arange(G)[None] < np.array([[G], [G - 1]]),
    }


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# fixtures: the JAX detector's weights, predict and one train step
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def batch():
    return det_batch()


@pytest.fixture(scope='module')
def variables(batch):
    model = JDetector(**TINY_DET)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return _numpy_tree(jax.jit(
        lambda k, b: model.init(k, b, mode='loss', train=False))(
            jax.random.PRNGKey(0), jb))


def port_model(variables):
    model = TDetector(**TINY_DET, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables))
    return model


@pytest.fixture(scope='module')
def jax_predict(variables, batch):
    """The JAX predict outputs and the integer stages it recorded: the
    level-0 voxel keys and the head's compacted indices (compact_topk's
    source rows)."""
    seen = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jdet_mod, 'voxelize_points',
               _capture(seen, 'keys')(jdet_mod.voxelize_points))
    compact = jhead_mod.compact_topk

    def rec_compact(*a, **kw):
        out = compact(*a, **kw)
        jax.debug.callback(
            lambda x: seen.setdefault('src', []).append(np.asarray(x)),
            out[2])
        return out

    mp.setattr(jhead_mod, 'compact_topk', rec_compact)
    try:
        model = JDetector(**TINY_DET)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        out = jax.jit(lambda v, b: model.apply(v, b, mode='predict'))(
            variables, jb)
        out = _numpy_tree(out)
        jax.effects_barrier()
    finally:
        mp.undo()
    return out, seen


@pytest.fixture(scope='module')
def jax_step(variables, batch):
    """One JAX train step (engine/train.py, jitted): metrics, gradients
    and running statistics under the port's names."""
    model = JDetector(**TINY_DET)
    tx = _recording(jtrain.build_optimizer(variables['params']))
    state = jtrain.create_train_state(model, variables, tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state, metrics = jax.jit(jtrain.make_train_step(model, tx))(
        state, jb, jax.random.PRNGKey(0))
    stats = _numpy_tree(state.batch_stats)
    grads = state_dict_from_jax({'params': _numpy_tree(state.opt_state[1]),
                                 'batch_stats': stats})
    after = state_dict_from_jax({'params': _numpy_tree(state.params),
                                 'batch_stats': stats})
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in grads.items()},
            {k: v.numpy() for k, v in after.items()})


# --------------------------------------------------------------------------
# the head's pieces
# --------------------------------------------------------------------------
def test_face_distances_and_centerness_match_jax():
    rng = np.random.RandomState(1)
    P, G = 50, 6
    boxes = np.concatenate([rng.uniform(-1, 1, (G, 3)),
                            rng.uniform(0.3, 2, (G, 3)),
                            rng.uniform(-np.pi, np.pi, (G, 3))], -1)
    boxes = np.broadcast_to(boxes[None], (P, G, 9)).astype(np.float32)
    pts = np.broadcast_to(rng.uniform(-1.5, 1.5, (P, 1, 3)),
                          (P, G, 3)).astype(np.float32)
    want = np.asarray(jhead_mod.get_face_distances(jnp.asarray(pts),
                                                   jnp.asarray(boxes)))
    got = thead_mod.get_face_distances(torch.from_numpy(pts),
                                       torch.from_numpy(boxes)).numpy()
    float_close(got, want, 'face distances')
    float_close(thead_mod.get_centerness(torch.tensor(want)).numpy(),
                np.asarray(jhead_mod.get_centerness(jnp.asarray(want))),
                'centerness')


@pytest.mark.parametrize('rot_param', ['euler', 'ortho6d'])
def test_bbox_pred_to_bbox_matches_jax(rot_param):
    rng = np.random.RandomState(2)
    R = 12 if rot_param == 'ortho6d' else 9
    pts = rng.uniform(-2, 2, (2, 40, 3)).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.01, 2, (2, 40, 6)),
                           rng.uniform(-2, 2, (2, 40, R - 6))], -1)
    pred = pred.astype(np.float32)
    jhead = jhead_mod.FCAF3DHead(num_classes=5, rot_param=rot_param,
                                 num_reg_outs=R)
    want = np.asarray(jhead.bbox_pred_to_bbox(jnp.asarray(pts),
                                              jnp.asarray(pred)))
    head = thead_mod.FCAF3DHead(num_classes=5, rot_param=rot_param)
    got = head.bbox_pred_to_bbox(torch.from_numpy(pts),
                                 torch.from_numpy(pred)).numpy()
    float_close(got, want, rot_param)


def test_get_targets_with_background_and_ties():
    """Points on a grid over two boxes of equal volume that overlap (a
    tie in the smallest-volume choice: the lower gt wins), a box whose
    points tie in centerness (symmetric about its center), a masked gt,
    masked points and background points; levels chosen so that both the
    'all upper' rule and a lower level apply."""
    g = np.linspace(-1.05, 1.05, 15, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g[:6], indexing='ij'), -1).reshape(-1, 3)
    P = len(pts)
    level_ids = (np.arange(P) % 4).astype(np.int32)
    pts_mask = np.arange(P) % 17 != 0
    gt = np.array([[0.0, 0.0, -0.5, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                   [0.3, 0.0, -0.5, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
                   [-0.7, 0.6, -0.6, 0.6, 0.6, 0.6, 0.3, 0.0, 0.0],
                   [0.5, -0.6, -0.7, 2.0, 0.4, 0.4, 0.0, 0.1, 0.0],
                   [0.0, 0.0, 0.0, 5.0, 5.0, 5.0, 0.0, 0.0, 0.0]],
                  np.float32)
    labels = np.array([3, 1, 4, 0, 2], np.int32)
    gmask = np.array([True, True, True, True, False])
    for center_thr in (18, 2):
        jhead = jhead_mod.FCAF3DHead(num_classes=5,
                                     pts_center_threshold=center_thr)
        want = [np.asarray(x) for x in jhead.get_targets(
            jnp.asarray(pts), jnp.asarray(level_ids), jnp.asarray(pts_mask),
            jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(gmask))]
        head = thead_mod.FCAF3DHead(num_classes=5,
                                    pts_center_threshold=center_thr)
        got = [x.numpy() for x in head.get_targets(
            torch.from_numpy(pts), torch.from_numpy(level_ids).long(),
            torch.from_numpy(pts_mask), torch.from_numpy(gt),
            torch.from_numpy(labels), torch.from_numpy(gmask))]
        np.testing.assert_array_equal(got[2], want[2])
        assert (want[2] == -1).any() and len(set(want[2][want[2] >= 0])) > 2
        float_close(got[0], want[0], 'center targets')
        float_close(got[1], want[1], 'bbox targets')


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _boxes(rng, n, rot=True):
    return np.concatenate([
        rng.uniform(-1, 1, (n, 3)), rng.uniform(0.5, 1.5, (n, 3)),
        rng.uniform(-1, 1, (n, 3)) if rot else np.zeros((n, 3))],
        -1).astype(np.float32)


def _loss_cases():
    rng = np.random.RandomState(3)
    a = _boxes(rng, 16)
    aligned = _boxes(rng, 8, rot=False)
    shifted = aligned.copy()
    shifted[:, :3] += rng.uniform(-0.3, 0.3, (8, 3)).astype(np.float32)
    ident = _boxes(rng, 8)
    return {
        'random': (a, a + rng.normal(0, 0.2, a.shape).astype(np.float32)),
        'axis_aligned': (aligned, shifted),
        'identical': (ident, ident.copy()),
        'identical_axis_aligned': (aligned, aligned.copy()),
    }


@jax.jit
def _jax_rotated_iou_grad(pred, target, w):
    return jax.value_and_grad(lambda p: jloss.rotated_iou_3d_loss(
        p, target, weight=w, avg_factor=3.0))(pred)


@pytest.mark.parametrize('case', sorted(_loss_cases()))
def test_rotated_iou_loss_value_and_grad_match_jax(case):
    pred, target = _loss_cases()[case]
    w = np.random.RandomState(4).uniform(0, 1, len(pred)).astype(np.float32)

    want, want_g = _jax_rotated_iou_grad(jnp.asarray(pred),
                                         jnp.asarray(target), jnp.asarray(w))
    p = torch.tensor(pred, requires_grad=True)
    got = tloss.rotated_iou_3d_loss(p, torch.from_numpy(target),
                                    weight=torch.from_numpy(w),
                                    avg_factor=3.0)
    got.backward()
    float_close(got.detach().numpy(), np.asarray(want), case)
    assert np.isfinite(p.grad.numpy()).all()
    assert np.isfinite(np.asarray(want_g)).all()
    if not case.startswith('identical'):
        float_close(p.grad.numpy(), np.asarray(want_g), case + ' grad')


def test_axis_aligned_iou_and_bce_match_jax():
    rng = np.random.RandomState(5)
    lo = rng.uniform(-1, 1, (12, 3))
    a = np.concatenate([lo, lo + rng.uniform(0.2, 1, (12, 3))], -1)
    b = a + rng.normal(0, 0.2, a.shape)
    a, b = a.astype(np.float32), b.astype(np.float32)
    w = rng.uniform(0, 1, 12).astype(np.float32)
    logits = np.concatenate([rng.normal(0, 2, 11), [0.0]]).astype(np.float32)
    t = rng.uniform(0, 1, 12).astype(np.float32)
    for jfn, tfn, x, y in ((jloss.axis_aligned_iou_loss,
                            tloss.axis_aligned_iou_loss, a, b),
                           (jloss.binary_cross_entropy_with_logits,
                            tloss.binary_cross_entropy_with_logits,
                            logits, t)):
        want, want_g = jax.value_and_grad(lambda p: jfn(
            p, jnp.asarray(y), jnp.asarray(w), avg_factor=2.5))(
                jnp.asarray(x))
        p = torch.tensor(x, requires_grad=True)
        got = tfn(p, torch.from_numpy(y), torch.from_numpy(w),
                  avg_factor=2.5)
        got.backward()
        float_close(got.detach().numpy(), np.asarray(want), tfn.__name__)
        float_close(p.grad.numpy(), np.asarray(want_g), tfn.__name__)


# --------------------------------------------------------------------------
# IoU and NMS
# --------------------------------------------------------------------------
def test_box3d_iou_and_intersection_chunks_match_jax(monkeypatch):
    rng = np.random.RandomState(6)
    a, b = _boxes(rng, 30), _boxes(rng, 20)
    want = np.asarray(jbox.box3d_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tbox.box3d_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    float_close(got, want, 'box3d_iou')
    whole = tbox.box3d_intersection_volume(torch.from_numpy(a),
                                           torch.from_numpy(b))
    float_close(whole.numpy(), np.asarray(jbox.box3d_intersection_volume(
        jnp.asarray(a), jnp.asarray(b))), 'intersection')
    # chunks of 7 pairs (rows of 1) and of 64 pairs change no value
    for chunk in (7, 64):
        monkeypatch.setattr(tbox, 'PAIR_CHUNK', chunk)
        assert torch.equal(tbox.box3d_intersection_volume(
            torch.from_numpy(a), torch.from_numpy(b)), whole)
        assert torch.equal(
            tbox.pairs_intersection_volume(torch.from_numpy(a),
                                           torch.from_numpy(b[:1]).expand(
                                               30, 9)),
            whole[:, 0])


def _shared_iou(rng, n):
    """A symmetric IoU matrix with entries exactly at 0.5, the threshold."""
    m = rng.uniform(0, 1, (n, n)).astype(np.float32) ** 3
    m[rng.rand(n, n) < 0.1] = 0.5
    m = np.triu(m, 1)
    m = m + m.T
    np.fill_diagonal(m, 1.0)
    return m


def test_nms3d_on_a_shared_iou_matrix(monkeypatch):
    """The suppression loop alone: one IoU matrix fed to both sides (in
    the order each side sorts the boxes), keeps bit for bit."""
    rng = np.random.RandomState(7)
    N = 40
    boxes = _boxes(rng, N)
    scores = np.round(rng.uniform(0, 1, N), 1).astype(np.float32)  # ties
    mask = rng.rand(N) > 0.1
    iou = _shared_iou(rng, N)
    order = np.argsort(np.where(mask, -scores, np.inf), kind='stable')
    sorted_iou = iou[order][:, order]
    monkeypatch.setattr(jnms, 'box3d_iou',
                        lambda a, b: jnp.asarray(sorted_iou))
    monkeypatch.setattr(tnms, 'box3d_iou',
                        lambda a, b: torch.from_numpy(sorted_iou))
    want = np.asarray(jnms.nms3d.__wrapped__(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(mask)))
    got = tnms.nms3d(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                     torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < mask.sum()


def _nms_inputs(seed, B=2, N=60, C=5):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 2, (B, 12, 3))
    boxes = np.concatenate([
        centers[:, rng.randint(0, 12, N)] + rng.normal(0, 0.05, (B, N, 3)),
        rng.uniform(0.3, 0.8, (B, N, 3)), rng.uniform(-0.3, 0.3, (B, N, 3))],
        -1).astype(np.float32)
    scores = rng.uniform(0, 0.3, (B, N, C)).astype(np.float32)
    scores[rng.rand(B, N, C) < 0.4] = 0.005      # under score_thr
    scores[:, 5:9] = scores[:, :4]               # tied candidates
    mask = rng.rand(B, N) > 0.1
    return boxes, scores, mask


@pytest.mark.parametrize('nms_pre,max_out', [(60, 256), (40, 16)])
def test_multiclass_nms_on_a_shared_iou_matrix(monkeypatch, nms_pre,
                                               max_out):
    """The batched per-class loop on one IoU matrix a scene fed to both
    sides, with IoUs exactly at the threshold and tied scores: boxes,
    scores, labels and valid masks bit for bit."""
    boxes, scores, mask = _nms_inputs(8)
    rng = np.random.RandomState(9)
    B, N, _ = scores.shape
    P = min(nms_pre, N)
    mats = []
    for b in range(B):
        best = np.where(mask[b], scores[b].max(-1), -np.inf)
        cand = np.argsort(-best, kind='stable')[:P]
        iou = _shared_iou(rng, N)
        mats.append(iou[cand][:, cand])
    calls = {'jax': 0, 'port': 0}

    def fake(side, wrap):
        def iou_of(a, b):
            m = mats[calls[side]]
            calls[side] += 1
            return wrap(m)
        return iou_of

    monkeypatch.setattr(jnms, 'box3d_iou', fake('jax', jnp.asarray))
    monkeypatch.setattr(tnms, 'box3d_iou', fake('port', torch.from_numpy))
    kw = dict(score_thr=0.01, iou_thr=0.5, nms_pre=nms_pre, max_out=max_out)
    want = [[np.asarray(x) for x in jnms.multiclass_nms.__wrapped__(
        jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(mask[b]),
        **kw)] for b in range(B)]
    got = [x.numpy() for x in tnms.multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(mask), **kw)]
    for b in range(B):
        for i, name in enumerate(('boxes', 'scores', 'labels', 'valid')):
            np.testing.assert_array_equal(got[i][b], want[b][i], name)
    assert all(0 < w[3].sum() for w in want)


def test_multiclass_nms_matches_jax():
    """The whole batched NMS, IoU included, against the JAX package's
    `jax.vmap` of it (the Runner's form): bit for bit."""
    boxes, scores, mask = _nms_inputs(10)
    kw = dict(score_thr=0.01, iou_thr=0.5, nms_pre=50, max_out=32)
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda b, s, m: jnms.multiclass_nms(b, s, m, **kw)))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask))]
    got = [x.numpy() for x in tnms.multiclass_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(mask), **kw)]
    for i, name in enumerate(('boxes', 'scores', 'labels', 'valid')):
        np.testing.assert_array_equal(got[i], want[i], name)
    assert want[3].sum() > 8


def test_multiclass_nms_host_matches_jax():
    """The host loop of one nms3d call a class (the reference's form):
    boxes, scores and labels bit for bit."""
    boxes, scores, mask = _nms_inputs(12, B=1, N=30, C=3)
    kw = dict(score_thr=0.01, iou_thr=0.5, nms_pre=24)
    want = jhead_mod.multiclass_nms_host(boxes[0], scores[0], mask[0], **kw)
    got = thead_mod.multiclass_nms_host(boxes[0], scores[0], mask[0], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(want[2]) > 3


# --------------------------------------------------------------------------
# the whole detector
# --------------------------------------------------------------------------
def test_detector_state_dict_covers_the_jax_tree(variables):
    sd = state_dict_from_jax(variables)
    model = TDetector(**TINY_DET, device='meta')
    assert set(sd) == set(model.state_dict())
    assert sd['bbox_head.scales.0.scale'].shape == ()


def test_detector_predict_matches_jax(variables, batch, jax_predict,
                                      monkeypatch):
    want, seen = jax_predict
    got_seen = {}
    voxelize, compact = tdet_mod.voxelize_points, thead_mod.compact_topk

    def rec_voxelize(*a, **kw):
        out = voxelize(*a, **kw)
        got_seen['keys'] = out.keys.numpy()
        return out

    def rec_compact(*a, **kw):
        out = compact(*a, **kw)
        got_seen.setdefault('src', []).append(out[2].numpy())
        return out

    monkeypatch.setattr(tdet_mod, 'voxelize_points', rec_voxelize)
    monkeypatch.setattr(thead_mod, 'compact_topk', rec_compact)
    got = port_model(variables)(batch_to_device(batch, 'cpu'))
    np.testing.assert_array_equal(got_seen['keys'], seen['keys'][0])
    assert len(got_seen['src']) == len(seen['src']) == 6
    for g, w in zip(got_seen['src'], seen['src']):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got['mask'].numpy(), want['mask'])
    assert want['mask'].sum() > 100
    for k in ('bboxes_3d', 'scores_3d'):
        float_close(got[k].numpy(), want[k], k)


def test_detector_train_step_matches_jax(variables, batch, jax_step):
    want, want_grads, want_after = jax_step
    model = port_model(variables)
    step = ttrain.make_train_step(model, ttrain.build_optimizer(model))
    got = {k: float(v)
           for k, v in step(batch_to_device(batch, 'cpu')).items()}
    assert set(got) == set(want) == {'loss_center', 'loss_bbox', 'loss_cls',
                                     'total_loss', 'grad_norm'}
    for k in want:
        rtol = GRAD_TOL if k == 'grad_norm' else LOSS_RTOL
        assert abs(got[k] - want[k]) <= rtol * abs(want[k]), k
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want_grads = {n: want_grads[n] for n in grads}
    top = max(np.abs(g).max() for g in want_grads.values())
    for n, g in grads.items():
        w = want_grads[n]
        tol = GRAD_TOL * np.abs(w).max() + GRAD_FLOOR * top
        assert np.abs(g - w).max() <= tol, n
    # the train-mode norms' running statistics
    for n, v in model.state_dict().items():
        if 'running' in n:
            float_close(v.numpy(), want_after[n], n)
    # frozen: the 2D stem and stage 1 keep their weights bit for bit
    before = state_dict_from_jax(variables)
    for n, p in model.named_parameters():
        if ttrain.param_label(n) == 'frozen':
            assert torch.equal(p.detach(), before[n]), n


def test_indoor_det_metric_matches_jax():
    rng = np.random.RandomState(11)
    samples = []
    for _ in range(3):
        gt = _boxes(rng, 5)
        gt_labels = rng.randint(0, 4, 5)
        pred = np.concatenate([gt + rng.normal(0, 0.1, gt.shape),
                               _boxes(rng, 6)]).astype(np.float32)
        pred[-1, 3:6] = [0.01, 0.01, 0.5]                  # a thin box
        samples.append((
            {'gt_bboxes_3d': gt, 'gt_labels_3d': gt_labels},
            {'bboxes_3d': pred, 'scores_3d': rng.uniform(0, 1, 11),
             'labels_3d': np.concatenate([gt_labels,
                                          rng.randint(0, 5, 6)])}))
    results = []
    for metric in (IndoorDetMetric(), JaxIndoorDetMetric()):
        for ann, pred in samples:
            metric.process(None, [{'eval_ann_info': ann,
                                   'pred_instances_3d': pred}])
        results.append(metric.evaluate())
    assert results[0] == results[1]
    assert 0 < results[0]['mAP_0.25'] < 1


def test_train_cli_trains_validates_checkpoints_and_resumes(tmp_path):
    """configs/detection/synthetic_smoke.py through tools/train.py on the
    CPU: an epoch of two steps, val with the batched NMS and
    IndoorDetMetric, a checkpoint; then --resume auto for a second epoch,
    which starts from the saved state."""
    work = str(tmp_path)
    runner = ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', work])
    assert [r['iter'] for r in runner.train_log] == [1, 2]
    assert all(np.isfinite(r['total_loss']) for r in runner.train_log)
    results = (tmp_path / 'val_results.json').read_text()
    assert '"mAP_0.25"' in results and '"mAR_0.50"' in results
    path = latest_checkpoint(work)
    saved = load_checkpoint(path)
    assert saved['step'] == 2
    for n, v in runner.model.state_dict().items():
        assert torch.equal(saved['model'][n], v), n
    again = ttrain_cli.main([SMOKE, '--device', 'cpu', '--work-dir', work,
                             '--resume', 'auto', '--cfg-options',
                             'train_cfg.max_epochs=2'])
    assert again.global_step == 4
    assert [(r['epoch'], r['iter']) for r in again.train_log] == [(1, 1),
                                                                  (1, 2)]
