"""The 2D ResNet at every depth the JAX package builds (18 and 34 of basic
blocks, 50 and 101 of bottlenecks), alone and inside the models that
take it, against the JAX package on the CPU.

Weights: the ResNet cases draw an upstream-named state dict
(`fake_reference_state_dict(with_backbone2d=True, img_depth=d)`),
convert it with the JAX package's `convert_torch_resnet` and carry the
JAX tree back with `state_dict_from_jax`; the tiny grounder loads the
upstream state dict itself (the JAX twin through `convert_detector`);
the occupancy predictors and the detector take seeded values on the
JAX model's own variable tree (its shapes by `jax.eval_shape` of the
init, so that each JAX model compiles once, in a module-scoped
fixture). Tolerances:

- RESNET_ATOL / RESNET_RTOL: float32 stage outputs within 1e-5 + 1e-4
  relative (tests/test_torch_port_models.py's ResNet-50 tolerance;
  sums in another order);
- bfloat16: one bf16 ulp of the larger value plus 1e-5 of the largest
  (tests/test_torch_port_bf16_modules.py's rule), against JAX compiled
  with `xla_allow_excess_precision` off;
- `remat=True` gives the same bits as `remat=False`, outputs and
  gradients (the ResNet alone); the bf16 remat grounder at depth 101 a
  finite loss and gradient;
- the occupancy predictors: losses within LOSS_RTOL = 1e-6 relative,
  logits at every scale within FLOAT_TOL = 1e-5 · (1 + max|x|), the
  predicted labels equal wherever the JAX logits' top two are apart by
  more than that (tests/test_torch_port_occupancy.py's rules);
- the grounder at depth 101: the query mask bit for bit, boxes and
  scores within 1e-5 + 1e-4 relative (tests/test_torch_port_detector.py's);
- the detector at depth 101: the mask bit for bit, boxes and scores
  within 1e-5 · (1 + max) (tests/test_torch_port_detection.py's);
- `check_parity`'s backbone replay within its atol 2e-3, no SKIP.

Where the JAX package fails (the grounder and the detector at 18 and
34: their neck's and head's widths assume the bottleneck's expansion of
4), the port raises ValueError at construction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter.parity import check_parity
from proxytransformation_tpu.converter.torch_weights import (
    convert_detector, fake_reference_state_dict)
from proxytransformation_tpu.models import occ as jocc
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_tpu.models.embodied_det3d import (
    Embodied3DDetector as JDetector)
from proxytransformation_tpu.models.resnet import ResNet as JResNet
from proxytransformation_tpu.models.resnet import convert_torch_resnet
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.converter.parity import record_activations
from proxytransformation_torch.engine.runner import build_model_from_cfg
from proxytransformation_torch.models import occ as tocc
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounder as TBaseline,
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)
from proxytransformation_torch.models.embodied_det3d import (
    Embodied3DDetector as TDetector)
from proxytransformation_torch.models.resnet import (BasicBlock2D,
                                                     Bottleneck, ResNet)
from proxytransformation_torch.tools import test as ttest_cli
from proxytransformation_torch.tools import train as ttrain_cli
from proxytransformation_torch.utils.config import Config

from test_detector import tiny_batch
from test_torch_port_bf16_modules import assert_bf16_close, jit_exact
from test_torch_port_detection import TINY_DET, det_batch, float_close
from test_torch_port_detector import PREDICT_KEYS, TINY
from test_torch_port_parity_harness import _check, _save

DEPTHS = (18, 34, 50, 101)
BASE = 4
RESNET_ATOL, RESNET_RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-6
FLOAT_TOL = 1e-5
# the tiny grounder of tests/test_torch_port_detector.py with one decoder
# and one text layer (its JAX compile is the file's largest cost)
ONE_LAYER = dict(decoder_layers=1, text_layers=1)
OCC = dict(n_voxels=(16, 16, 8), voxel_range=(0, 0, 0, 3.2, 3.2, 1.6),
           num_classes=6, img_base_channels=BASE, neck_channels=16)
CONFIGS = {'grounding': 'configs/grounding/synthetic_smoke.py',
           'detection': 'configs/detection/synthetic_smoke.py',
           'occupancy': 'configs/occupancy/synthetic_smoke.py'}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _tensors(sd, prefix=''):
    """The entries under `prefix`, without it, as tensors."""
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items()
            if k.startswith(prefix)}


def _upstream_sd(depth, seed=0, **kw):
    """An upstream-named grounder state dict with the 2D ResNet of
    `depth` at base 4 (the tiny grounder's widths otherwise; `kw`
    overrides them)."""
    return fake_reference_state_dict(np.random.RandomState(seed), **{
        'embed_dim': 64, 'num_heads': 4, 'text_blocks': 1, 'img_blocks': 1,
        'img_spacial_dim': 2, 'input_dim': BASE * 32, 'real_cluster': 32,
        'backbone3d_depth': 14,
        'neck_channels': (64 + 16, 128 + 32, 256 + 64, 512 + 128),
        'neck_out': 64, 'decoder_layers': 2, 'dec_embed': 64,
        'dec_ffn': 128, 'with_backbone2d': True, 'img_depth': depth,
        'img_base': BASE, 'with_text_encoder': True, 'text_width': 64,
        'text_layers': 2, **kw})


def _images(seed=5):
    return np.random.RandomState(seed).randn(2, 64, 64, 3).astype(
        np.float32)


# --------------------------------------------------------------------------
# the ResNet alone
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def resnet_weights():
    """{depth: (the JAX backbone's variables by the JAX package's
    `convert_torch_resnet`, the port's state dict by `state_dict_from_jax`,
    the upstream backbone entries)}."""
    out = {}
    for d in DEPTHS:
        upstream = {k: v for k, v in _upstream_sd(
            d, seed=d, with_text_encoder=False).items()
            if k.startswith('backbone.')}
        params, stats = convert_torch_resnet(
            {k[len('backbone.'):]: v for k, v in upstream.items()}, depth=d)
        jv = {'params': params, 'batch_stats': stats}
        port_sd = state_dict_from_jax({'params': {'backbone': params},
                                       'batch_stats': {'backbone': stats}})
        out[d] = (jv, port_sd, upstream)
    return out


@pytest.mark.parametrize('depth', DEPTHS)
def test_resnet_stages_match_jax(resnet_weights, depth):
    jv, port_sd, _ = resnet_weights[depth]
    x = _images()
    want = jax.jit(lambda v, x: JResNet(depth=depth, base_channels=BASE)
                   .apply(v, x))(jv, jnp.asarray(x))
    port = ResNet(depth, BASE)
    port.load_state_dict(_tensors(port_sd, 'backbone.'), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert port.out_channels == tuple(w.shape[-1] for w in want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=RESNET_ATOL, rtol=RESNET_RTOL)


@pytest.mark.parametrize('depth', DEPTHS)
def test_resnet_structure_and_upstream_names(resnet_weights, depth):
    """The block class and counts of the JAX `arch_settings`; the upstream
    entries load with strict=True (into the ResNet and into an occupancy
    predictor's backbone), and `state_dict_from_jax` gives them back bit
    for bit."""
    _, port_sd, upstream = resnet_weights[depth]
    port = ResNet(depth, BASE)
    block_cls, counts = JResNet.arch_settings[depth]
    want_cls = Bottleneck if block_cls.__name__ == 'Bottleneck' \
        else BasicBlock2D
    for i, n in enumerate(counts):
        layer = getattr(port, f'layer{i + 1}')
        assert len(layer) == n and all(type(b) is want_cls for b in layer)
    missing, unexpected = port.load_state_dict(
        _tensors(upstream, 'backbone.'), strict=True)
    assert not missing and not unexpected
    occ = tocc.EmbodiedOccPredictor(img_depth=depth, **OCC, device='cpu')
    occ.backbone.load_state_dict(_tensors(upstream, 'backbone.'),
                                 strict=True)
    assert occ.feat_proj.in_features == port.out_channels[0]
    assert set(port_sd) == set(upstream)
    for k, v in upstream.items():
        np.testing.assert_array_equal(port_sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('depth', (18, 101))
def test_resnet_bf16_matches_jax(resnet_weights, depth):
    jv, port_sd, _ = resnet_weights[depth]
    x = _images(6)
    want = jit_exact(lambda v, x: JResNet(depth=depth, base_channels=BASE,
                                          dtype=jnp.bfloat16).apply(v, x),
                     jv, jnp.asarray(x))
    port = ResNet(depth, BASE, torch.bfloat16)
    port.load_state_dict(_tensors(port_sd, 'backbone.'))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_bf16_close(g, w)


@pytest.mark.parametrize('depth', (18, 101))
def test_resnet_remat_gives_the_same_bits(resnet_weights, depth):
    _, port_sd, _ = resnet_weights[depth]
    runs = []
    for remat in (False, True):
        port = ResNet(depth, BASE, remat=remat)
        port.load_state_dict(_tensors(port_sd, 'backbone.'))
        x = torch.from_numpy(_images(7)).requires_grad_()
        outs = port(x)
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        runs.append(([o.detach() for o in outs], x.grad,
                     {n: p.grad for n, p in port.named_parameters()}))
    (o0, x0, g0), (o1, x1, g1) = runs
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert torch.equal(x0, x1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_unknown_depth_raises():
    with pytest.raises(ValueError, match=r'\[18, 34, 50, 101\]'):
        ResNet(26, BASE)


@pytest.mark.parametrize('depth', (18, 101))
def test_check_parity_replays_the_backbone(tmp_path, resnet_weights, depth):
    """The JAX package's `check_parity` on a standalone port ResNet: the
    checkpoint is an upstream grounder state dict with the port's
    `backbone.*` entries (a backbone-only `.pth` does not convert); the
    harness reads the depth off the converted tree."""
    _, port_sd, _ = resnet_weights[depth]
    port = ResNet(depth, BASE)
    port.load_state_dict(_tensors(port_sd, 'backbone.'))
    acts = record_activations(port, torch.from_numpy(_images(8)))
    assert set(acts) == {'backbone.in0', *(f'backbone.out{i}'
                                           for i in range(4))}
    sd = _tensors({k: v for k, v in _upstream_sd(18).items()
                   if not k.startswith('backbone.')})
    sd.update({f'backbone.{k}': v for k, v in port.state_dict().items()})
    _save(sd, tmp_path / 'resnet.pth')
    np.savez(str(tmp_path / 'acts.npz'), **acts)
    log = []
    results = check_parity(str(tmp_path / 'resnet.pth'),
                           str(tmp_path / 'acts.npz'), atol=2e-3,
                           report=log.append)
    assert not [line for line in log if line.startswith(('SKIP', 'FAIL'))]
    _check(results, {f'backbone.out{i}' for i in range(4)})


# --------------------------------------------------------------------------
# the occupancy predictors at basic-block depths
# --------------------------------------------------------------------------
def _occ_batch(seed=1, B=2, V=2, H=64, W=64, N=512, G=20):
    rng = np.random.RandomState(seed)
    proj = np.tile(np.array([[50, 0, W / 2, 0], [0, 50, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    occ_pts = np.concatenate([
        rng.randint(0, 16, (B, G, 2)), rng.randint(0, 8, (B, G, 1)),
        rng.randint(1, 6, (B, G, 1))], -1).astype(np.float32)
    return {'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
            'points': rng.uniform(0, 3.0, (B, N, 3)).astype(np.float32),
            'points_mask': np.ones((B, N), bool), 'proj_mats': proj,
            'views_mask': np.ones((B, V), bool),
            'gt_occupancy': occ_pts,
            'gt_occupancy_masks': np.arange(G)[None] < [[G], [G - 5]]}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = FLOAT_TOL * (1 + np.abs(want).max())
    assert err <= tol, (what, err, tol)


def _random_variables(shapes, seed):
    """Seeded numpy values for a JAX variable tree of `jax.eval_shape`
    leaves (no compile of the init): kernels at unit fan-in variance,
    norm scales near 1, variances in [0.5, 1.5), the rest near 0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'kernel':
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == 'scale':
            x = 1 + 0.1 * rng.randn(*shape)
        elif name == 'var':
            x = 0.5 + rng.rand(*shape)
        else:
            x = 0.1 * rng.randn(*shape)
        return x.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_variables(model, batch, seed, **kw):
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b,
                                                 **kw), batch)
    return _random_variables(shapes, seed)


@pytest.fixture(scope='module', params=[('EmbodiedOccPredictor', 18),
                                        ('DenseFusionOccPredictor', 34),
                                        ('DenseFusionOccPredictor', 101)],
                ids=['embodied-18', 'densefusion-34', 'densefusion-101'])
def occ_pair(request):
    """(model type, depth, the port's state dict of the JAX weights, the
    batch, the JAX losses, logits at every scale and predicted labels):
    one compile of the JAX model a case."""
    mtype, depth = request.param
    batch = _occ_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = getattr(jocc, mtype)(img_depth=depth, **OCC)
    variables = _jax_variables(jmodel, jb, depth, mode='loss', train=False)

    def outputs(m, b):
        preds = m.bbox_head(m.extract_feat(b, False))
        losses = m.bbox_head.loss(
            m.bbox_head(m.extract_feat(b, True)), b['gt_occupancy'],
            b['gt_occupancy_masks'])
        return losses, preds, m.bbox_head.predict(preds)

    (losses, logits, labels), _ = jax.jit(
        lambda v, b: jmodel.apply(v, b, method=outputs,
                                  mutable=['batch_stats']))(variables, jb)
    return (mtype, depth, state_dict_from_jax(variables), batch,
            {k: float(v) for k, v in losses.items()}, _np_tree(logits),
            np.asarray(labels))


def _occ_port(occ_pair):
    mtype, depth, sd = occ_pair[:3]
    port = getattr(tocc, mtype)(img_depth=depth, **OCC, device='cpu')
    missing, unexpected = port.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return port


def test_occ_predictor_loss_matches_jax(occ_pair):
    port = _occ_port(occ_pair)
    batch, want = occ_pair[3:5]
    expansion = 1 if occ_pair[1] < 50 else 4
    assert (port.feat_proj.in_features == port.backbone.out_channels[0]
            == BASE * expansion)
    got = port.loss(batch_to_device(batch, 'cpu'))
    assert set(got) == set(want)
    for k, w in want.items():
        g = float(got[k].detach())
        assert abs(g - w) <= LOSS_RTOL * abs(w), (k, g, w)


def test_occ_predictor_predict_matches_jax(occ_pair):
    port = _occ_port(occ_pair)
    batch, _, logits, labels = occ_pair[3:]
    tb = batch_to_device(batch, 'cpu')
    with torch.no_grad():
        got = port.logits(tb)
    for i, (g, w) in enumerate(zip(got, logits)):
        _close(g.numpy(), w, f'scale {i}')
    top2 = np.sort(logits[0], -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > FLOAT_TOL * (
        1 + np.abs(logits[0]).max())
    assert clear.mean() > 0.99
    occ = port(tb)['occupancy'].numpy()
    np.testing.assert_array_equal(occ[clear], labels[clear])


# --------------------------------------------------------------------------
# the grounder and the detector: depth 101 runs, 18 and 34 raise
# --------------------------------------------------------------------------
def test_grounder_at_depth_101_predict_matches_jax():
    sd = _upstream_sd(101, seed=11, **ONE_LAYER)
    cfg = dict(TINY, img_depth=101, **ONE_LAYER)
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1)).items()
             if k in PREDICT_KEYS}
    jmodel = JGrounder(**cfg)
    want = _np_tree(jax.jit(lambda v, b: jmodel.apply(v, b, mode='predict'))(
        convert_detector(sd), {k: jnp.asarray(v) for k, v in batch.items()}))
    port = TGrounder(**cfg, device='cpu')
    missing, unexpected = port.load_state_dict(_tensors(sd), strict=True)
    assert not missing and not unexpected
    assert len(port.backbone.layer3) == 23
    got = port(batch_to_device(batch, 'cpu'))
    np.testing.assert_array_equal(got['query_mask'].numpy(),
                                  want['query_mask'])
    assert got['query_mask'].numpy().sum() > 0
    for k in ('bboxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_grounder_at_depth_101_bf16_remat_step():
    """The bf16 mode with remat and remat_painting at depth 101: one loss
    and backward on the CPU, finite, with a gradient through the last
    block of stage 3 (remat's bits against no remat: the ResNet alone
    above; the bf16 ResNet-101 against JAX: above)."""
    sd = _tensors(_upstream_sd(101, seed=12, **ONE_LAYER))
    batch = batch_to_device({k: np.asarray(v) for k, v in tiny_batch(
        np.random.RandomState(2)).items()}, 'cpu')
    model = TGrounder(**dict(TINY, img_depth=101, **ONE_LAYER), remat=True,
                      remat_painting=True, compute_dtype='bfloat16',
                      device='cpu')
    model.load_state_dict(sd)
    model.train()
    losses = model.loss(batch, torch.Generator().manual_seed(0))
    sum(losses[k] for k in sorted(losses)).backward()
    assert all(np.isfinite(float(v.detach())) for v in losses.values())
    grad = model.backbone.layer3[22].conv3.weight.grad
    assert torch.isfinite(grad).all() and bool(grad.abs().max() > 0)


def test_detector_at_depth_101_predict_matches_jax():
    """The JAX detector's variables at depth 101 (their shapes by
    `jax.eval_shape` of its init, seeded values) carry into the port's
    detector with strict=True, and one predict matches the JAX
    detector's: the mask bit for bit, boxes and scores within
    1e-5 · (1 + max) (tests/test_torch_port_detection.py's rule)."""
    batch = det_batch()
    cfg = dict(TINY_DET, img_depth=101)
    jmodel = JDetector(**cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _jax_variables(jmodel, jb, 0, mode='loss', train=False)
    want = _np_tree(jax.jit(lambda v, b: jmodel.apply(v, b, mode='predict'))(
        variables, jb))
    port = TDetector(**cfg, device='cpu')
    missing, unexpected = port.load_state_dict(
        state_dict_from_jax(variables), strict=True)
    assert not missing and not unexpected
    assert len(port.backbone.layer3) == 23
    got = port(batch_to_device(batch, 'cpu'))
    np.testing.assert_array_equal(got['mask'].numpy(), want['mask'])
    assert want['mask'].sum() > 0
    for k in ('bboxes_3d', 'scores_3d'):
        float_close(got[k].numpy(), want[k], k)


@pytest.mark.parametrize('cls', (TGrounder, TBaseline, TDetector))
@pytest.mark.parametrize('depth', (18, 34))
def test_basic_block_depths_raise_for_the_neck(cls, depth):
    with pytest.raises(ValueError, match='expansion of 4') as err:
        cls(img_depth=depth, device='meta')
    assert f'img_depth={depth}' in str(err.value)


# --------------------------------------------------------------------------
# the builder and the CLIs
# --------------------------------------------------------------------------
@pytest.mark.parametrize('task,mtype,depth', [
    ('grounding', 'SparseFeatureFusion3DGrounderPreshape', 101),
    ('grounding', 'SparseFeatureFusion3DGrounder', 101),
    ('detection', 'Embodied3DDetector', 101),
    ('occupancy', 'EmbodiedOccPredictor', 18),
    ('occupancy', 'EmbodiedOccPredictor', 34),
    ('occupancy', 'DenseFusionOccPredictor', 18),
    ('occupancy', 'DenseFusionOccPredictor', 101)])
def test_builder_carries_backbone_depth(task, mtype, depth):
    cfg = dict(Config.fromfile(CONFIGS[task])['model'], type=mtype)
    cfg['backbone'] = dict(cfg['backbone'], depth=depth)
    if mtype == 'SparseFeatureFusion3DGrounder':
        del cfg['preshape']
    model = build_model_from_cfg(cfg, device='meta')
    assert type(model).__name__ == mtype
    assert model.backbone.depth == depth
    assert len(model.backbone.layer3) == {18: 2, 34: 6, 101: 23}[depth]


@pytest.mark.parametrize('task', ('grounding', 'detection'))
@pytest.mark.parametrize('depth', (18, 34))
def test_builder_raises_where_the_jax_model_fails(task, depth):
    cfg = Config.fromfile(CONFIGS[task])['model']
    cfg['backbone'] = dict(cfg['backbone'], depth=depth)
    with pytest.raises(ValueError, match='expansion of 4'):
        build_model_from_cfg(cfg, device='meta')


@pytest.mark.parametrize('task,depth', [('grounding', 101),
                                        ('occupancy', 18),
                                        ('occupancy', 101)])
def test_clis_train_and_test_at_depth(tmp_path, task, depth):
    """The smoke config with `model.backbone.depth` set through
    tools/train.py (an epoch, a checkpoint, val) and tools/test.py on the
    checkpoint, on the CPU."""
    work = str(tmp_path)
    opts = ['--cfg-options', f'model.backbone.depth={depth}',
            'train_dataloader.dataset.length=2',
            'val_dataloader.dataset.length=2']
    runner = ttrain_cli.main([CONFIGS[task], '--device', 'cpu',
                              '--work-dir', work, *opts])
    assert runner.model.backbone.depth == depth
    assert runner.train_log and all(np.isfinite(r['total_loss'])
                                    for r in runner.train_log)
    from proxytransformation_torch.engine.checkpoint import latest_checkpoint
    path = latest_checkpoint(work)
    tested = ttest_cli.main([CONFIGS[task], path, '--device', 'cpu',
                             '--work-dir', work, *opts])
    assert tested
