"""The port's modules against the JAX package's, on the CPU, at tiny size.

Weights come from `fake_reference_state_dict`: the port loads it with
`load_state_dict`, the JAX twin through `convert_detector`. Inputs are
numpy arrays from a seed, handed to both. Integer outputs (voxel keys,
coords, masks, neighbor maps) must match bit for bit; float outputs
within atol=1e-5, rtol=1e-4 (float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter.torch_weights import (
    convert_detector, fake_reference_state_dict)
from proxytransformation_tpu.models import decoder as jdec
from proxytransformation_tpu.models import grounding_head as jhead
from proxytransformation_tpu.models import norms as jnorms
from proxytransformation_tpu.models import point_fusion as jpf
from proxytransformation_tpu.models import preshape as jpre
from proxytransformation_tpu.models.resnet import ResNet as JResNet
from proxytransformation_tpu.models.sparse_neck import MinkNeck as JNeck
from proxytransformation_tpu.models.sparse_resnet import MinkResNet as JMink
from proxytransformation_tpu.models.text_encoder import (
    CLIPTextEncoder as JCLIP)
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_tpu.structures import rotation as jrot
from proxytransformation_torch.models import decoder as tdec
from proxytransformation_torch.models import grounding_head as thead
from proxytransformation_torch.models import norms as tnorms
from proxytransformation_torch.models import point_fusion as tpf
from proxytransformation_torch.models import preshape as tpre
from proxytransformation_torch.models.resnet import ResNet as TResNet
from proxytransformation_torch.models.sparse_neck import MinkNeck as TNeck
from proxytransformation_torch.models.sparse_resnet import MinkResNet as TMink
from proxytransformation_torch.models.text_encoder import (
    CLIPTextEncoder as TCLIP)
from proxytransformation_torch.ops import sparse as tsp
from proxytransformation_torch.structures import rotation as trot

ATOL, RTOL = 1e-5, 1e-4
CAPS = (1024, 800, 512, 256, 128, 64)
EXTENT = (128, 128, 128)


def t(a):
    return torch.from_numpy(np.array(a))


def n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close(got, want, atol=ATOL, rtol=RTOL, **kw):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=atol,
                               rtol=rtol, **kw)


def sub(sd, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items()
            if k.startswith(prefix)}


def jvars(variables, name):
    out = {'params': variables['params'][name]}
    if name in variables['batch_stats']:
        out['batch_stats'] = variables['batch_stats'][name]
    return out


@pytest.fixture(scope='module')
def weights():
    """A reference-layout state dict and its JAX conversion: preshape
    width 16 (4 heads, grid 4 at drop ratio 0.5 → 32 clusters), MinkResNet
    depth 14, neck over the unpainted backbone widths, 2 decoder layers,
    ResNet-50 at base 4, a 2-layer CLIP text tower of width 32."""
    sd = fake_reference_state_dict(
        np.random.RandomState(0), embed_dim=16, num_heads=4, text_blocks=1,
        img_blocks=1, img_spacial_dim=2, input_dim=8, real_cluster=32,
        backbone3d_depth=14, neck_channels=(64, 128, 256, 512), neck_out=16,
        decoder_layers=2, dec_embed=16, dec_ffn=32, with_backbone2d=True,
        img_depth=50, img_base=4, with_text_encoder=True, text_width=32,
        text_layers=2)
    return sd, convert_detector(sd)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def test_masked_norms_match():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 30, 5).astype(np.float32)
    mask = rng.rand(2, 30) > 0.3
    C = 5
    p = {'scale': rng.rand(C).astype(np.float32) + 0.5,
         'bias': rng.randn(C).astype(np.float32)}
    s = {'mean': rng.randn(C).astype(np.float32),
         'var': rng.rand(C).astype(np.float32) + 0.5}
    want = jnorms.MaskedBatchNorm().apply({'params': p, 'batch_stats': s},
                                          jnp.asarray(x), jnp.asarray(mask))
    bn = tnorms.MaskedBatchNorm(C)
    bn.load_state_dict({'bn.weight': t(p['scale']), 'bn.bias': t(p['bias']),
                        'bn.running_mean': t(s['mean']),
                        'bn.running_var': t(s['var']),
                        'bn.num_batches_tracked': torch.tensor(3)})
    close(bn(t(x), t(mask)), want)
    want = jnorms.MaskedInstanceNorm().apply({'params': p}, jnp.asarray(x),
                                             jnp.asarray(mask))
    inorm = tnorms.MaskedInstanceNorm(C)
    inorm.load_state_dict({'weight': t(p['scale']), 'bias': t(p['bias'])})
    close(inorm(t(x), t(mask)), want)


# --------------------------------------------------------------------------
# preshape (holds kernel 1): the parity hooks, then the whole module
# --------------------------------------------------------------------------
def _preshape_pair(sd, variables):
    kw = dict(embed_dim=16, num_heads=4, grid_size=4, text_blocks=1,
              img_blocks=1, dynamic_drop_radio=0.5, num_sub=8, input_dim=8,
              img_spacial_dim=2)
    port = tpre.ProxyTransformationNormReverse(**kw)
    port.load_state_dict(sub(sd, 'preshape.'))
    return port, jpre.ProxyTransformationNormReverse(n_points=2000, **kw), \
        jvars(variables, 'preshape')


def test_preshape_hooks_match(weights):
    sd, variables = weights
    port, _, jv = _preshape_pair(sd, variables)
    rng = np.random.RandomState(2)
    center = rng.randn(2, 9, 3).astype(np.float32)
    cluster = rng.randn(2, 9, 5, 3).astype(np.float32)
    cluster[0, 1, 2] = 0.0
    cluster[1, 4, :3] = 0.0
    for name, jcls, mod in (('simple_encoder', jpre.SimplifiedPointNet,
                             port.simple_encoder),
                            ('get_offsets', jpre.OffsetNetwork,
                             port.get_offsets)):
        v = {'params': jv['params'][name],
             'batch_stats': jv['batch_stats'][name]}
        want = jcls(16).apply(v, jnp.asarray(center), jnp.asarray(cluster))
        close(mod(t(center), t(cluster)), want, err_msg=name)


def test_preshape_forward_matches(weights):
    sd, variables = weights
    port, jmod, jv = _preshape_pair(sd, variables)
    rng = np.random.RandomState(3)
    B, N = 2, 2000
    pts = rng.uniform(0, 12.0, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -300:] = False
    text = rng.randn(B, 6, 16).astype(np.float32)
    tmask = np.arange(6)[None].repeat(B, 0) < [[4], [6]]
    img = rng.randn(B, 3, 2, 2, 8).astype(np.float32)
    args = (pts, mask, text, tmask, img)
    jp, jm = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(
        jv, *map(jnp.asarray, args))
    with torch.no_grad():
        tp, tm = port(*map(t, args))
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    assert 0 < n(tm).sum() < mask.sum()
    # moved points go through two ball queries, an FPS and the 3x3
    # transform: the moved set must agree exactly, the values in float32
    moved = np.any(np.asarray(jp) != pts, axis=-1)
    assert moved.sum() > 100
    np.testing.assert_array_equal(np.any(n(tp) != pts, axis=-1), moved)
    close(tp, jp)


# --------------------------------------------------------------------------
# MinkResNet (holds kernels 2 and 3), replayed level by level
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def backbone_levels(weights):
    sd, variables = weights
    rng = np.random.RandomState(4)
    pts = rng.uniform(0, 3.0, (2, 1024, 3)).astype(np.float32)
    mask = np.ones((2, 1024), bool)
    mask[0, -100:] = False
    jl0 = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(pts), voxel_size=0.05,
                              capacity=1024, extent=EXTENT)
    jouts, jmaps = jax.jit(lambda v, l: JMink(depth=14, capacities=CAPS)
                           .apply(v, l, return_self_maps=True))(
        jvars(variables, 'backbone_3d'), jl0)
    port = TMink(14, 3, CAPS)
    port.load_state_dict(sub(sd, 'backbone_3d.'))
    tl0 = tsp.voxelize_points(t(pts), t(mask), t(pts), 0.05, 1024, EXTENT)
    with torch.no_grad():
        touts, tmaps, _ = port(tl0)
    return jouts, jmaps, touts, tmaps


@pytest.mark.parametrize('level', range(4))
def test_minkresnet_level_matches(backbone_levels, level):
    jouts, jmaps, touts, tmaps = backbone_levels
    jl, tl = jouts[level], touts[level]
    for f in ('keys', 'coords', 'mask'):
        np.testing.assert_array_equal(n(getattr(tl, f)),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    np.testing.assert_array_equal(n(tmaps[level]), np.asarray(jmaps[level]))
    assert tl.stride == jl.stride and n(tl.mask).sum() > 0
    close(tl.feats, jl.feats)
    # MinkowskiEngine-style views of the level
    valid = n(tl.mask)
    assert n(tl.C).shape == (valid.sum(), 4)
    np.testing.assert_array_equal(n(tl.F), n(tl.feats)[valid])


def test_minkneck_matches(weights, backbone_levels):
    sd, variables = weights
    jouts, jmaps, _, _ = backbone_levels
    P = 40
    jneck = JNeck(in_channels=(64, 128, 256, 512), out_channels=16,
                  voxel_size=0.05, pts_prune_threshold=P)
    want = jax.jit(lambda v, l, m: jneck.apply(v, l, self_maps=m))(
        jvars(variables, 'neck_3d'), jouts, jmaps)
    port = TNeck(1, (64, 128, 256, 512), 16, P)
    port.load_state_dict(sub(sd, 'neck_3d.'))
    levels = [tsp.SparseLevel(t(l.keys), t(l.coords), t(l.feats), t(l.mask),
                              t(l.origin), tuple(l.extent), l.stride,
                              l.voxel_size) for l in jouts]
    with torch.no_grad():
        got = port(levels, self_maps=[t(m) for m in jmaps])
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))
    assert n(got[3]).sum() > 0
    for g, w in zip(got[:3], want[:3]):
        close(g, w)


# --------------------------------------------------------------------------
# dense towers
# --------------------------------------------------------------------------
def test_resnet50_matches(weights):
    sd, variables = weights
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, x: JResNet(depth=50, base_channels=4).apply(
        v, x))(jvars(variables, 'backbone'), jnp.asarray(x))
    port = TResNet(50, 4)
    port.load_state_dict(sub(sd, 'backbone.'))
    with torch.no_grad():
        got = port(t(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)


def test_clip_text_tower_matches(weights):
    sd, variables = weights
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 49408, (2, 9)).astype(np.int32)
    mask = np.arange(9)[None].repeat(2, 0) < [[9], [5]]
    want = JCLIP(width=32, layers=2, heads=4).apply(
        {'params': variables['params']['text_encoder']}, jnp.asarray(ids),
        jnp.asarray(mask))
    port = TCLIP(width=32, layers=2, heads=4)
    port.load_state_dict(sub(sd, 'text_encoder.'))
    with torch.no_grad():
        close(port(t(ids), t(mask)), want)


# --------------------------------------------------------------------------
# painting, decoder, head
# --------------------------------------------------------------------------
def test_point_fusion_matches():
    rng = np.random.RandomState(7)
    B, V, N, C, H, W = 2, 3, 200, 5, 64, 48
    feats = rng.randn(B, V, 8, 6, C).astype(np.float32)
    pts = np.concatenate([rng.uniform(-1, 1, (B, N, 2)),
                          rng.uniform(0.5, 3, (B, N, 1))], -1).astype(
                              np.float32)
    proj = np.tile(np.array([[40, 0, W / 2, 0], [0, 40, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    proj[:, 1, 0, 3] = 7.0
    proj[:, 2, 2, 3] = -1.5
    vmask = rng.rand(B, N) > 0.1
    views = np.array([[True, True, False], [True, True, True]])
    rot = np.stack([np.asarray(jrot.euler_angles_to_matrix(
        jnp.asarray(rng.randn(3).astype(np.float32) * 0.2)))
        for _ in range(B)]).astype(np.float32)
    aug = dict(pcd_rotation=rot, pcd_scale_factor=np.float32([1.1, 0.9]),
               pcd_trans=rng.randn(B, 3).astype(np.float32) * 0.1,
               flip_x=np.array([True, False]), flip_y=np.array([False, True]))
    jinv = jax.vmap(jpf.apply_inverse_aug)(
        jnp.asarray(pts), *(jnp.asarray(aug[k]) for k in aug))
    tinv = tpf.apply_inverse_aug(t(pts), *(t(aug[k]) for k in aug))
    close(tinv, jinv, atol=1e-6)
    want = jax.vmap(lambda f, p, pr, vm, vw: jpf.batch_point_sample(
        f, p, pr, (H, W), valid_mask=vm, views_mask=vw))(
        jnp.asarray(feats), jinv, jnp.asarray(proj), jnp.asarray(vmask),
        jnp.asarray(views))
    got = tpf.batch_point_sample(t(feats), t(np.asarray(jinv)), t(proj),
                                 (H, W), valid_mask=t(vmask),
                                 views_mask=t(views))
    assert (np.abs(np.asarray(want)).sum(-1) > 0).sum() > 50
    close(got, want)


def test_decoder_matches(weights):
    sd, variables = weights
    rng = np.random.RandomState(8)
    B, Q, P, L, D = 2, 6, 20, 5, 16
    query = rng.randn(B, Q, D).astype(np.float32)
    feats = rng.randn(B, P, D).astype(np.float32)
    fmask = rng.rand(B, P) > 0.2
    qcoords = rng.randn(B, Q, 3).astype(np.float32)
    fcoords = rng.randn(B, P, 3).astype(np.float32)
    boxes = np.concatenate([rng.randn(B, Q, 3), rng.rand(B, Q, 3) + 0.3,
                           rng.randn(B, Q, 3) * 0.1], -1).astype(np.float32)
    text = rng.randn(B, L, D).astype(np.float32)
    tmask = np.arange(L)[None].repeat(B, 0) < [[5], [3]]
    qmask = np.ones((B, Q), bool)
    qmask[1, -2:] = False
    head_p = variables['params']['bbox_head']
    reg = jhead.RegBranch(D)
    coder = jhead.GroundingHead(embed_dims=D)

    def jrun(v, *a):
        return jdec.SparseFeatureFusionTransformerDecoder(
            num_layers=2, embed_dims=D, num_heads=4,
            feedforward_channels=32).apply(
                v, a[0], a[1], ~a[2], a[3], a[4], a[5], a[6], ~a[7],
                reg_branch_fn=lambda q, lid=None: reg.apply(
                    {'params': head_p['reg_branch']}, q),
                bbox_coder_fn=coder.bbox_pred_to_bbox,
                feats_mask=a[2], query_mask=a[8])

    args = (query, feats, fmask, qcoords, fcoords, boxes, text, tmask, qmask)
    jh, jb = jax.jit(jrun)(jvars(variables, 'decoder'),
                           *map(jnp.asarray, args))
    port = tdec.SparseFeatureFusionTransformerDecoder(2, D, 4, 32)
    port.load_state_dict(sub(sd, 'decoder.'))
    head = thead.GroundingHead(D, 9, 64)
    head.load_state_dict(sub(sd, 'bbox_head.'))
    ta = list(map(t, args))
    with torch.no_grad():
        th, tb = port(ta[0], ta[1], ~ta[2], ta[3], ta[4], ta[5], ta[6],
                      ~ta[7], reg_branch_fn=head.reg_branches[0],
                      bbox_coder_fn=head.bbox_pred_to_bbox, feats_mask=ta[2],
                      query_mask=ta[8])
    close(th, jh)
    close(tb, jb)


def test_grounding_head_predict_matches(weights):
    sd, variables = weights
    rng = np.random.RandomState(9)
    B, Q, L, D = 2, 7, 5, 16
    hidden = rng.randn(3, B, Q, D).astype(np.float32)
    boxes = rng.randn(3, B, Q, 9).astype(np.float32)
    text = rng.randn(B, L, D).astype(np.float32)
    tmask = np.arange(L)[None].repeat(B, 0) < [[5], [2]]
    qmask = rng.rand(B, Q) > 0.3
    jh = jhead.GroundingHead(embed_dims=D, max_text_len=64)
    want = jh.apply({'params': variables['params']['bbox_head']},
                    *map(jnp.asarray, (hidden, boxes, text, tmask, qmask)),
                    method=jh.predict)
    head = thead.GroundingHead(D, 9, 64)
    head.load_state_dict(sub(sd, 'bbox_head.'))
    with torch.no_grad():
        got = head.predict(*map(t, (hidden, boxes, text, tmask, qmask)))
    for g, w in zip(got, want):
        close(g, w)
    pts = rng.randn(B, Q, 3).astype(np.float32)
    for reg in (9, 12):
        pred = rng.randn(B, Q, reg).astype(np.float32)
        close(head.bbox_pred_to_bbox(t(pts), t(pred)),
              jh.bbox_pred_to_bbox(jnp.asarray(pts), jnp.asarray(pred)),
              err_msg=f'{reg} regression channels')


def test_rotation_pieces_match():
    rng = np.random.RandomState(10)
    x = rng.randn(4, 5, 3).astype(np.float32)
    y = rng.randn(4, 5, 3).astype(np.float32)
    jm = jrot.ortho_6d_to_matrix(jnp.asarray(x), jnp.asarray(y))
    tm = trot.ortho_6d_to_matrix(t(x), t(y))
    close(tm, jm)
    close(trot.matrix_to_euler_angles(tm), jrot.matrix_to_euler_angles(jm))
