"""The port's whole MinkResNet against the JAX package's, on the CPU.

MinkResNet-50 (bottleneck blocks) and the batch-norm stem, in eval and in
train mode with parameter gradients; depth 101's parameters; the 2x2x2
brick format (pack / unpack, the brick conv and its gradients, and a
backbone with brick stages) at the sizes of tests/test_brick.py.

Weights come from the JAX module's `init` with its norms' parameters and
running statistics drawn anew from a seed (flax's fresh statistics make
every eval output 0), carried to the port by `state_dict_from_jax`.
Tolerances: integer coordinates, keys and maps bit for bit; features
within 1e-5 · (1 + max|ref|) (float32 sums in another order); gradients
within 1e-3 of each tensor's largest entry.

The parameter gradients of MinkResNet-50 are held on its first stage
(every kind of bottleneck block: the strided one with its downsample and
the self ones) over a cloud of 1000 points a sample, where they agree to
~1e-6. Over all four stages, or over 4000 points, float32 rounding moves
a few of the millions of pre-activations across a ReLU's kink, and each
such flip moves weight gradients by up to a per cent (the function's
gradient is discontinuous there), so the whole depth is held on its
forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.models.sparse_resnet import MinkResNet as JMink
from proxytransformation_tpu.ops import brick as jbrick
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.models.sparse_resnet import MinkResNet as TMink
from proxytransformation_torch.ops import brick as tbrick
from proxytransformation_torch.ops import sparse as tsp

from test_torch_port_runtime_engine import two_threads  # noqa: F401

# no level drops a voxel, and the deepest stage holds ~900 (train-mode
# norms over a few dozen rows amplify float32 rounding tenfold)
CAPS = (4096, 4096, 4096, 4096, 4096, 1024)
EXTENT = (512, 512, 512)


@pytest.fixture(autouse=True)
def _threads(two_threads):  # noqa: F811
    yield


def t(a):
    return torch.from_numpy(np.array(a))


def feat_close(got, want, what=''):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()),
                               err_msg=what)


def grad_close(got, want, what=''):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-3 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def level0(seed=4, B=2, n=4000, span=5.12, voxel=0.01):
    """The same voxelized cloud on both sides (a ragged batch)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, span, (B, n, 3)).astype(np.float32)
    mask = np.ones((B, n), bool)
    mask[1, n * 3 // 4:] = False
    jl0 = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(pts), voxel_size=voxel,
                              capacity=CAPS[0], extent=EXTENT)
    tl0 = tsp.voxelize_points(t(pts), t(mask), t(pts), voxel, CAPS[0],
                              EXTENT)
    return jl0, tl0


def jax_variables(model, jl0, seed=1):
    """The shapes of `model.init`, drawn from `seed` (numpy): sparse conv
    kernels normal with variance 2 / fan_out (flax's law, untruncated),
    norm scales, biases and running statistics around 1, 0, 0 and 1."""
    shapes = jax.eval_shape(lambda k, lv: model.init(k, lv, train=False),
                            jax.random.PRNGKey(0), jl0)
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = jax.tree_util.keystr(path[-1:])
        if 'kernel' in leaf:
            fan_out = int(np.prod(a.shape)) // a.shape[-2]
            return (rng.randn(*a.shape) * np.sqrt(2.0 / fan_out)).astype(
                np.float32)
        if 'scale' in leaf or 'var' in leaf:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_backbone(variables, depth, **kw):
    model = TMink(depth, 3, CAPS, **kw)
    sd = state_dict_from_jax({
        'params': {'backbone_3d': variables['params']},
        'batch_stats': {'backbone_3d': variables.get('batch_stats', {})}})
    model.load_state_dict({k[len('backbone_3d.'):]: v for k, v in sd.items()})
    return model


def cotangents(outs, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.feats.shape).astype(np.float32) for o in outs]


def jax_both_modes(depth, norm):
    """One jitted call: the JAX backbone's eval outputs, and its train
    outputs with the updated running statistics."""
    jl0, tl0 = level0()
    jm = JMink(depth=depth, capacities=CAPS, norm=norm)
    variables = jax_variables(jm, jl0)

    def both(v, lv):
        return (jm.apply(v, lv, train=False),
                jm.apply(v, lv, train=True, mutable=['batch_stats']))
    (ev, (tr, stats)) = jax.jit(both)(variables, jl0)
    return dict(variables=variables, tl0=tl0, eval=ev, train=tr,
                stats=stats['batch_stats'])


@pytest.fixture(scope='module')
def mink50():
    return jax_both_modes(50, 'instance')


@pytest.fixture(scope='module')
def bn_stem():
    """MinkResNet-14 with the batch-norm stem over 1000 points a sample:
    the JAX eval outputs, and the train-mode outputs, statistics and
    parameter gradients of a seeded cotangent, from one jit."""
    jl0, tl0 = level0(n=1000, span=2.56)
    jm = JMink(depth=14, capacities=CAPS, norm='batch')
    variables = jax_variables(jm, jl0)
    port = port_backbone(variables, 14, norm='batch')
    with torch.no_grad():
        cots = cotangents(port(tl0)[0])

    def loss(params, stats, lv):
        outs, new = jm.apply({'params': params, 'batch_stats': stats},
                             lv, train=True, mutable=['batch_stats'])
        return sum(jnp.sum(o.feats * c) for o, c in
                   zip(outs, cots)), (outs, new['batch_stats'])

    def both(v, lv):
        return (jm.apply(v, lv), jax.value_and_grad(loss, has_aux=True)(
            v['params'], v['batch_stats'], lv))
    ev, ((_, (tr, stats)), grads) = jax.jit(both)(variables, jl0)
    return dict(variables=variables, tl0=tl0, eval=ev, train=tr,
                stats=stats, grads=grads, cots=cots)


def port_outputs(ref, depth, norm, train):
    port = port_backbone(ref['variables'], depth, norm=norm)
    with torch.no_grad():
        touts, _, _ = port(ref['tl0'], train=train)
    return port, touts


def check_stats(port, ref):
    """The port's running statistics after a train-mode forward against
    the JAX package's updated ones."""
    sd = port.state_dict()
    want = state_dict_from_jax({
        'params': {'backbone_3d': ref['variables']['params']},
        'batch_stats': {'backbone_3d': ref['stats']}})
    names = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    for k in names:
        feat_close(sd[k[len('backbone_3d.'):]], want[k].numpy(), k)
    return len(names)


def run_grads(depth, norm, **kw):
    """(JAX stage levels, port stage levels, JAX param grads, port module,
    updated JAX batch stats) of a train-mode forward and the backward of
    a seeded cotangent on every stage, over 1000 points a sample."""
    jl0, tl0 = level0(n=1000, span=2.56)
    jm = JMink(depth=depth, capacities=CAPS, norm=norm, **kw)
    variables = jax_variables(jm, jl0)
    port = port_backbone(variables, depth, norm=norm, **kw)

    def loss(params, stats, lv, cots):
        outs, new = jm.apply({'params': params, 'batch_stats': stats},
                             lv, train=True, mutable=['batch_stats'])
        return sum(jnp.sum(o.feats * c) for o, c in
                   zip(outs, cots)), (outs, new['batch_stats'])
    touts, _, _ = port(tl0, train=True)
    cots = cotangents(touts)
    (_, (jouts, jstats)), jgrads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(
            variables['params'], variables['batch_stats'], jl0, cots)
    sum((o.feats * t(c)).sum() for o, c in zip(touts, cots)).backward()
    return jouts, touts, jgrads, port, jstats


def check_levels(jouts, touts):
    assert len(jouts) == len(touts)
    for i, (jl, tl) in enumerate(zip(jouts, touts)):
        for f in ('keys', 'coords', 'mask'):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)),
                                          err_msg=f'stage {i} {f}')
        assert tl.stride == jl.stride and int(tl.mask.sum()) > 8
        assert float(np.abs(np.asarray(jl.feats)).max()) > 0
        feat_close(tl.feats, jl.feats, f'stage {i}')


def check_grads(port, jgrads, jstats):
    tree = state_dict_from_jax({'params': {'backbone_3d': jgrads},
                                'batch_stats': {'backbone_3d': jstats}})
    want = {k[len('backbone_3d.'):]: v for k, v in tree.items()}
    n = 0
    for name, p in port.named_parameters():
        grad_close(p.grad, want[name].numpy(), name)
        n += 1
    assert n == len([k for k in want if not k.endswith('running_mean')
                     and not k.endswith('running_var')])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_minkresnet50_matches_jax(mink50, train):
    port, touts = port_outputs(mink50, 50, 'instance', train)
    check_levels(mink50['train' if train else 'eval'], touts)
    assert [tl.feats.shape[-1] for tl in touts] == [256, 512, 1024, 2048]
    if train:
        assert check_stats(port, mink50) == 2 * (16 * 3 + 4)


def test_minkresnet50_gradients_match_jax():
    """Parameter gradients of a depth-50 first stage in train mode."""
    jouts, touts, jgrads, port, jstats = run_grads(50, 'instance',
                                                   num_stages=1)
    check_levels(jouts, touts)
    check_grads(port, jgrads, jstats)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batchnorm_stem_matches_jax(bn_stem, train):
    port, touts = port_outputs(bn_stem, 14, 'batch', train)
    check_levels(bn_stem['train' if train else 'eval'], touts)
    assert 'norm1.bn.running_var' in port.state_dict()
    if train:
        assert check_stats(port, bn_stem) == 2 * (4 * 2 + 4 + 1)


def test_batchnorm_stem_gradients_match_jax(bn_stem):
    port = port_backbone(bn_stem['variables'], 14, norm='batch')
    touts, _, _ = port(bn_stem['tl0'], train=True)
    sum((o.feats * t(c)).sum()
        for o, c in zip(touts, bn_stem['cots'])).backward()
    check_grads(port, bn_stem['grads'], bn_stem['stats'])


def test_minkresnet101_loads_the_jax_tree():
    jl0, tl0 = level0(n=300)
    jm = JMink(depth=101, capacities=CAPS, norm='batch')
    variables = jax_variables(jm, jl0)
    port = port_backbone(variables, 101, norm='batch')   # strict load
    assert [len(getattr(port, f'layer{i}')) for i in range(1, 5)] == \
        [3, 4, 23, 3]
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables['params']))


def test_depth_and_norm_are_checked():
    with pytest.raises(ValueError, match='depth'):
        TMink(26)
    with pytest.raises(ValueError, match='norm'):
        TMink(14, norm='group')


# --------------------------------------------------------------------------
# the brick format (the sizes of tests/test_brick.py)
# --------------------------------------------------------------------------
def toy_level(seed=0, B=2, n=400, cap=256, C=8):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0, 0.14, (B, n, 3)).astype(np.float32)
    mask = np.ones((B, n), bool)
    mask[1, n // 2:] = False
    feats = rng.randn(B, cap, C).astype(np.float32)
    jl = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                             jnp.asarray(pts), voxel_size=0.01, capacity=cap,
                             extent=(16, 16, 16))
    tl = tsp.voxelize_points(t(pts), t(mask), t(pts), 0.01, cap, (16, 16, 16))
    feats = np.where(np.asarray(jl.mask)[..., None], feats, 0.0)
    return (jl._replace(feats=jnp.asarray(feats)),
            tl._replace(feats=t(feats)))


def test_brick_level_pack_unpack_bit_exact():
    jl, tl = toy_level()
    jb = jbrick.build_brick_level(jl, 200)
    tb = tbrick.build_brick_level(tl, 200)
    for f in ('keys', 'coords', 'mask'):
        np.testing.assert_array_equal(getattr(tb[0], f).numpy(),
                                      np.asarray(getattr(jb[0], f)))
    for j, tt in zip(jb[1:], tb[1:]):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(j))
    want = jbrick.brick_pack(jl.feats, jb[1], jb[2], jb[0].mask, jl.mask)
    got = tbrick.brick_pack(tl.feats, tb[1], tb[2], tb[0].mask, tl.mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tbrick.brick_unpack(got, tb[1], tb[2], tb[0].mask, tl.mask)
    np.testing.assert_array_equal(back.numpy(), tl.feats.numpy())
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbrick.brick_unpack(
            want, jb[1], jb[2], jb[0].mask, jl.mask)))
    assert int(tb[3].sum()) == int(tl.mask.sum())


def test_brick_expand_bit_exact():
    w = np.random.RandomState(2).randn(27, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tbrick.brick_expand(t(w)).numpy(),
        np.asarray(jbrick.brick_expand(jnp.asarray(w))))


def test_brick_conv_and_gradients_match_jax():
    """The brick conv of a packed level and its gradients against the
    JAX package's (which tests/test_brick.py holds to the cell conv)."""
    jl, tl = toy_level(seed=3, C=4)
    rng = np.random.RandomState(4)
    w = (rng.randn(27, 4, 4) / 10).astype(np.float32)
    cot = np.where(np.asarray(jl.mask)[..., None],
                   rng.randn(*jl.feats.shape), 0.0).astype(np.float32)
    jb = jbrick.build_brick_level(jl, 200)
    jbn = jsp.build_neighbor_map(jb[0], jb[0], 3, 1)
    tb = tbrick.build_brick_level(tl, 200)
    tbn = tsp.build_neighbor_map(tb[0], tb[0], 3, 1)
    np.testing.assert_array_equal(tbn.numpy(), np.asarray(jbn))

    def jloss(f, ww):
        bf = jbrick.brick_pack(f, jb[1], jb[2], jb[0].mask, jl.mask)
        bo = jsp.sparse_conv_apply(bf, jbn, jbrick.brick_expand(ww),
                                   jb[0].mask)
        return jnp.sum(jbrick.brick_unpack(bo, jb[1], jb[2], jb[0].mask,
                                           jl.mask) * cot)

    jgf, jgw = jax.grad(jloss, argnums=(0, 1))(jl.feats, jnp.asarray(w))
    f = tl.feats.clone().requires_grad_()
    ww = t(w).requires_grad_()
    bf = tbrick.brick_pack(f, tb[1], tb[2], tb[0].mask, tl.mask)
    bo = tsp.sparse_conv(bf, tbn, tbrick.brick_expand(ww), tb[0].mask,
                         self_map=True)
    out = tbrick.brick_unpack(bo, tb[1], tb[2], tb[0].mask, tl.mask)
    (out * t(cot)).sum().backward()
    want = jsp.sparse_conv_apply(
        jl.feats, jsp.build_neighbor_map(jl, jl, 3, 1), jnp.asarray(w),
        jl.mask)
    feat_close(out, want, 'brick conv vs the cell conv')
    grad_close(f.grad, jgf, 'dfeats')
    grad_close(ww.grad, jgw, 'dW')


@pytest.fixture(scope='module')
def brick_backbone():
    """tests/test_brick.py's cloud and capacities: the JAX brick backbone
    (MinkResNet-14, brick_stages=(0, 1)) in eval mode, the port's brick
    and cell backbones on the same weights."""
    rng = np.random.RandomState(5)
    B, n = 2, 2000
    pts = rng.uniform(0, 0.6, (B, n, 3)).astype(np.float32)
    mask = np.ones((B, n), bool)
    mask[1, 1500:] = False
    caps = (2048, 2048, 1024, 512, 256, 128)
    jl0 = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(pts), voxel_size=0.01,
                              capacity=caps[0], extent=(64, 64, 64))
    tl0 = tsp.voxelize_points(t(pts), t(mask), t(pts), 0.01, caps[0],
                              (64, 64, 64))
    jm = JMink(depth=14, capacities=caps, brick_stages=(0, 1))
    variables = jax_variables(jm, jl0)
    ev = jax.jit(lambda v, lv: jm.apply(v, lv))(variables, jl0)
    sd = state_dict_from_jax({
        'params': {'backbone_3d': variables['params']},
        'batch_stats': {'backbone_3d': variables['batch_stats']}})
    sd = {k[len('backbone_3d.'):]: v for k, v in sd.items()}
    port, cell = (TMink(14, 3, caps, brick_stages=b) for b in ((0, 1), ()))
    port.load_state_dict(sd)
    cell.load_state_dict(sd)
    return dict(eval=ev, port=port, cell=cell, tl0=tl0)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_brick_backbone_matches_jax(brick_backbone, train):
    """MinkResNet-14 with brick_stages=(0, 1): in eval mode against the
    JAX brick backbone within 1e-5 · (1 + max); in train mode against the
    port's cell format (which the tests above hold to JAX) within
    tests/test_brick.py's 1e-3 (rtol and atol), as that file holds the JAX
    brick stages to its cell stages: this cloud's deepest stage holds one
    voxel a sample, and a train-mode norm over two rows a and b scales
    float32 rounding by 1 / |a - b|."""
    port = brick_backbone['port']
    assert port.brick_stages == (0, 1)
    with torch.no_grad():
        touts, maps, plans = port(brick_backbone['tl0'], train=train)
        ref = (brick_backbone['cell'](brick_backbone['tl0'], train=True)[0]
               if train else brick_backbone['eval'])
    assert maps[0] is None and maps[1] is None and maps[2] is not None
    assert plans[0] is None and plans[3] is not None
    for i, (rl, tl) in enumerate(zip(ref, touts)):
        want = np.asarray(rl.feats)
        np.testing.assert_array_equal(tl.keys.numpy(), np.asarray(rl.keys))
        assert float(np.abs(want).max()) > 0
        if train:
            np.testing.assert_allclose(tl.feats.numpy(), want, rtol=1e-3,
                                       atol=1e-3, err_msg=f'stage {i}')
        else:
            feat_close(tl.feats, want, f'stage {i}')


@pytest.mark.parametrize('C_in,C_out', [(512, 512), (1024, 1024), (64, 512),
                                        (128, 1024), (512, 64), (1024, 128)])
def test_bf16_launch_at_brick_widths(C_in, C_out):
    """`bf16_tile_launch` at the brick stages' widths (the 8C convs, pack
    and unpack): 64-channel stages, 256 output channels a block and a
    column block for each further 256, the ring within a block's shared
    memory."""
    cut = tsp.bf16_tile_launch(2, 12000, C_in, C_out, 132)
    assert cut.kc == 64
    assert cut.bn == min(C_out, 256)
    assert cut.col_blocks == -(-C_out // cut.bn)
    assert cut.smem <= tsp.SMEM_PER_BLOCK
