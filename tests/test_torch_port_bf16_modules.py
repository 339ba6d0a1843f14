"""The port's bfloat16 modules against their JAX twins at dtype=bfloat16.

Each module runs on the same numpy inputs and the same weights on both
sides (the reference-layout state dict of tests/test_torch_port_models.py).
The JAX side compiles with `xla_allow_excess_precision` off: with it on
(XLA's default) the CPU compiler keeps some bfloat16 intermediates in
float32 (a bf16 dot followed by a cast to float32 is never rounded), so
it computes another function than the model states. Off, it rounds every
bfloat16 operation, as the port (and the TPU) does, and the two sides
differ only where float32 sums taken in another order round to
neighbouring bfloat16 values: single elements by one bfloat16 ulp.

Tolerances, each against the gap between the module's float32 and
bfloat16 outputs (measured in the same test), which it must sit well
under:
  * bfloat16 outputs: at most one bfloat16 ulp of the larger value, plus
    1e-5 of the output's largest magnitude (float32 sums that cancel);
  * float32 outputs of bfloat16 computations (a block's output, the
    preshape's points): `BF16_ATOL` of the largest magnitude, and the
    float32-vs-bfloat16 gap at least 20 times larger.
"""
from contextlib import nullcontext

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import lax as jax_lax_impl

from proxytransformation_tpu.models import decoder as jdec
from proxytransformation_tpu.models import grounding_head as jhead
from proxytransformation_tpu.models import preshape as jpre
from proxytransformation_tpu.models.resnet import ResNet as JResNet
from proxytransformation_tpu.models.sparse_resnet import MinkResNet as JMink
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.models import decoder as tdec
from proxytransformation_torch.models import grounding_head as thead
from proxytransformation_torch.models import layers as tlayers
from proxytransformation_torch.models import preshape as tpre
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder)
from proxytransformation_torch.models.resnet import ResNet as TResNet
from proxytransformation_torch.models.sparse_resnet import MinkResNet as TMink
from proxytransformation_torch.ops import sparse as tsp

from test_torch_port_bf16_model import (  # noqa: F401 (a fixture)
    tpu_conv_path, two_torch_threads)
from test_torch_port_models import (CAPS, EXTENT, jvars, n, sub, t,  # noqa
                                    weights)

BF16 = torch.bfloat16
BF16_ATOL = 1e-4
MINK_EQUAL = 0.99
EXACT = {'xla_allow_excess_precision': False}


def jit_exact(fn, *args):
    """`jax.jit(fn)(*args)` with every bfloat16 operation rounded."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def assert_bf16_close(got: torch.Tensor, want) -> None:
    """One bfloat16 ulp of the larger value, plus 1e-5 of the largest."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    g, w = f32(got), f32(want)
    tol = (bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
           + 1e-5 * np.abs(w).max())
    err = np.abs(g - w)
    assert np.all(err <= tol), (err.max(), int((err > tol).sum()))


def assert_under_gap(got, want, want_f32, what: str) -> float:
    """float32 outputs of bfloat16 computations: within BF16_ATOL of the
    largest magnitude, and the float32 model's output at least 20 times
    farther off. Returns the error."""
    g, w, w32 = f32(got), f32(want), f32(want_f32)
    scale = np.abs(w).max()
    err, gap = np.abs(g - w).max(), np.abs(w32 - w).max()
    assert err <= BF16_ATOL * scale, (what, err, scale)
    assert gap >= 20 * err, (what, err, gap)
    return err


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_dense_and_gelu_match_flax_in_bf16():
    """`layers.dense` in bfloat16 rounds like flax `nn.Dense(dtype=bf16)`
    (product, then bias), and `preshape.gelu` like jax.nn.gelu in
    bfloat16 (every operation rounded)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 7, 48).astype(np.float32)
    w = (rng.randn(48, 40) * 0.2).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    want = jit_exact(
        lambda v, x: fnn.Dense(40, dtype=jnp.bfloat16).apply(v, x),
        {'params': {'kernel': jnp.asarray(w), 'bias': jnp.asarray(b)}},
        jnp.asarray(x))
    got = tlayers.dense(t(x), t(w.T), t(b), BF16)
    assert_bf16_close(got, want)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jit_exact(lambda a: jax.nn.gelu(a, approximate=False), xb)
    got = tpre.gelu(torch.from_numpy(f32(xb)).to(BF16))
    assert_bf16_close(got, want)


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match='compute_dtype'):
        TGrounder(compute_dtype='float16', device='cpu')


# --------------------------------------------------------------------------
# the 2D ResNet-50
# --------------------------------------------------------------------------
def test_resnet50_bf16_matches(weights):
    sd, variables = weights
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    v = jvars(variables, 'backbone')
    want = jit_exact(lambda v, x: JResNet(depth=50, base_channels=4,
                                          dtype=jnp.bfloat16).apply(v, x),
                     v, jnp.asarray(x))
    port = TResNet(50, 4, BF16)
    port.load_state_dict(sub(sd, 'backbone.'))
    with torch.no_grad():
        got = port(t(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_bf16_close(g, w)


# --------------------------------------------------------------------------
# the preshape: a proxy block, the image pooling, the whole module
# --------------------------------------------------------------------------
KW = dict(embed_dim=16, num_heads=4, grid_size=4, text_blocks=1,
          img_blocks=1, dynamic_drop_radio=0.5, num_sub=8, input_dim=8,
          img_spacial_dim=2)


def test_preshape_block_and_pool_bf16_match(weights):
    """The text proxy block (qkv, two-stage attention, MLP with gelu) and
    the image attention pooling in bfloat16: float32 outputs."""
    sd, variables = weights
    jv = jvars(variables, 'preshape')
    port = tpre.ProxyTransformationNormReverse(**KW, dtype=BF16)
    port.load_state_dict(sub(sd, 'preshape.'))
    rng = np.random.RandomState(6)
    x = rng.randn(2, 32, 16).astype(np.float32)
    proxy = rng.randn(2, 5, 16).astype(np.float32)
    pmask = np.arange(5)[None].repeat(2, 0) < [[5], [3]]
    img = rng.randn(6, 2, 2, 8).astype(np.float32)
    for dt in (jnp.bfloat16, jnp.float32):
        block = jpre.ProxyBlock(16, 4, num_cluster=64, dynamic_drop_radio=0.5,
                                dtype=dt)
        blk = jit_exact(lambda v, *a: block.apply(v, *a),
                        {'params': jv['params']['textformer_0']},
                        *map(jnp.asarray, (x, proxy, pmask)))

        def pool(v, a, dt=dt):
            a = fnn.Dense(16, dtype=dt).apply(
                {'params': v['params']['channel_mapper']}, a.astype(dt))
            return jpre.AttentionPool2d(2, 16, 4, dtype=dt).apply(
                {'params': v['params']['attn_pool2d']}, a)

        pooled = jit_exact(pool, {'params': jv['params']}, jnp.asarray(img))
        if dt == jnp.bfloat16:
            want_blk, want_pool = blk, pooled
        else:
            f32_blk, f32_pool = blk, pooled
    with torch.no_grad():
        got_blk = port.textformer[0](t(x), t(proxy), t(pmask))
        img_b = t(img).to(BF16)
        got_pool = port.attn_pool2d(port.channel_mapper(img_b))
    assert got_blk.dtype == got_pool.dtype == torch.float32
    assert_under_gap(got_blk, want_blk, f32_blk, 'proxy block')
    assert_under_gap(got_pool, want_pool, f32_pool, 'attention pool')


class _KeepMasks:
    """Dropout keep masks from a seed, handed out in call order: JAX
    draws them through `jax.random.bernoulli` (flax's `nn.Dropout` and
    the package's `DropPath` both call it), the port through each
    `Dropout.draw`. Both sides then scale and select with their own code,
    so a scale of another dtype (JAX's weak typing divides a bfloat16
    array by bf16(0.8)) shows."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.masks = []

    def bernoulli(self, key, p=0.5, shape=None):
        self.masks.append(self.rng.rand(*shape) < p)
        return jnp.asarray(self.masks[-1])

    def install(self, port_module):
        queue = iter(self.masks)

        def draw(shape, device, generator):
            m = next(queue)
            assert m.shape == tuple(shape), (m.shape, shape)
            return torch.from_numpy(m)

        for mod in port_module.modules():
            if isinstance(mod, tpre.Dropout):
                mod.draw = draw
        return queue


def f32_reductions(monkeypatch):
    """JAX's autodiff sums a broadcast operand's cotangent (a bias's
    gradient) with a `reduce` in the operand's dtype, and XLA's CPU
    compiler adds a bfloat16 reduce's terms one by one in bfloat16; torch
    sums bfloat16 in float32 and rounds once. With this patch the JAX
    side sums in float32 too, so both compute the same function."""
    reduce_sum = jax_lax_impl.reduce_sum

    def f32_reduce_sum(x, axes):
        if x.dtype != jnp.bfloat16:
            return reduce_sum(x, axes)
        return reduce_sum(x.astype(jnp.float32), axes).astype(jnp.bfloat16)

    monkeypatch.setattr(jax_lax_impl, 'reduce_sum', f32_reduce_sum)


def _port_grads(variables, prefix, jgrads):
    """The JAX gradients of the preshape's submodules (a {name: params}
    dict) under the port's parameter names below `prefix`."""
    tree = jax.tree_util.tree_map(np.asarray, variables)
    tree['params']['preshape'].update(jgrads)
    return {k[len(prefix):]: v.numpy()
            for k, v in state_dict_from_jax(tree).items()
            if k.startswith(prefix)}


GRAD_ATOL = 1e-2      # of each gradient tensor's largest entry
GRAD_LOOSE = 3.0      # x the mean error of JAX's default-compiled module
GRAD_F32 = 0.5        # x the float32 module's mean error, median


def test_preshape_block_and_pool_bf16_train_grads_match(weights,
                                                        monkeypatch):
    """A proxy block in train mode (attention, projection and MLP dropout
    at the reference's 0.2, drop path 0.2 as the flagship's last block
    has) and the image pooling, in bfloat16, with the same keep masks on
    both sides, against JAX (`f32_reductions`):

      * the block's and the pool's float32 outputs as in eval mode
        (`assert_under_gap`; measured equal bit for bit);
      * fc2's weight and bias gradients bit for bit: their cotangent
        passes only the drop path, the float32 cast and dropout, whose
        bf16(0.8) scale shows here;
      * every other parameter and input gradient within `GRAD_ATOL` of
        its tensor's largest entry (measured at most 5.7e-3, fc1's bias).
        Further from the output, rounding differs: torch's bfloat16
        backward of gelu and softmax rounds once where JAX's CPU graph
        rounds each operation, and single one-ulp flips spread. So each
        tensor's mean error is held against two yardsticks: at most
        `GRAD_LOOSE` times that of the same JAX module compiled with
        XLA's default options (its bfloat16 rounded another way;
        measured up to 2.3 times), and over the block's tensors and
        inputs, the median of its ratio to the float32 module's error at
        most `GRAD_F32` (measured 0.28: the test tells bfloat16 from
        float32). The pool's gradients measured equal bit for bit."""
    f32_reductions(monkeypatch)
    sd, variables = weights
    jv = jvars(variables, 'preshape')
    rng = np.random.RandomState(9)
    B = 4
    x = rng.randn(B, 32, 16).astype(np.float32)
    proxy = rng.randn(B, 5, 16).astype(np.float32)
    pmask = np.arange(5)[None].repeat(B, 0) < [[5], [3], [4], [5]]
    img = rng.randn(6, 2, 2, 8).astype(np.float32)
    ct_blk = rng.randn(B, 32, 16).astype(np.float32)
    ct_pool = rng.randn(6, 16).astype(np.float32)
    pool_p = {k: jv['params'][k] for k in ('channel_mapper', 'attn_pool2d')}
    keep, want = {}, {}
    for key, dt, opts in (('bf16', jnp.bfloat16, EXACT),
                          ('loose', jnp.bfloat16, {}),
                          ('f32', jnp.float32, EXACT)):
        keep[key] = _KeepMasks(seed=10)
        monkeypatch.setattr(jax.random, 'bernoulli', keep[key].bernoulli)
        block = jpre.ProxyBlock(16, 4, drop=0.2, attn_drop=0.2,
                                drop_path=0.2, num_cluster=64,
                                dynamic_drop_radio=0.5, dtype=dt)

        def blk_loss(p, x, proxy, m, ct, block=block):
            out = block.apply({'params': p}, x, proxy, m,
                              deterministic=False,
                              rngs={'dropout': jax.random.PRNGKey(0)})
            return jnp.sum(out * ct), out

        def pool_loss(p, a, ct, dt=dt):
            a = fnn.Dense(16, dtype=dt).apply(
                {'params': p['channel_mapper']}, a.astype(dt))
            out = jpre.AttentionPool2d(2, 16, 4, dtype=dt).apply(
                {'params': p['attn_pool2d']}, a)
            return jnp.sum(out * ct), out

        def run(fn, *args, opts=opts):
            fn = jax.jit(jax.value_and_grad(fn, argnums=tuple(
                range(len(args) - 1 - (fn is blk_loss))), has_aux=True))
            return fn.lower(*args).compile(compiler_options=opts)(*args)

        (_, blk), blk_g = run(blk_loss, jv['params']['textformer_0'],
                              *map(jnp.asarray, (x, proxy, pmask, ct_blk)))
        (_, pooled), pool_g = run(pool_loss, pool_p,
                                  *map(jnp.asarray, (img, ct_pool)))
        want[key] = dict(
            blk=blk, pool=pooled, dx=f32(blk_g[1]), dproxy=f32(blk_g[2]),
            dimg=f32(pool_g[1]),
            **_port_grads(variables, 'preshape.textformer.0.',
                          {'textformer_0': blk_g[0]}),
            **_port_grads(variables, 'preshape.', pool_g[0]))
    masks = keep['bf16'].masks
    assert len(masks) == 7   # 3 in the attention, 2 in the MLP, 2 paths
    for k in ('loose', 'f32'):
        assert all(np.array_equal(a, b) for a, b in zip(masks,
                                                        keep[k].masks))
    assert not all(m.all() for m in masks[3::3])   # a path dropped

    port = tpre.ProxyTransformationNormReverse(**KW, dtype=BF16)
    port.load_state_dict(sub(sd, 'preshape.'))
    block = tpre.ProxyBlock(16, 4, 64, 0.5, drop_path=0.2, dtype=BF16)
    block.load_state_dict(sub(sd, 'preshape.textformer.0.'))
    left = keep['bf16'].install(block)
    tx, tproxy, timg = (t(a).requires_grad_() for a in (x, proxy, img))
    got_blk = block(tx, tproxy, t(pmask), train=True)
    assert next(left, None) is None
    got_pool = port.attn_pool2d(port.channel_mapper(timg.to(BF16)))
    assert got_blk.dtype == got_pool.dtype == torch.float32
    ((got_blk * t(ct_blk)).sum() + (got_pool * t(ct_pool)).sum()).backward()

    w, loose, w32 = want['bf16'], want['loose'], want['f32']
    assert_under_gap(got_blk, w['blk'], w32['blk'], 'train block')
    assert_under_gap(got_pool, w['pool'], w32['pool'], 'pool')
    got = {'dx': tx.grad, 'dproxy': tproxy.grad, 'dimg': timg.grad,
           **{f'attn_pool2d.{k}': p.grad
              for k, p in port.attn_pool2d.named_parameters()},
           **{f'channel_mapper.{k}': p.grad
              for k, p in port.channel_mapper.named_parameters()},
           **{k: p.grad for k, p in block.named_parameters()}}
    assert len(got) == 3 + 9 + 2 + 16   # inputs, pool, mapper, block
    for k in ('mlp.fc2.weight', 'mlp.fc2.bias'):
        np.testing.assert_array_equal(got[k].numpy(), w[k], err_msg=k)
    ratios = {}
    for k, g in got.items():
        g, v = g.numpy(), w[k]
        scale = np.abs(v).max()
        assert scale > 0, k
        assert np.abs(g - v).max() <= GRAD_ATOL * scale, (k, scale)
        err = np.abs(g - v).mean()
        assert err <= GRAD_LOOSE * np.abs(loose[k] - v).mean(), k
        if k in dict(block.named_parameters()) or k in ('dx', 'dproxy'):
            ratios[k] = err / np.abs(w32[k] - v).mean()
    print('mean gradient error over the float32 module\'s:', ratios)
    assert np.median(list(ratios.values())) <= GRAD_F32, ratios


def test_preshape_forward_bf16_matches(weights):
    """The whole preshape in bfloat16: the same dropped clusters (mask),
    the same moved points, the moved values within float32 rounding of
    JAX's bfloat16 module (its geometry is float32)."""
    sd, variables = weights
    jv = jvars(variables, 'preshape')
    port = tpre.ProxyTransformationNormReverse(**KW, dtype=BF16)
    port.load_state_dict(sub(sd, 'preshape.'))
    rng = np.random.RandomState(3)
    B, N = 2, 2000
    pts = rng.uniform(0, 12.0, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, -300:] = False
    text = rng.randn(B, 6, 16).astype(np.float32)
    tmask = np.arange(6)[None].repeat(B, 0) < [[4], [6]]
    img = rng.randn(B, 3, 2, 2, 8).astype(np.float32)
    args = (pts, mask, text, tmask, img)
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        jmod = jpre.ProxyTransformationNormReverse(n_points=N, **KW, dtype=dt)
        outs[dt] = jit_exact(lambda v, *a: jmod.apply(v, *a, train=False),
                             jv, *map(jnp.asarray, args))
    (jp, jm), (jp32, _) = outs[jnp.bfloat16], outs[jnp.float32]
    with torch.no_grad():
        tp, tm = port(*map(t, args[:4]), t(img).to(BF16))
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    moved = np.any(np.asarray(jp) != pts, axis=-1)
    assert moved.sum() > 100
    np.testing.assert_array_equal(np.any(n(tp) != pts, axis=-1), moved)
    assert_under_gap(tp, jp, jp32, 'preshape points')


# --------------------------------------------------------------------------
# MinkResNet on tiny levels
# --------------------------------------------------------------------------
def test_minkresnet_bf16_levels_match(weights):
    """Stem in float32, stages in bfloat16 (the bf16 conv form; JAX on its
    TPU conv path, `tpu_conv_path`): every level's keys and maps bit for
    bit, features bfloat16. A one-ulp difference of two float32 sums
    taken in another order feeds every later conv, so the share of valid
    entries that differ grows from level to level (measured 0.3, 4.9,
    21% at levels 0-2): level 0 must be equal bit for bit in at least
    `MINK_EQUAL` of its entries, and every level in at least 0.1 more
    of them than the float32 model (rounded to bfloat16) is."""
    sd, variables = weights
    jv = jvars(variables, 'backbone_3d')
    rng = np.random.RandomState(4)
    pts = rng.uniform(0, 3.0, (2, 1024, 3)).astype(np.float32)
    mask = np.ones((2, 1024), bool)
    mask[0, -100:] = False
    jl0 = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(pts), voxel_size=0.05,
                              capacity=1024, extent=EXTENT)
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        with tpu_conv_path() if dt == jnp.bfloat16 else nullcontext():
            outs[dt] = jit_exact(
                lambda v, l, dt=dt: JMink(depth=14, capacities=CAPS, dtype=dt)
                .apply(v, l, return_self_maps=True), jv, jl0)
    port = TMink(14, 3, CAPS, BF16)
    port.load_state_dict(sub(sd, 'backbone_3d.'))
    tl0 = tsp.voxelize_points(t(pts), t(mask), t(pts), 0.05, 1024, EXTENT)
    with torch.no_grad():
        touts, tmaps, _ = port(tl0)
    (jouts, jmaps), (jouts32, _) = outs[jnp.bfloat16], outs[jnp.float32]
    shares = []
    for jl, tl, jm, tm, j32 in zip(jouts, touts, jmaps, tmaps, jouts32):
        for f in ('keys', 'coords', 'mask'):
            np.testing.assert_array_equal(n(getattr(tl, f)),
                                          np.asarray(getattr(jl, f)))
        np.testing.assert_array_equal(n(tm), np.asarray(jm))
        valid = n(tl.mask)
        assert valid.sum() > 0 and tl.feats.dtype == BF16
        w = f32(jl.feats)[valid]
        equal = np.mean(f32(tl.feats)[valid] == w)
        equal32 = np.mean(f32(jnp.asarray(j32.feats).astype(jnp.bfloat16))
                          [valid] == w)
        shares.append((equal, equal32))
    print('bit-equal share per level (port, float32 model):', shares)
    assert shares[0][0] >= MINK_EQUAL
    assert all(e >= e32 + 0.1 for e, e32 in shares), shares


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------
def test_decoder_bf16_matches(weights):
    """Two decoder layers in bfloat16 over bfloat16 queries and voxel
    tokens (as the neck hands them over): float32 hidden states and
    boxes."""
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
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        def jrun(v, *a, dt=dt):
            return jdec.SparseFeatureFusionTransformerDecoder(
                num_layers=2, embed_dims=D, num_heads=4,
                feedforward_channels=32, dtype=dt).apply(
                    v, a[0].astype(dt), a[1].astype(dt), ~a[2], a[3], a[4],
                    a[5], a[6], ~a[7],
                    reg_branch_fn=lambda q, lid=None: reg.apply(
                        {'params': head_p['reg_branch']}, q),
                    bbox_coder_fn=coder.bbox_pred_to_bbox,
                    feats_mask=a[2], query_mask=a[8])
        args = (query, feats, fmask, qcoords, fcoords, boxes, text, tmask,
                qmask)
        outs[dt] = jit_exact(jrun, jvars(variables, 'decoder'),
                             *map(jnp.asarray, args))
    port = tdec.SparseFeatureFusionTransformerDecoder(2, D, 4, 32, BF16)
    port.load_state_dict(sub(sd, 'decoder.'))
    head = thead.GroundingHead(D, 9, 64)
    head.load_state_dict(sub(sd, 'bbox_head.'))
    ta = list(map(t, args))
    with torch.no_grad():
        th, tb = port(ta[0].to(BF16), ta[1].to(BF16), ~ta[2], ta[3], ta[4],
                      ta[5], ta[6], ~ta[7],
                      reg_branch_fn=head.reg_branches[0],
                      bbox_coder_fn=head.bbox_pred_to_bbox, feats_mask=ta[2],
                      query_mask=ta[8])
    assert th.dtype == tb.dtype == torch.float32
    (jh, jb), (jh32, jb32) = outs[jnp.bfloat16], outs[jnp.float32]
    assert_under_gap(th, jh, jh32, 'hidden')
    assert_under_gap(tb, jb, jb32, 'boxes')
