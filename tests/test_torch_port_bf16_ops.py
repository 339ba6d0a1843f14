"""The port's plain bf16 sparse-conv versions against the TPU kernels.

The TPU kernels (proxytransformation_tpu/ops/sparse_conv_pallas.py) cast
features, weights and the output gradient to bf16 and sum in float32;
they run here in interpret mode, as tests/test_sparse_conv_pallas.py
runs them, at its shapes (B=2, 700 -> 300 voxels, sorted random maps)
and on real neighbor maps for the column-window and dW kernels. The port's plain
versions (`sparse_conv_apply_bf16`, `sparse_conv_dw_plain_bf16`, which
its CPU path runs and its bf16 kernels are held against on the card)
must compute the same function:

  * float32 inputs, float32 output: |port - pallas| <= 1e-5 (1 + max|pallas|)
    (the same exact bf16 products, float32 sums in another order);
  * bf16 inputs, bf16 output: the same dtype, and at most one bf16 ulp
    of the larger value apart, plus the float32 tolerance above (two
    roundings of float32 sums that differ in their last bits).

dW is float32 whatever the inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.ops.sparse import (
    _sparse_conv_pallas_ad, build_neighbor_map as jbuild_map,
    downsample_coords as jdownsample, voxelize_points as jvoxelize)
from proxytransformation_tpu.ops.sparse_conv_pallas import (
    sparse_conv_dw_gather_gemm, sparse_conv_gather_gemm,
    sparse_conv_gather_gemm_colwin)
from proxytransformation_torch.ops import sparse as sp

from test_torch_port_bf16_model import two_torch_threads  # noqa: F401

SHAPES = [(3, 7, 27), (16, 150, 27), (64, 64, 8), (40, 30, 1),
          (300, 520, 27)]
F32_RTOL = 1e-5


def _synthetic(rng, Ci, Co, K3, B=2, Vi=700, Vo=300, miss=0.4):
    """tests/test_sparse_conv_pallas.py::_synthetic, in numpy."""
    feats = rng.randn(B, Vi, Ci).astype(np.float32)
    nbr = np.sort(rng.randint(0, Vi, (B, Vo, K3)), axis=1).astype(np.int32)
    nbr = np.where(rng.rand(B, Vo, K3) < miss, -1, nbr).astype(np.int32)
    w = (rng.randn(K3, Ci, Co) * 0.1).astype(np.float32)
    mask = rng.rand(B, Vo) < 0.9
    return feats, nbr, w, mask


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def assert_f32_close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    want = _f32(want)
    err = np.abs(got.numpy() - want)
    assert err.max() <= F32_RTOL * (1.0 + np.abs(want).max()), err.max()


def assert_bf16_close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = got.float().numpy(), _f32(want)
    tol = (_bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
           + F32_RTOL * (1.0 + np.abs(w).max()))
    assert np.all(np.abs(g - w) <= tol), np.abs(g - w).max()


def _pair(feats, nbr, w, mask, dtype):
    """The same inputs for both sides: features in `dtype`."""
    jf = jnp.asarray(feats).astype(dtype)
    tf = torch.from_numpy(_f32(jf)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return ((jf, jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(mask)),
            (tf, torch.from_numpy(nbr), torch.from_numpy(w),
             torch.from_numpy(mask)))


@pytest.mark.parametrize('Ci,Co,K3', SHAPES)
def test_plain_bf16_conv_matches_gather_gemm(Ci, Co, K3):
    """`sparse_conv_apply_bf16` vs the one-window kernel on sorted random
    maps, float32 and bf16 features."""
    rng = np.random.RandomState(Ci + Co)
    feats, nbr, w, mask = _synthetic(rng, Ci, Co, K3)
    for dtype, check in ((jnp.float32, assert_f32_close),
                         (jnp.bfloat16, assert_bf16_close)):
        j, t = _pair(feats, nbr, w, mask, dtype)
        want = sparse_conv_gather_gemm(*j, interpret=True)
        assert want.dtype == dtype
        check(sp.sparse_conv_apply_bf16(*t), want)


def _real_maps(self_map: bool, kind: str = ''):
    """A voxelized cloud and its self (k3 s1) or strided (k3 s2) map; a
    k2 s2 map for kind 'k2', the strided map's center offset for
    'center'."""
    rng = np.random.RandomState(0)
    B, N = 2, 1500
    pts = jnp.asarray(rng.uniform(0, 2.0, (B, N, 3)).astype(np.float32))
    pmask = jnp.asarray(rng.rand(B, N) < 0.95)
    lvl = jvoxelize(pts, pmask, pts, voxel_size=0.05, capacity=1024,
                    extent=(64, 64, 64))
    out = lvl if self_map else jdownsample(lvl, 512)
    nbr = jbuild_map(lvl, out, kernel_size=2 if kind == 'k2' else 3,
                     stride=1 if self_map else 2)
    if kind == 'center':
        nbr = nbr[..., 13:14]
    return (np.asarray(lvl.mask), np.asarray(nbr).astype(np.int32),
            np.asarray(out.mask))


@pytest.mark.parametrize('self_map,Ci,Co', [(True, 48, 16), (False, 32, 48)])
def test_plain_bf16_conv_matches_colwin(self_map, Ci, Co):
    """`sparse_conv_apply_bf16` vs the column-window kernel (the one the
    TPU model path runs) on a real self map at an input gradient's
    widths (C_out < C_in) and on a real strided map."""
    in_mask, nbr, out_mask = _real_maps(self_map)
    rng = np.random.RandomState(1)
    feats = np.where(in_mask[..., None],
                     rng.randn(*in_mask.shape, Ci), 0).astype(np.float32)
    w = (rng.randn(27, Ci, Co) * 0.1).astype(np.float32)
    for dtype, check in ((jnp.float32, assert_f32_close),
                         (jnp.bfloat16, assert_bf16_close)):
        j, t = _pair(feats, nbr, w, out_mask, dtype)
        want = sparse_conv_gather_gemm_colwin(*j, interpret=True)
        assert want.dtype == dtype
        check(sp.sparse_conv_apply_bf16(*t), want)


@pytest.mark.parametrize('Ci,Co,kind', [(3, 7, 'self'), (16, 150, 'strided'),
                                         (64, 64, 'k2'), (40, 30, 'center'),
                                         (300, 520, 'self')])
def test_plain_bf16_dw_matches_dw_kernel(Ci, Co, kind):
    """`sparse_conv_dw_plain_bf16` vs the dW kernel at the widths above:
    float32 out from float32 and from bf16 features and gradients. The
    kernel scatters g rows by a one-hot and rounds that to bf16, exact
    only where each offset reads an input row once: the real maps of
    `build_neighbor_map` (self, strided, k2 and the strided map's center
    offset), not random ones."""
    in_mask, nbr, mask = _real_maps(kind == 'self', kind)
    rng = np.random.RandomState(Ci + Co + 1)
    feats = np.where(in_mask[..., None], rng.randn(*in_mask.shape, Ci),
                     0).astype(np.float32)
    g = np.where(mask[..., None], rng.randn(*mask.shape, Co),
                 0).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        jf, jg = jnp.asarray(feats).astype(dtype), jnp.asarray(g).astype(dtype)
        want = sparse_conv_dw_gather_gemm(jf, jnp.asarray(nbr), jg,
                                          jnp.asarray(mask), interpret=True)
        tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
        got = sp.sparse_conv_dw_plain_bf16(
            torch.from_numpy(_f32(jf)).to(tdt), torch.from_numpy(nbr),
            torch.from_numpy(_f32(jg)).to(tdt))
        assert_f32_close(got, want)


def test_conv_dispatch_takes_the_bf16_form_on_bf16_features():
    """On a CPU tensor the sparse conv, its input gradient and its dW
    dispatch on the features' dtype: bf16 features take the bf16 plain
    versions (bf16 out, bf16 dfeats, float32 dW), float32 features the
    float32 ones, unchanged."""
    in_mask, nbr, out_mask = _real_maps(True)
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(np.where(in_mask[..., None],
                                      rng.randn(*in_mask.shape, 16), 0)
                             .astype(np.float32))
    w = torch.from_numpy((rng.randn(27, 16, 24) * 0.1).astype(np.float32))
    tn, tm = torch.from_numpy(nbr), torch.from_numpy(out_mask)
    out32 = sp.sparse_conv(feats, tn, w, tm, self_map=True)
    assert torch.equal(out32, sp.sparse_conv_apply(feats, tn, w, tm))
    fb = feats.bfloat16().requires_grad_()
    wb = w.clone().requires_grad_()
    out = sp.sparse_conv(fb, tn, wb, tm, self_map=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, sp.sparse_conv_apply_bf16(fb, tn, w, tm))
    cot = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    (out.float() * cot).sum().backward()
    assert fb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.float32
    g = torch.where(tm[..., None], cot, 0).bfloat16()
    assert torch.equal(wb.grad, sp.sparse_conv_dw_plain_bf16(fb, tn, g))
    w_rev = w.transpose(1, 2).flip(0)
    assert torch.equal(fb.grad, sp.sparse_conv_apply_bf16(g, tn, w_rev, tm))


@pytest.mark.parametrize('self_map', [True, False])
def test_bf16_conv_backward_matches_tpu_path(self_map):
    """The port's conv autograd.Function on bf16 features (its plain bf16
    forward, dfeats and dW on a CPU tensor) against `jax.grad` of the JAX
    package's TPU-path custom_vjp (`_sparse_conv_pallas_ad`: mirrored
    weights for a self map, the reversed map for a strided one), its
    kernels in interpret mode, on a real map: the output and dfeats
    within one bf16 ulp, dW within the float32 tolerance."""
    in_mask, nbr, out_mask = _real_maps(self_map)
    rng = np.random.RandomState(3)
    feats = jnp.asarray(np.where(in_mask[..., None],
                                 rng.randn(*in_mask.shape, 16), 0)
                        .astype(np.float32)).astype(jnp.bfloat16)
    w = (rng.randn(27, 16, 24) * 0.1).astype(np.float32)
    cot = jnp.asarray(rng.randn(*out_mask.shape, 24).astype(np.float32)
                      ).astype(jnp.bfloat16)
    jn, jm = jnp.asarray(nbr), jnp.asarray(out_mask)

    def loss(f, k):
        out = _sparse_conv_pallas_ad(self_map, f, jn, k, jm)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(jnp.float32))

    want_out = _sparse_conv_pallas_ad(self_map, feats, jn, jnp.asarray(w), jm)
    want_df, want_dw = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        feats, jnp.asarray(w))
    tf = torch.from_numpy(_f32(feats)).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = sp.sparse_conv(tf, torch.from_numpy(nbr), tw,
                         torch.from_numpy(out_mask), self_map=self_map)
    (out.float() * torch.from_numpy(_f32(cot))).sum().backward()
    assert_bf16_close(out.detach(), want_out)
    assert_bf16_close(tf.grad, want_df)
    assert_f32_close(tw.grad, want_dw)
