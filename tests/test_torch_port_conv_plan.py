"""The sparse-conv plan (`ops/sparse.py::conv_plan`) on real maps.

The plan is what the Hopper kernels read beside a neighbor map: each
row's hit mask, the rows sorted by it, and each offset's compacted hit
list. On the CPU the plain convs do not read it, so these tests hold the
plan to its definition and run, in plain PyTorch, the computation the
kernels do with it: mask-sorted tiles that skip the offsets no row of
the tile hits (optionally cut into offset splits added in order), written
back to the original rows; and dW over each offset's hits only, in the
kernel's splits. Both must equal `sparse_conv_apply` /
`sparse_conv_dw_plain` within 1e-4 * (1 + max|plain|) (float32 sums in
another order), and the tiled conv the JAX package's conv too.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_torch.data.synthetic import surface_scene_batch
from proxytransformation_torch.ops import sparse as sp

CONV_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _maps():
    """Self, strided and pool maps of a seeded surface scene, with their
    input and output levels."""
    pts = torch.from_numpy(surface_scene_batch(2, 6000, seed=3)
                           * np.float32(0.4))
    mask = torch.ones(2, 6000, dtype=torch.bool)
    mask[1, -500:] = False
    l0 = sp.voxelize_points(pts, mask, pts, 0.02, 4000, (256, 256, 128))
    l1 = sp.downsample_coords(l0, 2500)
    return {
        'self_k27': (l0, l0, sp.build_neighbor_map(l0, l0, 3, 1)),
        'strided_k27': (l0, l1, sp.build_neighbor_map(l0, l1, 3, 2)),
        'pool_k8': (l0, l1, sp.build_neighbor_map(l0, l1, 2, 2)),
        'self_coarse_k27': (l1, l1, sp.build_neighbor_map(l1, l1, 3, 1)),
    }


MAPS = ['self_k27', 'strided_k27', 'pool_k8', 'self_coarse_k27']


def _close(got, want):
    tol = CONV_RTOL * (1.0 + float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize('name', MAPS)
def test_order_is_a_mask_sorted_permutation(name):
    _, _, nbr = _maps()[name]
    plan = sp.conv_plan(nbr)
    B, V, K3 = nbr.shape
    assert plan.row_mask.dtype == plan.order.dtype == torch.int32
    bits = (nbr >= 0).long() << torch.arange(K3)
    assert torch.equal(plan.row_mask.long(), bits.sum(-1))
    for b in range(B):
        o = plan.order[b].long()
        assert torch.equal(torch.sort(o).values, torch.arange(V))
        m = plan.row_mask[b, o]
        assert bool((m[1:] >= m[:-1]).all())
        # stable: rows of one mask keep their order
        same = m[1:] == m[:-1]
        assert bool((o[1:][same] > o[:-1][same]).all())
    assert int((plan.row_mask != 0).sum()) > 100


@pytest.mark.parametrize('name', MAPS)
def test_hit_lists_hold_each_offsets_hits_in_row_order(name):
    _, _, nbr = _maps()[name]
    plan = sp.conv_plan(nbr)
    B, V, K3 = nbr.shape
    assert plan.hits.shape == (K3, B * V) and plan.hits.is_contiguous()
    hit = (nbr >= 0).reshape(B * V, K3)
    for k in range(K3):
        rows = torch.arange(B * V, dtype=torch.int32)[hit[:, k]]
        n = int(plan.hit_counts[k])
        assert n == len(rows)
        assert torch.equal(plan.hits[k, :n], rows)
        assert bool((plan.hits[k, n:] == -1).all())
    assert int(plan.hit_counts.sum()) == int(hit.sum())


def _or(values):
    return functools.reduce(lambda a, b: a | b, values, 0)


def tiled_conv(feats, nbr, w, out_mask, plan, rows, splits=1):
    """`csrc/sparse_conv.cu`'s tile path in plain PyTorch: tiles of
    `rows` mask-sorted rows, only the offsets in the OR of the kept rows'
    masks, (offset, 16-channel) steps cut into `splits` ranges whose
    partial outputs are added in order, rows written back in place."""
    B, V, K3 = nbr.shape
    C_in, C_out = w.shape[1:]
    parts = torch.zeros(splits, B, V, C_out)
    n_c = -(-C_in // sp.CONV_STEP_C)
    for b in range(B):
        for t0 in range(0, V, rows):
            tile = plan.order[b, t0:t0 + rows].long()
            keep = out_mask[b, tile]
            active = _or(plan.row_mask[b, tile][keep].tolist())
            ks = [k for k in range(K3) if active >> k & 1]
            steps = [(k, c) for k in ks for c in range(n_c)]
            for s in range(splits):
                acc = torch.zeros(len(tile), C_out)
                lo = len(steps) * s // splits
                hi = len(steps) * (s + 1) // splits
                for k, c in steps[lo:hi]:
                    idx = torch.where(keep, nbr[b, tile, k], -1)
                    cs = slice(sp.CONV_STEP_C * c, sp.CONV_STEP_C * (c + 1))
                    g = feats[b, idx.clamp(min=0).long(), cs]
                    g = torch.where(idx[:, None] >= 0, g, torch.zeros_like(g))
                    acc = acc + g @ w[k, cs]
                parts[s, b, tile] = torch.where(keep[:, None], acc,
                                                torch.zeros_like(acc))
    out = parts[0]
    for s in range(1, splits):
        out = out + parts[s]
    return out


def compacted_dw(feats, nbr, g, plan, pairs_target):
    """`csrc/sparse_conv_dw.cu` in plain PyTorch: dW[k] over offset k's
    compacted hits only, in the kernel's splits, added in split order."""
    B, V_out, K3 = nbr.shape
    V_in, C_in = feats.shape[1:]
    f = feats.reshape(B * V_in, C_in)
    gf = g.reshape(B * V_out, -1)
    flat = nbr.reshape(B * V_out, K3)
    counts = plan.hit_counts.tolist()
    chunk, S = sp.dw_split_table(counts, pairs_target)
    dw = torch.zeros(K3, C_in, gf.shape[1])
    for k in range(K3):
        r = plan.hits[k, :counts[k]].long()
        ids = flat[r, k].long()
        assert bool((ids >= 0).all())
        rows = (r // V_out) * V_in + ids
        for s in range(S[k]):
            h = slice(s * chunk, (s + 1) * chunk)
            dw[k] = dw[k] + f[rows[h]].T @ gf[r[h]]
    return dw


@pytest.mark.parametrize('name', MAPS)
@pytest.mark.parametrize('rows,splits', [(128, 1), (128, 3), (64, 1)])
def test_tiled_conv_over_the_plan_matches_plain(name, rows, splits):
    l_in, l_out, nbr = _maps()[name]
    rng = np.random.RandomState(rows + splits)
    B, V_out, K3 = nbr.shape
    C_in, C_out = 40, 24
    feats = torch.from_numpy(rng.randn(B, l_in.capacity, C_in)
                             .astype(np.float32))
    w = torch.from_numpy((rng.randn(K3, C_in, C_out) * 0.1)
                         .astype(np.float32))
    # drop a fifth of the outputs, as the neck's pruned levels do
    out_mask = l_out.mask & torch.from_numpy(rng.rand(B, V_out) > 0.2)
    plan = sp.conv_plan(nbr)
    got = tiled_conv(feats, nbr, w, out_mask, plan, rows, splits)
    want = sp.sparse_conv_apply(feats, nbr, w, out_mask)
    _close(got, want)
    assert bool((got[~out_mask] == 0).all())
    jwant = np.asarray(jsp.sparse_conv_apply(
        jnp.asarray(feats.numpy()), jnp.asarray(nbr.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(out_mask.numpy())))
    _close(got, torch.from_numpy(np.array(jwant)))


@pytest.mark.parametrize('name', MAPS)
@pytest.mark.parametrize('C_in,C_out', [(3, 64), (48, 20)])
def test_compacted_dw_over_the_plan_matches_plain(name, C_in, C_out):
    l_in, l_out, nbr = _maps()[name]
    rng = np.random.RandomState(C_in)
    B, V_out, K3 = nbr.shape
    feats = torch.from_numpy(rng.randn(B, l_in.capacity, C_in)
                             .astype(np.float32))
    g = torch.from_numpy(rng.randn(B, V_out, C_out).astype(np.float32))
    g = torch.where(l_out.mask[..., None], g, torch.zeros_like(g))
    plan = sp.conv_plan(nbr)
    tm, _, pairs_target, grid_pairs = sp.dw_launch_shape(
        B * V_out, K3, C_in, C_out, 132)
    assert tm == (0 if C_in <= 4 else 4)
    chunk, S = sp.dw_split_table(plan.hit_counts.tolist(), pairs_target)
    assert sum(S) <= grid_pairs
    got = compacted_dw(feats, nbr, g, plan, pairs_target)
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, g))


def test_launch_shapes_follow_the_level_size():
    n_sm = 132
    # stem forward and input gradient take the narrow paths
    assert sp.conv_launch_shape(2, 100_000, 27, 3, 64, n_sm)[0] == 'narrow_in'
    assert sp.conv_launch_shape(2, 100_000, 27, 64, 3, n_sm)[0] == 'narrow_out'
    # wide levels: one tile a block, 64 or 128 channels wide; small
    # levels split their offsets across blocks
    assert sp.conv_launch_shape(2, 100_000, 27, 64, 64, n_sm) == (
        'tile', 64, 1)
    assert sp.conv_launch_shape(2, 20_000, 27, 128, 128, n_sm)[:2] == (
        'tile', 128)
    path, cols, splits = sp.conv_launch_shape(2, 1000, 27, 512, 256, n_sm)
    assert (path, cols) == ('tile', 128) and splits > 1
    # the split table never gives more splits than the grid holds
    for rows_, K3, C_in, C_out in ((200_000, 27, 3, 64), (8000, 27, 512, 512),
                                   (100_000, 27, 64, 64), (40, 8, 200, 33)):
        _, _, target, grid = sp.dw_launch_shape(rows_, K3, C_in, C_out, n_sm)
        for H in (0, 1, rows_, K3 * rows_ // 2, K3 * rows_):
            counts = [H // K3] * K3
            counts[0] += H - sum(counts)
            assert sum(sp.dw_split_table(counts, target)[1]) <= grid
