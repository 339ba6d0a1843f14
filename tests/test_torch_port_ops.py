"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both sides. Integer outputs
(ball-query indices, voxel keys and coords, neighbor maps, lookups,
top-k and compaction indices) must match bit for bit. Float outputs
match within atol=1e-5, rtol=1e-4: float32 sums are taken in another
order. The JAX side runs as its own tests run it (XLA on the CPU), and
the Pallas kernels of ball query and merge-join also in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.ops import common as jcommon
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_tpu.ops.ball_query import _ball_query_idx
from proxytransformation_tpu.ops.ball_query_pallas import ball_query_idx_pallas
from proxytransformation_tpu.ops.fps import sample_farthest_points as j_fps
from proxytransformation_tpu.ops.merge_join_pallas import (lookup_pmz_stream,
                                                           lookup_stream)
from proxytransformation_tpu.models.preshape import (_mask_drop,
                                                     _scatter_replace)
from proxytransformation_torch.models.preshape import (grid_unit, mask_drop,
                                                       scatter_replace)
from proxytransformation_torch.ops import ball_query as tbq
from proxytransformation_torch.ops import common as tcommon
from proxytransformation_torch.ops import sparse as tsp
from proxytransformation_torch.ops.fps import sample_farthest_points as t_fps
from test_torch_port_lookup_cases import neck_parents

ATOL, RTOL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def n(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


# --------------------------------------------------------------------------
# masked helpers
# --------------------------------------------------------------------------
def test_masked_helpers_match():
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 7, 3).astype(np.float32)
    idx = rng.randint(-1, 7, (2, 4, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        n(tcommon.masked_gather(t(pts), t(idx))),
        n(jcommon.masked_gather(jnp.asarray(pts), jnp.asarray(idx))))
    x = rng.randn(3, 6, 4).astype(np.float32)
    m = rng.rand(3, 6, 4) > 0.4
    for fn, kw in (('masked_mean', {}), ('masked_max', {}),
                   ('masked_softmax', {})):
        want = getattr(jcommon, fn)(jnp.asarray(x), jnp.asarray(m),
                                    **({'axis': 1} if fn != 'masked_softmax'
                                       else {}))
        got = getattr(tcommon, fn)(t(x), t(m),
                                   **({'dim': 1} if fn != 'masked_softmax'
                                      else {}))
        np.testing.assert_allclose(n(got), n(want), atol=ATOL, rtol=RTOL,
                                   err_msg=fn)


# --------------------------------------------------------------------------
# ball query (kernel 1) and FPS
# --------------------------------------------------------------------------
@pytest.mark.parametrize('seed,radius,K', [(0, 1.0, 6), (1, 0.7, 30),
                                           (2, 3.0, 30)])
def test_ball_query_bit_exact(seed, radius, K):
    rng = np.random.RandomState(seed)
    B, N, M = 2, 700, 45
    pts = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[:, N - 60:] = False
    mask[1, ::7] = False
    centers = rng.uniform(-2, 2, (B, M, 3)).astype(np.float32)
    # centers on points and points on the sphere's boundary
    centers[0, :5] = pts[0, :5]
    pts[1, 10:20] = centers[1, 3] + np.float32(radius) * np.eye(3)[
        np.arange(10) % 3].astype(np.float32)
    r2 = jnp.asarray(radius, jnp.float32) ** 2
    want = np.asarray(_ball_query_idx(jnp.asarray(centers), jnp.asarray(pts),
                                      jnp.asarray(mask), r2, K, 128))
    pallas = np.asarray(ball_query_idx_pallas(
        jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(mask), r2, K,
        interpret=True))
    got_idx, got_grouped = tbq.ball_query(t(centers), t(pts), K, radius,
                                          t(mask))
    assert tbq.radius_squared(radius) == float(r2)
    np.testing.assert_array_equal(n(got_idx), want)
    np.testing.assert_array_equal(n(got_idx), pallas)
    assert (n(got_idx) >= 0).sum() > 0
    np.testing.assert_array_equal(
        n(got_grouped), np.asarray(jcommon.masked_gather(jnp.asarray(pts),
                                                         jnp.asarray(want))))


def test_fps_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 60, 3).astype(np.float32)
    mask = np.ones((2, 60), bool)
    mask[1, :3] = False
    for m in (None, mask):
        js, ji = j_fps(jnp.asarray(pts), 17,
                       None if m is None else jnp.asarray(m))
        ts, ti = t_fps(t(pts), 17, None if m is None else t(m))
        np.testing.assert_array_equal(n(ti), np.asarray(ji))
        np.testing.assert_array_equal(n(ts), np.asarray(js))


def test_grid_prior_linspace_bit_exact():
    for gs in range(1, 20):
        np.testing.assert_array_equal(
            n(grid_unit(gs)), np.asarray(jnp.linspace(0.0, 1.0, gs)),
            err_msg=f'grid_size={gs}')


# --------------------------------------------------------------------------
# preshape scatter traps
# --------------------------------------------------------------------------
def test_scatter_replace_last_write_wins():
    pts = np.zeros((1, 5, 3), np.float32)
    idx = np.array([[[1, 3, 1], [1, 3, -1], [-1, -1, -1]]], np.int32)
    vals = np.arange(9 * 3, dtype=np.float32).reshape(1, 3, 3, 3) + 1
    got = n(scatter_replace(t(pts), t(idx), t(vals)))
    want = np.asarray(_scatter_replace(jnp.asarray(pts), jnp.asarray(idx),
                                       jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)
    # flat (m, k) order: point 1 written at 0, 2, 3 → the last (3) wins
    np.testing.assert_array_equal(got[0, 1], vals[0, 1, 0])
    np.testing.assert_array_equal(got[0, 3], vals[0, 1, 1])
    # the JAX CPU scatter's own behaviour on duplicates, as the port keeps it
    one = jnp.zeros(5).at[jnp.asarray([1, 3, 1, 1, 3, 6])].set(
        jnp.asarray([10., 20., 30., 40., 50., 60.]), mode='drop')
    np.testing.assert_array_equal(np.asarray(one), [0, 40, 0, 50, 0])


def test_scatter_replace_and_mask_drop_random():
    rng = np.random.RandomState(4)
    B, N, M, K = 2, 50, 12, 6
    pts = rng.randn(B, N, 3).astype(np.float32)
    idx = rng.randint(-1, N, (B, M, K)).astype(np.int32)
    vals = rng.randn(B, M, K, 3).astype(np.float32)
    np.testing.assert_array_equal(
        n(scatter_replace(t(pts), t(idx), t(vals))),
        np.asarray(_scatter_replace(jnp.asarray(pts), jnp.asarray(idx),
                                    jnp.asarray(vals))))
    mask = rng.rand(B, N) > 0.2
    drop = rng.randint(-1, N, (B, 30)).astype(np.int32)
    np.testing.assert_array_equal(
        n(mask_drop(t(mask), t(drop))),
        np.asarray(_mask_drop(jnp.asarray(mask), jnp.asarray(drop))))


# --------------------------------------------------------------------------
# sparse geometry (bit-exact) and lookups (kernel 2)
# --------------------------------------------------------------------------
def _assert_level_equal(tl, jl, feats=True):
    for f in ('keys', 'coords', 'mask'):
        np.testing.assert_array_equal(n(getattr(tl, f)),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    np.testing.assert_array_equal(n(tl.origin), np.asarray(jl.origin))
    assert tl.extent == tuple(jl.extent) and tl.stride == jl.stride
    if feats:
        np.testing.assert_allclose(n(tl.feats), np.asarray(jl.feats),
                                   atol=ATOL, rtol=RTOL)


def _scene(seed, B=2, N=3000):
    from proxytransformation_torch.data.synthetic import surface_scene_batch
    pts = surface_scene_batch(B, N, seed=seed) * np.float32(0.4)
    mask = np.ones((B, N), bool)
    mask[1, -200:] = False
    return pts.astype(np.float32), mask


@pytest.fixture(scope='module')
def levels():
    """Voxelize → stem level → pool level → stage level on both sides."""
    pts, mask = _scene(5)
    vs, cap, ext = 0.02, 3000, (256, 256, 128)
    jl0 = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                              jnp.asarray(pts), voxel_size=vs, capacity=cap,
                              extent=ext)
    tl0 = tsp.voxelize_points(t(pts), t(mask), t(pts), vs, cap, ext)
    out = [(tl0, jl0)]
    for c in (2000, 1500, 900):
        tl, jl = out[-1]
        out.append((tsp.downsample_coords(tl, c),
                    jsp.downsample_coords(jl, capacity=c)))
    return out


def test_voxelize_keys_and_coords_bit_exact(levels):
    tl0, jl0 = levels[0]
    _assert_level_equal(tl0, jl0)
    per_sample = n(tl0.mask).sum(1)
    assert np.all((per_sample > 500) & (per_sample < 3000)), per_sample
    # the real flagship quantum on a full-scale scene slice
    pts, mask = _scene(6)
    pts = pts / np.float32(0.4)
    jl = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask),
                             jnp.asarray(pts), voxel_size=0.01,
                             capacity=3000)
    tl = tsp.voxelize_points(t(pts), t(mask), t(pts), 0.01, 3000)
    _assert_level_equal(tl, jl)


def test_downsample_levels_bit_exact(levels):
    for tl, jl in levels[1:]:
        _assert_level_equal(tl, jl, feats=False)


@pytest.mark.parametrize('pair,ks,stride', [((0, 1), 3, 2), ((1, 2), 2, 2),
                                            ((2, 2), 3, 1), ((3, 3), 3, 1)],
                         ids=['k3_stride2', 'k2_pool', 'k3_self',
                              'k3_self_coarse'])
def test_neighbor_maps_bit_exact(levels, pair, ks, stride):
    (ti, ji), (to, jo) = levels[pair[0]], levels[pair[1]]
    want = np.asarray(jsp.build_neighbor_map(ji, jo, kernel_size=ks,
                                             stride=stride))
    got = n(tsp.build_neighbor_map(ti, to, ks, stride))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got >= 0).sum() > 0


def _sorted_keys(rng, B, V, hi, n_valid):
    keys = np.full((B, V), tsp.SENTINEL, np.int32)
    for b in range(B):
        keys[b, :n_valid] = np.sort(rng.choice(hi, n_valid, replace=False))
    return keys


def test_lookups_bit_exact():
    rng = np.random.RandomState(7)
    B, V, Q = 2, 700, 1500
    keys = _sorted_keys(rng, B, V, 5000, 600)
    queries = rng.randint(-2, 5002, (B, Q)).astype(np.int32)
    queries[0, 5] = tsp.SENTINEL
    queries[1, -7:] = tsp.SENTINEL
    queries[0, :64] = keys[0, 100:164] + 1
    jk, jq = jnp.asarray(keys), jnp.asarray(queries)
    want = jsp._batched_lookup_pmz(jk, jq)
    stream = lookup_pmz_stream(jk, jq, tile=256, interpret=True)
    got = tsp.lookup_pmz(t(keys), t(queries))
    for name, w, s, g in zip(('q-1', 'q', 'q+1'), want, stream, got):
        np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(n(g), np.asarray(s), err_msg=name)
    c_want = np.asarray(jsp._batched_lookup(jk, jq))
    np.testing.assert_array_equal(n(tsp.lookup_center(t(keys), t(queries))),
                                  c_want)
    np.testing.assert_array_equal(
        np.asarray(lookup_stream(jk, jq, tile=256, interpret=True)), c_want)
    assert all((n(g) >= 0).sum() > 30 for g in got)


def test_center_lookup_neck_parents():
    """The neck's parent-key lookup (`MinkNeck`, `generative_transpose_map`):
    queries linearize(coords // 2) in the fine level's key order, not
    ascending, SENTINEL at masked voxels, against pruned coarse keys.
    The port's `lookup_center` (CPU) equals `_batched_lookup` and the
    Pallas `lookup_stream` in interpret mode bit for bit."""
    keys, queries = neck_parents(np.random.RandomState(11), 2, (24, 24, 16),
                                 1500, 2000, 800)
    keys, queries = keys.astype(np.int32), queries.astype(np.int32)
    live = queries[0][queries[0] != tsp.SENTINEL]
    assert (np.diff(live) < 0).any()
    jk, jq = jnp.asarray(keys), jnp.asarray(queries)
    want = np.asarray(jsp._batched_lookup(jk, jq))
    got = n(tsp.lookup_center(t(keys), t(queries)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(lookup_stream(jk, jq, tile=256, interpret=True)), want)
    assert (got >= 0).sum() > 1000 and (got[queries != tsp.SENTINEL] == -1).any()


# --------------------------------------------------------------------------
# sparse compute (kernel 3's plain version) and pruning
# --------------------------------------------------------------------------
@pytest.mark.parametrize('pair,ks,stride,c_in,c_out', [
    ((0, 1), 3, 2, 3, 16), ((2, 2), 3, 1, 20, 24), ((1, 2), 2, 2, 8, 5)])
def test_sparse_conv_matches_jax(levels, pair, ks, stride, c_in, c_out):
    (ti, ji), (to, jo) = levels[pair[0]], levels[pair[1]]
    nbr = np.asarray(jsp.build_neighbor_map(ji, jo, kernel_size=ks,
                                            stride=stride))
    rng = np.random.RandomState(c_in)
    feats = rng.randn(2, nbr.shape[1] if pair[0] == pair[1] else
                      ti.capacity, c_in).astype(np.float32)
    w = (rng.randn(nbr.shape[-1], c_in, c_out) * 0.2).astype(np.float32)
    om = np.asarray(jo.mask)
    want = np.asarray(jsp.sparse_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                      jnp.asarray(w), jnp.asarray(om)))
    got = n(tsp.sparse_conv(t(feats), t(nbr), t(w), t(om)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # 1x1 (K³ = 1) stays the plain path on both sides
    w1 = w[:1]
    np.testing.assert_allclose(
        n(tsp.sparse_conv(t(feats), t(nbr[..., :1]), t(w1), t(om))),
        np.asarray(jsp.sparse_conv(jnp.asarray(feats),
                                   jnp.asarray(nbr[..., :1]),
                                   jnp.asarray(w1), jnp.asarray(om))),
        atol=ATOL, rtol=RTOL)


def test_max_pool_and_transpose_match(levels):
    (t1, j1), (t2, j2) = levels[1], levels[2]
    rng = np.random.RandomState(8)
    feats = rng.randn(2, t1.capacity, 6).astype(np.float32)
    nbr = np.asarray(jsp.build_neighbor_map(j1, j2, kernel_size=2, stride=2))
    np.testing.assert_array_equal(
        n(tsp.sparse_max_pool(t(feats), t(nbr), t2.mask)),
        np.asarray(jsp.sparse_max_pool(jnp.asarray(feats), jnp.asarray(nbr),
                                       j2.mask)))
    jp, jo = jsp.generative_transpose_map(j1, j2)
    tp, to = tsp.generative_transpose_map(t1, t2)
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    np.testing.assert_array_equal(n(to), np.asarray(jo))
    coarse = rng.randn(2, t2.capacity, 7).astype(np.float32)
    w = rng.randn(8, 7, 5).astype(np.float32)
    np.testing.assert_allclose(
        n(tsp.generative_transpose_apply(t(coarse), tp, to, t(w), t1.mask)),
        np.asarray(jsp.generative_transpose_apply(
            jnp.asarray(coarse), jp, jo, jnp.asarray(w), j1.mask)),
        atol=ATOL, rtol=RTOL)


def test_compaction_and_pruning_bit_exact(levels):
    tl, jl = levels[2]
    rng = np.random.RandomState(9)
    V = tl.capacity
    # ties on purpose: scores repeat, as parent scores do in the neck
    scores = rng.randint(0, 40, (2, V)).astype(np.float32) / 8
    tl = tl._replace(feats=t(rng.randn(2, V, 4).astype(np.float32)))
    jl = jl._replace(feats=jnp.asarray(n(tl.feats)))
    extra = rng.randn(2, V).astype(np.float32)
    jnew, (jx, ), jsrc = jsp.compact_topk(jl, jnp.asarray(scores), 300,
                                          extras=(jnp.asarray(extra), ))
    tnew, (tx, ), tsrc = tsp.compact_topk(tl, t(scores), 300,
                                          extras=(t(extra), ))
    np.testing.assert_array_equal(n(tsrc), np.asarray(jsrc))
    _assert_level_equal(tnew, jnew)
    np.testing.assert_array_equal(n(tx), np.asarray(jx))
    jp = jsp.prune_topk(jl, jnp.asarray(scores), 250)
    tp = tsp.prune_topk(tl, t(scores), 250)
    np.testing.assert_array_equal(n(tp.mask), np.asarray(jp.mask))
    np.testing.assert_array_equal(n(tp.feats), np.asarray(jp.feats))


def test_topk_ties_keep_lowest_index():
    x = np.array([[1, 3, 3, 2, 3]], np.float32)
    np.testing.assert_array_equal(n(tsp.topk_stable(t(x), 2)), [[1, 2]])
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(x, 2)[1]),
                                  [[1, 2]])
    rng = np.random.RandomState(10)
    s = rng.randint(0, 5, (3, 40)).astype(np.float32)
    s[0, :7] = -np.inf
    np.testing.assert_array_equal(n(tsp.topk_stable(t(s), 25)),
                                  np.asarray(jax.lax.top_k(s, 25)[1]))


# --------------------------------------------------------------------------
# dispatch rule: a CUDA wrapper never takes a CPU tensor
# --------------------------------------------------------------------------
def test_cuda_wrappers_refuse_cpu_tensors():
    c = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match='CUDA'):
        tbq.ball_query_idx_cuda(c, torch.zeros(1, 8, 3),
                                torch.ones(1, 8, dtype=torch.bool), 1.0, 2)
    k = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        tsp.lookup_pmz_cuda(k, k)
    with pytest.raises(ValueError, match='CUDA'):
        tsp.lookup_center_cuda(k, k)
    with pytest.raises(ValueError, match='CUDA'):
        tsp.sparse_conv_cuda(torch.zeros(1, 4, 2),
                             torch.zeros(1, 4, 27, dtype=torch.int32),
                             torch.zeros(27, 2, 3),
                             torch.ones(1, 4, dtype=torch.bool))


# --------------------------------------------------------------------------
# TF32 and the port's own copy of the synthetic scenes
# --------------------------------------------------------------------------
def test_disable_tf32_sets_both_flags():
    from proxytransformation_torch.device import full_float32
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_surface_scene_copy_matches():
    from proxytransformation_tpu.data.synthetic import (
        surface_scene_batch as jax_pkg_scenes)
    from proxytransformation_torch.data.synthetic import surface_scene_batch
    np.testing.assert_array_equal(surface_scene_batch(2, 3000, seed=5),
                                  jax_pkg_scenes(2, 3000, seed=5))
