"""Launch shapes and windows of the ball-query and lookup kernels, on the CPU.

`csrc/ball_query.cu` splits the point axis into segments and
`csrc/lookup_pmz.cu` searches each tile of queries in one key window;
both take their cut from pure functions of the shapes
(`ball_query_launch_shape`, `lookup_launch_shape`), held here to what
the kernels assume. The window each lookup tile searches
(`lookup_tile_windows`) is held to the plain lookups: searching only the
window gives the same answers, in the q-1/q/q+1 form and in the
center-only form (over the card tests' cases, the neck's parent keys
among them). And the port's plain ball query equals the JAX package's
`_ball_query_idx` at points exactly on the radius.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.ops.ball_query import _ball_query_idx
from proxytransformation_torch.ops import ball_query as bq
from proxytransformation_torch.ops import sparse as sp
from test_torch_port_lookup_cases import LOOKUP_CASES, lookup_case

H100_SMS = 132
# dynamic shared memory a launch gets without opting in through
# cudaFuncSetAttribute, which `ptt_lookup_pmz` does not do
DEFAULT_DYNAMIC_SMEM = 48 * 1024
FLAGSHIP = (2, 1728, 100_000, 30)  # B, M (grid 12³), N, K of the preshape


@pytest.mark.parametrize('B,M,N,K', [
    FLAGSHIP, (1, 33, 1000, 8), (2, 64, 77, 40), (3, 45, 50_001, 64),
    (1, 1, 1, 1), (2, 5000, 3_000_000, 30), (1, 300, 0, 4),
    (1, 40, 2049, 5)])
def test_ball_query_head_and_segments_cover_the_points(B, M, N, K):
    """The head [0, head) and the tail segments of whole chunks (the
    last one shorter) cover [0, N) exactly, none empty (one empty
    segment where the head holds every point), at most 32 of them; the
    workspaces hold a head count, a list slot, a running count, K
    indices and a count per (center, segment), and the control
    counters: the next item, each sample's list length, a done count a
    group of 16 centers."""
    shape = bq.ball_query_launch_shape(B, M, N, K, H100_SMS)
    S, L, head = shape.segments, shape.seg_len, shape.head
    assert head == min(N, bq.BALL_QUERY_HEAD)
    assert 1 <= S <= bq.BALL_QUERY_MAX_SEGMENTS
    if N <= head:
        assert (S, L) == (1, 0)
    else:
        assert L % bq.BALL_QUERY_CHUNK == 0
        assert (S - 1) * L < N - head <= S * L
        bounds = [(head + s * L, min(N, head + (s + 1) * L))
                  for s in range(S)]
        assert bounds[0][0] == head and bounds[-1][1] == N
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(hi > lo for lo, hi in bounds)
    groups = B * -(-M // bq.BALL_QUERY_GROUP)
    assert shape.head_blocks == groups
    assert shape.cnt == shape.short_rows == (B * M, )
    assert shape.ctrl == (1 + B + groups, )
    assert shape.prog == shape.ws_cnt == (B * M, S)
    assert shape.ws_idx == (B * M, S, K)


def test_ball_query_fills_the_card_at_the_flagship():
    """The flagship's head runs 216 blocks of 16 centers, over one wave
    of 132 SMs; its tail 32 segments of 6 chunks over 4 persistent
    blocks an SM; the workspaces stay under 16 MB."""
    B, M, N, K = FLAGSHIP
    shape = bq.ball_query_launch_shape(B, M, N, K, H100_SMS)
    assert shape.head_blocks == 216 >= H100_SMS
    assert shape.tail_blocks == 4 * H100_SMS
    assert shape.segments == 32
    assert shape.seg_len == 6 * bq.BALL_QUERY_CHUNK
    ws_bytes = 4 * sum(int(np.prod(s)) for s in shape.workspaces)
    assert ws_bytes == 4 * (B * M * (2 + shape.segments * (K + 2))
                            + 1 + B + 216)
    assert ws_bytes < 16 * 2**20


@pytest.mark.parametrize('B,V,Q', [(2, 100_000, 900_000), (2, 2000, 18_000),
                                   (1, 1, 5), (2, 8192, 1024), (2, 8193, 7),
                                   (2, 0, 7), (1, 3_000_000, 9)])
def test_lookup_launch_shape(B, V, Q):
    """Tiles cover the queries; the capacity is a multiple of 4 that
    holds a whole sample's keys below `LOOKUP_MAX_WINDOW`; above it the
    fences are a power of two apart and at most `LOOKUP_MAX_FENCES`;
    shared memory holds the capacity, the 16-byte lead and the fences,
    within the 48 KB a launch gets by default (and so within a Hopper
    block's 227 KB)."""
    tiles, capacity, step, smem = sp.lookup_launch_shape(B, V, Q)
    assert (tiles - 1) * sp.LOOKUP_TILE < max(Q, 1) <= tiles * sp.LOOKUP_TILE
    assert capacity % 4 == 0 and capacity <= sp.LOOKUP_MAX_WINDOW
    assert capacity >= min(V, sp.LOOKUP_MAX_WINDOW)
    if V <= capacity:
        assert step == 0
        assert smem == 4 * (capacity + 4)
    else:
        assert step & (step - 1) == 0
        assert -(-V // step) <= sp.LOOKUP_MAX_FENCES < -(-V // (step // 2))
        assert smem == 4 * (capacity + 4 + sp.LOOKUP_MAX_FENCES)
    assert smem <= DEFAULT_DYNAMIC_SMEM


def _windowed_lookup(keys, queries):
    """What `ptt_lookup_pmz` computes, in numpy: per tile, the lower
    bound of q-1 inside the tile's window only, then the three slots
    from there inside it."""
    B, Q = queries.shape
    los, lens = (a.numpy() for a in sp.lookup_tile_windows(
        torch.from_numpy(keys), torch.from_numpy(queries)))
    out = np.full((3, B, Q), -1, np.int32)
    k64 = keys.astype(np.int64)
    for b in range(B):
        for t in range(los.shape[1]):
            qs = queries[b, t * sp.LOOKUP_TILE:(t + 1) * sp.LOOKUP_TILE]
            if (qs == sp.SENTINEL).all():
                assert lens[b, t] == 0
                continue
            lo = los[b, t]
            w = k64[b, lo:lo + lens[b, t]]
            for j, q in enumerate(qs.astype(np.int64)):
                if q == sp.SENTINEL:
                    continue
                p = np.searchsorted(w, q - 1)
                for s in range(p, min(p + 3, w.size)):
                    if w[s] - q > 1:
                        break
                    out[int(w[s] - q) + 1, b, t * sp.LOOKUP_TILE + j] = lo + s
    return out


@pytest.mark.parametrize('V', [3000, 12_000])
@pytest.mark.parametrize('case', ['runs', 'random_order', 'sentinel_tile',
                                  'below', 'near_max'])
def test_tile_windows_hold_every_answer(case, V):
    """Searching only each tile's window gives the plain lookup's
    answers, for a whole row in shared memory (V = 3000) and for windows
    placed by the fences (V = 12000): keys before a window are below
    qmin-1 and keys past it above qmax+1, q±1 compared in 64 bits."""
    rng = np.random.RandomState(3)
    B, n_valid = 2, V * 5 // 6
    keys = np.full((B, V), sp.SENTINEL, np.int64)
    for b in range(B):
        keys[b, :n_valid] = np.sort(rng.choice(3 * V, n_valid, replace=False))
    q = np.concatenate([keys[:, :n_valid] + d for d in (-4, 0, 2)], axis=1)
    if case == 'random_order':
        q = rng.permutation(q.T).T[:, :4000]
    elif case == 'sentinel_tile':
        q[:, :sp.LOOKUP_TILE] = sp.SENTINEL
    elif case == 'below':
        q[:, :40] = rng.randint(-2**31, -1, (B, 40))
        q[:, 0] = -2**31
    elif case == 'near_max':
        top = sp.SENTINEL - 1
        keys[0, n_valid - 5:n_valid] = [top - 4, top - 3, top - 2, top - 1,
                                        top]
        q[:, -50:] = rng.randint(top - 6, top + 1, (B, 50))
    keys, q = keys.astype(np.int32), np.ascontiguousarray(q, np.int32)
    want = sp.lookup_pmz_plain(torch.from_numpy(keys), torch.from_numpy(q))
    got = _windowed_lookup(keys, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert all((w >= 0).sum() > 100 for w in want)
    lens = sp.lookup_tile_windows(torch.from_numpy(keys),
                                  torch.from_numpy(q))[1]
    if V > sp.LOOKUP_MAX_WINDOW and case == 'runs':
        # sorted runs: windows about a tile long, but where a tile spans
        # two runs
        assert int((lens <= 3 * sp.LOOKUP_TILE).sum()) >= lens.numel() - 4


def _windowed_center(keys, queries):
    """What `ptt_lookup_center` computes, in numpy: per tile, the lower
    bound of q inside the tile's window only, answered where the key
    there equals q."""
    B, Q = queries.shape
    los, lens = (a.numpy() for a in sp.lookup_tile_windows(
        torch.from_numpy(keys), torch.from_numpy(queries)))
    out = np.full((B, Q), -1, np.int32)
    k64 = keys.astype(np.int64)
    for b in range(B):
        for t in range(los.shape[1]):
            tile = slice(t * sp.LOOKUP_TILE, (t + 1) * sp.LOOKUP_TILE)
            qs = queries[b, tile].astype(np.int64)
            live = qs != sp.SENTINEL
            if not live.any():
                assert lens[b, t] == 0
                continue
            lo = los[b, t]
            w = k64[b, lo:lo + lens[b, t]]
            p = np.searchsorted(w, qs)
            at = np.append(w, sp.SENTINEL)[p]  # an empty window holds none
            out[b, tile] = np.where(live & (at == qs), lo + p, -1)
    return out


@pytest.mark.parametrize('case', LOOKUP_CASES)
def test_center_tile_windows_hold_every_answer(case):
    """The center-only form searches the q-1/q/q+1 form's windows for
    the lower bound of q: that gives `lookup_center_plain`'s answers bit
    for bit. The neck's parent keys are not ascending within a tile; its
    coarse rows fit the shared-memory capacity whole, and a wider row
    places the same queries' windows by the fences."""
    keys, q = lookup_case(case)
    want = sp.lookup_center_plain(torch.from_numpy(keys),
                                  torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(_windowed_center(keys, q), want)
    if case.startswith('neck'):
        live = q[0][q[0] != sp.SENTINEL]
        assert (np.diff(live) < 0).sum() > 100
        assert (want >= 0).sum() > 4000 and (want == -1).sum() > 1000
        step = sp.lookup_launch_shape(*keys.shape, q.shape[1]).fence_step
        assert (step == 0) == (case == 'neck_parents')


@pytest.mark.parametrize('K', [1, 4, 30])
def test_ball_query_exact_radius_matches_jax(K):
    """Points at exactly r from a center along an axis (so d² rounds to
    r² exactly) miss under the strict <, the float32 neighbours just
    inside hit, masked points never count: the port's plain ball query
    and the JAX package's CPU oracle give the same indices bit for
    bit."""
    rng = np.random.RandomState(K)
    B, M, N, r = 2, 7, 600, np.float32(0.5)
    centers = rng.uniform(-3, 3, (B, M, 3)).astype(np.float32)
    centers[:, :4] = [[1, 0, 0], [2, -1, 0.5], [0, 0, 0], [-1.5, 2, 1]]
    pts = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
    mask = rng.rand(B, N) > 0.1
    for m in range(4):
        c = centers[0, m]
        base = 40 * m
        for a in range(3):
            e = np.eye(3, dtype=np.float32)[a]
            pts[0, base + 2 * a] = c + r * e
            pts[0, base + 2 * a + 1] = c - r * e
            inside = c.copy()
            inside[a] = np.nextafter(c[a] + r, c[a])
            pts[0, base + 10 + a] = inside
        mask[0, base:base + 13] = True
        mask[0, base + 11] = False  # a masked point just inside
    d = pts[0, :160, None] - centers[0, None, :4]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    assert (d2 == r * r).sum() >= 24  # the planted points sit on the radius
    r2 = bq.radius_squared(float(r))
    want = np.asarray(_ball_query_idx(
        jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(r, jnp.float32) ** 2, K, 128))
    got = bq.ball_query_idx_plain(torch.from_numpy(centers),
                                  torch.from_numpy(pts),
                                  torch.from_numpy(mask), r2, K).numpy()
    np.testing.assert_array_equal(got, want)
    for m in range(4):
        hits = set(got[0, m][got[0, m] >= 0].tolist())
        assert not hits & {40 * m + i for i in range(6)}
        assert 40 * m + 11 not in hits
        if K >= 30:  # all of the center's few hits
            assert {40 * m + 10, 40 * m + 12} <= hits
