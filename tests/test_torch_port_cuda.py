"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a GPU every test skips with its reason. This file
imports neither JAX nor the JAX package, so it runs on a GPU host that
has no JAX; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Ball query, the lookups (and the lookup's tile
windows) and the row gather must be bit-exact; the sparse
conv, its weight gradient and its input gradient within
|k - p| <= 1e-4 * (1 + max|p|) (float32 sums in another order); the
bf16 form of the conv against its plain bf16 version within the same
tolerance where it writes float32, within one bf16 ulp (plus that
tolerance) where it writes bf16.
"""
import numpy as np
import pytest
import torch

from proxytransformation_torch.device import full_float32
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape, batch_to_device)
from proxytransformation_torch.engine.train import (
    BASE_LR, build_lr_schedule, build_optimizer, make_train_step)
from proxytransformation_torch.models.preshape import Dropout
from proxytransformation_torch.ops import _cuda
from proxytransformation_torch.ops import ball_query as bq
from proxytransformation_torch.ops import sparse as sp
from proxytransformation_torch.tools import gather_probe
from test_torch_port_lookup_cases import LOOKUP_CASES, lookup_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with nvcc (CUDA kernels have no '
                    'CPU mode; their plain versions are tested against JAX '
                    'in test_torch_port_ops.py)')
    with full_float32():
        yield torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('B,M,N,K,radius', [(2, 300, 5000, 30, 0.7),
                                            (1, 33, 1000, 8, 0.3),
                                            (2, 64, 77, 40, 5.0)])
def test_ball_query_kernel(gen, B, M, N, K, radius):
    pts = torch.rand(B, N, 3, device='cuda', generator=gen) * 4
    centers = torch.rand(B, M, 3, device='cuda', generator=gen) * 4
    centers[0, :4] = pts[0, :4]
    mask = torch.rand(B, N, device='cuda', generator=gen) > 0.1
    if B > 1:
        mask[-1] = False  # a sample without a valid point
    r2 = bq.radius_squared(radius)
    got = bq.ball_query_idx(centers, pts, mask, r2, K)
    want = bq.ball_query_idx_plain(centers, pts, mask, r2, K)
    assert torch.equal(got, want)


def _planted_cloud(K, launch, N, M, B=3, r=0.5):
    """Sample 0: isolated centers 3 apart on the x axis with planted hits
    (center 0 none; 1 fewer than K, in the head and spread over tail
    segments 0-7; 2 exactly K with the K-th on the last point of tail
    segment 1, more after; 3 only in the last tail segment; 4 points at
    exactly r on the axes, which miss, and just inside; 5 hits with
    masked points between them; 6 exactly K ending on the head's last
    point, more after). Sample 1: centers inside a random cloud (~26
    hits each at r = 0.5). Sample 2: all masked."""
    rng = np.random.RandomState(K)
    S, L, H = launch.segments, launch.seg_len, launch.head
    pts = rng.uniform(50, 60, (B, N, 3)).astype(np.float32)
    mask = rng.rand(B, N) > 0.05
    centers = rng.uniform(50, 60, (B, M, 3)).astype(np.float32)
    centers[0] = 0
    centers[0, :, 0] = 3 * np.arange(M)

    def plant(m, idx, keep=True):
        idx = np.asarray(idx, np.int64)
        pts[0, idx] = centers[0, m] + rng.uniform(-0.25, 0.25, (idx.size, 3))
        mask[0, idx] = keep

    n1 = max(K - 3, 0)
    plant(1, [*([11] if n1 else []),
              *(H + 7 + np.arange(n1 - 1) * (8 * L // max(n1, 1)))])
    plant(2, [*(20 + np.arange(max(K - 2, 0))), *([H + 5] if K > 1 else []),
              H + 2 * L - 1, *(H + 2 * L + 5 + np.arange(3))])
    plant(3, H + (S - 1) * L + 3 * np.arange(K + 5))
    c4 = centers[0, 4]
    on = [c4 + np.float32(r) * e for e in np.eye(3, dtype=np.float32)]
    on += [c4 - np.float32(r) * e for e in np.eye(3, dtype=np.float32)]
    inside = c4.copy()
    inside[0] = np.nextafter(c4[0] + np.float32(r), np.float32(0))
    pts[0, 100:106] = np.stack(on)
    pts[0, 106] = inside
    mask[0, 100:107] = True
    plant(5, 300 + np.arange(2 * K))
    mask[0, 301:300 + 2 * K:2] = False
    plant(6, [*(H - K + np.arange(K)), H + 1, H + 2])
    mask[2] = False
    return (torch.tensor(centers, device='cuda'),
            torch.tensor(pts, device='cuda'), torch.tensor(mask, device='cuda'))


@pytest.mark.parametrize('K', [1, 30, 64])
def test_ball_query_planted_segments(gen, K):
    """Planted cases across the head and the tail segments, B = 3, N not
    a multiple of the chunk or the segment, M not a multiple of the tile:
    the kernels equal the plain version bit for bit."""
    B, M, N, r = 3, 45, 50001, 0.5
    launch = bq.ball_query_launch_shape(B, M, N, K,
                                        _cuda.sm_count(torch.device('cuda')))
    H, L = launch.head, launch.seg_len
    assert launch.segments >= 8 and (N - H) % L
    centers, pts, mask = _planted_cloud(K, launch, N, M, B, r)
    r2 = bq.radius_squared(r)
    want = bq.ball_query_idx_plain(centers, pts, mask, r2, K)
    got = bq.ball_query_idx_cuda(centers, pts, mask, r2, K)
    assert torch.equal(got, want)
    w = want[0].cpu().numpy()
    assert (w[0] == -1).all()
    assert (w[1, max(K - 3, 0):] == -1).all()
    assert w[2, K - 1] == H + 2 * L - 1
    assert (w[3, :K] >= H + (launch.segments - 1) * L).all()
    assert w[4, 0] == 106 and (w[4, 1:] == -1).all()
    assert (w[5, :K] % 2 == 0).all() and (w[5, :K] >= 300).all()
    assert w[6, K - 1] == H - 1
    assert (want[2] == -1).all()
    assert (want[1] >= 0).any()
    if K >= 30:  # ~26 hits a center: some centers stay short
        assert (want[1, :, K - 1] == -1).any()


def _keys(gen, B, V, hi, n_valid):
    keys = torch.full((B, V), sp.SENTINEL, dtype=torch.int32, device='cuda')
    for b in range(B):
        vals = torch.randperm(hi, device='cuda', generator=gen)[:n_valid]
        keys[b, :n_valid] = torch.sort(vals).values.int()
    return keys


@pytest.mark.parametrize('B,V,Q,n_valid', [(2, 5000, 9000, 4000),
                                           (1, 64, 300, 64)])
def test_lookup_kernels(gen, B, V, Q, n_valid):
    keys = _keys(gen, B, V, 3 * V, n_valid)
    q = torch.randint(-3, 3 * V + 3, (B, Q), device='cuda', generator=gen)
    q = q.int()
    q[0, :10] = sp.SENTINEL
    q[0, 10:40] = keys[0, 5:35] + 1
    for g, w in zip(sp.lookup_pmz(keys, q), sp.lookup_pmz_plain(keys, q)):
        assert torch.equal(g, w)
    assert torch.equal(sp.lookup_center(keys, q),
                       sp.lookup_center_plain(keys, q))
    # a misaligned key row: the kernels refuse it, the dispatchers copy it
    flat = torch.empty(B * V + 1, dtype=torch.int32, device='cuda')
    shifted = flat[1:].view(B, V)
    shifted.copy_(keys)
    for kernel in (sp.lookup_pmz_cuda, sp.lookup_center_cuda):
        with pytest.raises(ValueError, match='16-byte'):
            kernel(shifted, q)
    assert torch.equal(sp.lookup_center(shifted, q),
                       sp.lookup_center_plain(keys, q))


@pytest.mark.parametrize('case', LOOKUP_CASES)
def test_lookup_pmz_windows(gen, case):
    """Both windowed lookups, q-1/q/q+1 and center-only, equal their
    plain versions bit for bit, and the tile windows of each equal
    `lookup_tile_windows`."""
    keys, q = (torch.tensor(a, device='cuda') for a in lookup_case(case))
    B, V = keys.shape
    tiles, capacity, step, _ = sp.lookup_launch_shape(B, V, q.shape[1])
    window = torch.empty((B, tiles), dtype=torch.int32, device='cuda')
    got = sp.lookup_pmz_cuda(keys, q, window)
    for g, w in zip(got, sp.lookup_pmz_plain(keys, q)):
        assert torch.equal(g, w)
    want_window = sp.lookup_tile_windows(keys, q)[1]
    assert torch.equal(window.long(), want_window)
    center_window = torch.full_like(window, -5)
    center = sp.lookup_center_cuda(keys, q, center_window)
    assert torch.equal(center, sp.lookup_center_plain(keys, q))
    assert torch.equal(center_window.long(), want_window)
    assert torch.equal(sp.lookup_center(keys, q), center)
    if case in ('random_order', 'oversized'):
        assert bool((window > capacity).any())
    if case == 'sentinel_tile':
        assert bool((window[:, 1] == 0).all())
    if case == 'neck_parents':
        # the row whole in every live tile; the last tiles hold only
        # SENTINEL
        assert step == 0 and set(window.tolist()[0]) == {0, V}
        assert int((center >= 0).sum()) > 4000


@pytest.mark.parametrize('V_in,V_out,K3,C_in,C_out,hit', [
    (3000, 2000, 27, 3, 64, 0.3), (3000, 3000, 27, 64, 96, 0.3),
    (1000, 800, 8, 200, 33, 0.5), (500, 130, 27, 1024, 256, 0.2),
    (400, 300, 27, 16, 16, 0.0)])
def test_sparse_conv_kernel(gen, V_in, V_out, K3, C_in, C_out, hit):
    B = 2
    feats = torch.randn(B, V_in, C_in, device='cuda', generator=gen)
    nbr = torch.randint(0, V_in, (B, V_out, K3), device='cuda', generator=gen)
    miss = torch.rand(B, V_out, K3, device='cuda', generator=gen) >= hit
    nbr = torch.where(miss, -1, nbr).int()
    w = torch.randn(K3, C_in, C_out, device='cuda', generator=gen) * 0.1
    out_mask = torch.rand(B, V_out, device='cuda', generator=gen) > 0.2
    got = sp.sparse_conv(feats, nbr, w, out_mask)
    want = sp.sparse_conv_apply(feats, nbr, w, out_mask)
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert torch.all(got[~out_mask] == 0)


def _tiny_grounder_and_batch():
    model = SparseFeatureFusion3DGrounderPreshape(
        num_queries=16, voxel_size=0.05, n_points=1024, img_base_channels=4,
        text_width=64, text_layers=2, text_heads=4, grid_size=4,
        text_blocks=1, img_blocks=1, dynamic_drop_radio=0.5, num_sub=8,
        backbone3d_depth=14, sparse_capacities=(1024, 800, 512, 256, 128, 64),
        voxel_extent=(128, 128, 128), neck_out_channels=64,
        pts_prune_threshold=64, decoder_layers=2, embed_dims=64, num_heads=4,
        ffn_channels=128, img_spacial_dim=2, max_text_len=64,
        device='cuda').random_init_(1)
    rng = np.random.RandomState(1)
    B, V, H, W, N, L = 2, 2, 64, 64, 1024, 8
    proj = np.tile(np.array([[50, 0, W / 2, 0], [0, 50, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    batch = {
        'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
        'points': rng.uniform(0, 3.0, (B, N, 3)).astype(np.float32),
        'points_mask': np.ones((B, N), bool),
        'input_ids': rng.randint(0, 49408, (B, L)).astype(np.int32),
        'text_mask': np.arange(L)[None].repeat(B, 0) < L - 2,
        'proj_mats': proj, 'views_mask': np.ones((B, V), bool)}
    return model, batch_to_device(batch, 'cuda')


def test_predict_ignores_callers_tf32(gen):
    """With the caller's TF32 flags on, predict gives exactly what it
    gives with them off, and leaves them on."""
    model, batch = _tiny_grounder_and_batch()
    want = model(batch)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = (True, True)
        got = model(batch)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    for k in ('bboxes_3d', 'scores_3d', 'query_mask'):
        assert torch.equal(got[k], want[k]), k


def _close(got, want):
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize('V_in,V_out,K3,C_in,C_out,hit', [
    (3000, 2000, 27, 3, 64, 0.3), (3000, 3000, 27, 64, 96, 0.3),
    (1000, 800, 8, 200, 33, 0.5), (500, 130, 27, 1024, 256, 0.2),
    (400, 300, 27, 16, 16, 0.0)])
def test_sparse_conv_dw_kernel(gen, V_in, V_out, K3, C_in, C_out, hit):
    """dW kernel vs its plain version, and the same bits on a rerun (no
    float atomics)."""
    B = 2
    feats = torch.randn(B, V_in, C_in, device='cuda', generator=gen)
    nbr = torch.randint(0, V_in, (B, V_out, K3), device='cuda', generator=gen)
    miss = torch.rand(B, V_out, K3, device='cuda', generator=gen) >= hit
    nbr = torch.where(miss, -1, nbr).int()
    g = torch.randn(B, V_out, C_out, device='cuda', generator=gen)
    got = sp.sparse_conv_dw(feats, nbr, g)
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, g))
    assert torch.equal(sp.sparse_conv_dw(feats, nbr, g), got)


def _random_map(gen, B, V_in, V_out, K3, hit):
    nbr = torch.randint(0, V_in, (B, V_out, K3), device='cuda', generator=gen)
    miss = torch.rand(B, V_out, K3, device='cuda', generator=gen) >= hit
    return torch.where(miss, -1, nbr).int()


def _all_three(gen, feats, nbr, w, out_mask, plan=None):
    """Forward, input gradient and weight gradient kernels against their
    plain versions on one map; returns the dW kernel's result."""
    _close(sp.sparse_conv_cuda(feats, nbr, w, out_mask, plan),
           sp.sparse_conv_apply(feats, nbr, w, out_mask))
    g = torch.randn(feats.shape[0], nbr.shape[1], w.shape[-1], device='cuda',
                    generator=gen)
    wt = w.transpose(1, 2).contiguous()
    # the same hit pattern, its entries folded into g's rows
    nbr_g = torch.where(nbr >= 0, nbr % nbr.shape[1], -1).int()
    _close(sp.sparse_conv_dfeats_cuda(g, nbr_g, wt, out_mask, plan),
           sp.sparse_conv_apply(g, nbr_g, wt, out_mask))
    dw = sp.sparse_conv_dw_cuda(feats, nbr, g, plan)
    _close(dw, sp.sparse_conv_dw_plain(feats, nbr, g))
    return dw


@pytest.mark.parametrize('K3', [27, 8])
@pytest.mark.parametrize('C_in,C_out', [(3, 64), (64, 3), (3, 3), (3, 130)])
def test_narrow_widths(gen, K3, C_in, C_out):
    """C_in <= 4 (the stem) and C_out <= 4 (the stem's input gradient)
    take the narrow paths; the dW of C_in <= 4 its narrow path."""
    B, V_in, V_out = 2, 3000, 2100
    feats = torch.randn(B, V_in, C_in, device='cuda', generator=gen)
    nbr = _random_map(gen, B, V_in, V_out, K3, 0.3)
    w = torch.randn(K3, C_in, C_out, device='cuda', generator=gen) * 0.1
    out_mask = torch.rand(B, V_out, device='cuda', generator=gen) > 0.1
    assert sp.conv_launch_shape(B, V_out, K3, C_in, C_out, 132)[0] != 'tile'
    _all_three(gen, feats, nbr, w, out_mask)


def test_all_miss_map(gen):
    """No row hits any offset: zero outputs and a zero dW."""
    B, V = 2, 700
    nbr = torch.full((B, V, 27), -1, dtype=torch.int32, device='cuda')
    mask = torch.ones(B, V, dtype=torch.bool, device='cuda')
    for C_in, C_out in ((3, 64), (64, 64), (64, 3)):
        feats = torch.randn(B, V, C_in, device='cuda', generator=gen)
        w = torch.randn(27, C_in, C_out, device='cuda', generator=gen)
        assert torch.equal(sp.sparse_conv_cuda(feats, nbr, w, mask),
                           torch.zeros(B, V, C_out, device='cuda'))
        g = torch.randn(B, V, C_out, device='cuda', generator=gen)
        assert torch.equal(sp.sparse_conv_dw_cuda(feats, nbr, g),
                           torch.zeros(27, C_in, C_out, device='cuda'))


def test_every_row_the_same_mask(gen):
    """One hit pattern over all rows: every tile walks the same offsets."""
    B, V_in, V_out, C = 2, 900, 1000, 96
    nbr = torch.randint(0, V_in, (B, V_out, 27), device='cuda', generator=gen)
    pattern = torch.rand(27, device='cuda', generator=gen) < 0.4
    nbr = torch.where(pattern, nbr, -1).int()
    plan = sp.conv_plan(nbr)
    assert int(torch.unique(plan.row_mask).numel()) == 1
    feats = torch.randn(B, V_in, C, device='cuda', generator=gen)
    w = torch.randn(27, C, C, device='cuda', generator=gen) * 0.1
    mask = torch.ones(B, V_out, dtype=torch.bool, device='cuda')
    _all_three(gen, feats, nbr, w, mask, plan)


@pytest.mark.parametrize('V_out', [129, 1000, 8191])
def test_rows_not_a_multiple_of_the_tile(gen, V_out):
    B, V_in, C_in, C_out = 2, 1500, 36, 72
    feats = torch.randn(B, V_in, C_in, device='cuda', generator=gen)
    nbr = _random_map(gen, B, V_in, V_out, 27, 0.35)
    w = torch.randn(27, C_in, C_out, device='cuda', generator=gen) * 0.1
    out_mask = torch.rand(B, V_out, device='cuda', generator=gen) > 0.2
    _all_three(gen, feats, nbr, w, out_mask)


def test_offset_split_path_at_a_small_level(gen):
    """A stage-4-like level (1000 rows, 512 -> 256): too few tiles for
    the card, so the offsets are split across blocks and added in order;
    the same bits twice."""
    B, V, C_in, C_out = 2, 1000, 512, 256
    path, rows, splits = sp.conv_launch_shape(
        B, V, 27, C_in, C_out, _cuda.sm_count(torch.device('cuda')))
    assert path == 'tile' and splits > 1
    feats = torch.randn(B, V, C_in, device='cuda', generator=gen)
    nbr = _random_map(gen, B, V, V, 27, 0.4)
    w = torch.randn(27, C_in, C_out, device='cuda', generator=gen) * 0.05
    mask = torch.rand(B, V, device='cuda', generator=gen) > 0.3
    got = sp.sparse_conv_cuda(feats, nbr, w, mask)
    _close(got, sp.sparse_conv_apply(feats, nbr, w, mask))
    assert torch.equal(sp.sparse_conv_cuda(feats, nbr, w, mask), got)


@pytest.mark.parametrize('C_in', [3, 64, 256])
def test_dw_bit_equal_over_splits(gen, C_in):
    """dW with at least two splits of one offset's hits: the same bits on
    a rerun."""
    B, V, C_out = 2, 6000, 64
    feats = torch.randn(B, V, C_in, device='cuda', generator=gen)
    nbr = _random_map(gen, B, V, V, 27, 0.4)
    g = torch.randn(B, V, C_out, device='cuda', generator=gen)
    plan = sp.conv_plan(nbr)
    _, _, target, _ = sp.dw_launch_shape(B * V, 27, C_in, C_out,
                                         _cuda.sm_count(torch.device('cuda')))
    _, S = sp.dw_split_table(plan.hit_counts.tolist(), target)
    assert max(S) >= 2
    got = sp.sparse_conv_dw_cuda(feats, nbr, g, plan)
    _close(got, sp.sparse_conv_dw_plain(feats, nbr, g))
    assert torch.equal(sp.sparse_conv_dw_cuda(feats, nbr, g, plan), got)


def _cuda_level_and_map(gen, self_map, C_in):
    pts = torch.rand(2, 4000, 3, device='cuda', generator=gen) * 2.5
    mask = torch.rand(2, 4000, device='cuda', generator=gen) < 0.95
    lvl = sp.voxelize_points(pts, mask, pts, 0.05, 3000, (64, 64, 64))
    out = lvl if self_map else sp.downsample_coords(lvl, 1500)
    nbr = sp.build_neighbor_map(lvl, out, 3, 1 if self_map else 2)
    f = torch.randn(2, 3000, C_in, device='cuda', generator=gen)
    return torch.where(lvl.mask[..., None], f, torch.zeros_like(f)), nbr, \
        out.mask


@pytest.mark.parametrize('self_map', [True, False])
def test_sparse_conv_backward_on_card(gen, self_map):
    """The autograd.Function's kernels (forward, mirrored or reversed
    dfeats, dW) against autograd of the plain conv on a real map."""
    f0, nbr, mask = _cuda_level_and_map(gen, self_map, 32)
    w0 = torch.randn(27, 32, 48, device='cuda', generator=gen) * 0.1
    cot = torch.randn(2, nbr.shape[1], 48, device='cuda', generator=gen)
    grads = []
    for conv in (lambda f, w: sp.sparse_conv(f, nbr, w, mask, self_map),
                 lambda f, w: sp.sparse_conv_apply(f, nbr, w, mask)):
        f = f0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        (conv(f, w) * cot).sum().backward()
        grads.append((f.grad, w.grad))
    for got, want in zip(*grads):
        _close(got, want)


@pytest.mark.parametrize('rows,C,n', [(14336, 64, 256), (50, 4, 13),
                                      (1000, 132, 300)])
def test_row_gather_kernel(gen, rows, C, n):
    """The probe's shapes, a row of one float4, and rows wider than the 16
    lanes' step with a ragged last block."""
    if (rows, C, n) == (gather_probe.ROWS, gather_probe.C, gather_probe.T):
        table, idx = gather_probe.probe_inputs('cuda')
    else:
        table = torch.randn(rows, C, device='cuda', generator=gen)
        idx = torch.randint(0, rows, (n, ), device='cuda', generator=gen)
        idx = idx.int()
    assert torch.equal(gather_probe.row_gather(table, idx),
                       gather_probe.row_gather_plain(table, idx))


def test_row_gather_refuses_what_it_cannot_copy(gen):
    """A width that is not a multiple of 4 floats, or a table off a
    16-byte boundary: the kernel returns an error and the wrapper
    raises; no other path runs."""
    table, idx = gather_probe.probe_inputs('cuda')
    with pytest.raises(RuntimeError, match='ptt_row_gather'):
        gather_probe.row_gather_cuda(table[:, :6].contiguous(), idx)
    flat = torch.empty(table.numel() + 1, device='cuda')
    shifted = flat[1:].view(table.shape)
    shifted.copy_(table)
    with pytest.raises(RuntimeError, match='ptt_row_gather'):
        gather_probe.row_gather_cuda(shifted, idx)
    with pytest.raises(RuntimeError, match='ptt_row_gather'):
        gather_probe.row_gather(table[:, :6], idx)


def _grad_tol(want, grad_norm):
    """Per tensor: 5e-4 of its largest entry (float32 sums in another
    order through ~20 sparse convs and train-mode norms) plus 1e-6 of the
    global gradient norm (entries whose true value is 0, like a bias
    before a train-mode BatchNorm, hold only rounding noise); the CPU
    milestone against the JAX package holds gradients to the same."""
    return 5e-4 * float(want.abs().max()) + 1e-6 * grad_norm


def test_tiny_train_step_card_vs_cpu(gen):
    """One train step of the tiny grounder on the card and on the CPU
    (plain versions), same weights and the same seeded dropout masks:
    losses within 1e-4 relative, every gradient within `_grad_tol`, and
    each updated entry within 1e-6 + 1e-5·max plus 2.2·lr·min(1,
    tol_g/|g|): Adam's first step moves an entry by about lr·sign(g), so
    only an entry whose gradient is at rounding level may move by ±lr
    either way."""
    outs = []
    for device in ('cuda', 'cpu'):
        model, batch = _tiny_grounder_and_batch()
        if device == 'cpu':
            model = model.cpu()
            batch = {k: v.cpu() for k, v in batch.items()}
        rng = np.random.RandomState(0)
        B, G = 2, 3
        gt = np.concatenate([rng.uniform(0.5, 2.5, (B, G, 3)),
                             rng.uniform(0.3, 1.0, (B, G, 3)),
                             rng.uniform(-0.5, 0.5, (B, G, 3))], -1)
        pm = np.zeros((B, G, 64), np.float32)
        pm[:, :, 1] = 1
        batch.update(batch_to_device({'gt_bboxes': gt.astype(np.float32),
                                      'gt_masks': np.ones((B, G), bool),
                                      'positive_maps': pm}, device))
        for name, mod in model.named_modules():
            if isinstance(mod, Dropout):
                seed = sum(map(ord, name))
                mod.draw = (lambda shape, dev, generator, seed=seed:
                            torch.from_numpy(np.random.RandomState(seed)
                                             .rand(*shape) < 0.8).to(dev))
        step = make_train_step(model, build_optimizer(model),
                               build_lr_schedule(BASE_LR, steps_per_epoch=1))
        metrics = step(batch)
        outs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}))
    (m_gpu, g_gpu, s_gpu), (m_cpu, g_cpu, s_cpu) = outs
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * abs(v) + 1e-6, k
    gn = m_cpu['grad_norm']
    assert set(g_gpu) == set(g_cpu)
    bad = [(k, float((g_gpu[k] - v).abs().max())) for k, v in g_cpu.items()
           if float((g_gpu[k] - v).abs().max()) > _grad_tol(v, gn)]
    assert not bad, f'{bad[:5]} ({len(bad)} of {len(g_cpu)})'
    bad = []
    for k, v in s_cpu.items():
        tol = 1e-6 + 1e-5 * float(v.abs().max())
        if k in g_cpu:
            g = g_cpu[k].abs()
            tol = tol + 2.2 * BASE_LR * torch.clamp(
                _grad_tol(g, gn) / torch.clamp(g, min=1e-30), max=1.0)
        if bool(((s_gpu[k] - v).abs() > tol).any()):
            bad.append((k, float((s_gpu[k] - v).abs().max())))
    assert not bad, bad[:5]


# --------------------------------------------------------------------------
# the bf16 form of the sparse-conv kernels (bf16 tensor cores)
# --------------------------------------------------------------------------
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits), float32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _close_bf16(got, want):
    """Two roundings to bf16 of float32 sums taken in another order: at
    most one bf16 ulp of the larger apart, plus the float32 tolerance
    (which matters where a sum cancels to near zero)."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.float(), want.float()
    tol = (_bf16_ulp(torch.maximum(g.abs(), w.abs()))
           + 1e-4 * (1.0 + float(w.abs().max())))
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (float((g - w).abs().max()),
                                 int(bad.sum()))


BF16_CONV_CASES = [
    # V_in, V_out, K3, C_in, C_out, hit: model widths, a width the wrapper
    # pads (3, 33, 200, 36 -> 72), 128- and 64-wide column blocks
    (3000, 2000, 27, 64, 64, 0.3), (3000, 3000, 27, 64, 96, 0.3),
    (1000, 800, 8, 200, 33, 0.5), (500, 130, 27, 1024, 256, 0.2),
    (1500, 1000, 27, 36, 72, 0.35), (2000, 1500, 27, 3, 64, 0.3),
    (400, 300, 27, 16, 16, 0.0), (6000, 6000, 27, 256, 128, 0.4)]


def _bf16_conv_inputs(gen, V_in, V_out, K3, C_in, C_out, hit, B=2):
    feats = torch.randn(B, V_in, C_in, device='cuda',
                        generator=gen).bfloat16()
    nbr = _random_map(gen, B, V_in, V_out, K3, hit)
    w = torch.randn(K3, C_in, C_out, device='cuda', generator=gen) * 0.1
    out_mask = torch.rand(B, V_out, device='cuda', generator=gen) > 0.2
    return feats, nbr, w, out_mask


# the forward / dfeats body's launch shapes (`sp.bf16_tile_launch`): every
# wgmma N (64, 128, 256) and stage width (kc 64; 32 from C_in 96; 16 from
# 48), C_out 512 in two column blocks, V_out off the 128-row tile, an
# all-miss map at full width, K3 = 8 at kc 64, splits > 1
BF16_WGMMA_CASES = [
    (2500, 2000, 27, 128, 128, 0.3), (1500, 1300, 27, 256, 256, 0.35),
    (1200, 1000, 27, 512, 512, 0.3), (900, 700, 27, 48, 48, 0.3),
    (1000, 800, 27, 96, 160, 0.3), (900, 777, 8, 256, 64, 0.5),
    (400, 300, 27, 256, 512, 0.0), (3000, 1234, 27, 64, 256, 0.25)]


@pytest.mark.parametrize('V_in,V_out,K3,C_in,C_out,hit',
                         BF16_CONV_CASES + BF16_WGMMA_CASES)
def test_sparse_conv_bf16_kernel(gen, V_in, V_out, K3, C_in, C_out, hit):
    """Forward and input-gradient bf16 kernels against the plain bf16
    conv: float32 out within the float32 tolerance, bf16 out within one
    bf16 ulp; zero at masked outputs; the same bits twice."""
    feats, nbr, w, out_mask = _bf16_conv_inputs(gen, V_in, V_out, K3, C_in,
                                                C_out, hit)
    want32 = sp.sparse_conv_apply_bf16(feats.float(), nbr, w, out_mask)
    want16 = sp.sparse_conv_apply_bf16(feats, nbr, w, out_mask)
    for launch in (sp.sparse_conv_bf16_cuda, sp.sparse_conv_dfeats_bf16_cuda):
        got32 = launch(feats, nbr, w, out_mask, out_dtype=torch.float32)
        assert got32.dtype == torch.float32
        _close(got32, want32)
        got16 = launch(feats, nbr, w, out_mask)
        _close_bf16(got16, want16)
        assert torch.all(got16[~out_mask] == 0)
        assert torch.equal(launch(feats, nbr, w, out_mask), got16)


# the dW body's launch shapes (`sp.bf16_dw_launch`): C_in and C_out of 64,
# 128, 256 and 512, equal and not (every (BM, BN) of the kernel), widths
# padded to the block from 48 and from 16, K3 = 27 and 8, classes that
# split (max_splits > K3: C_in x C_out up to 256 x 256) and that do not
# (512 x 512, 1024 x 256), offsets of more than 4096 hits (V_out = 20000,
# 12000); every case also empties offset K3 - 1, and 0.0 maps miss
# everywhere
BF16_DW_CASES = [
    (20000, 20000, 27, 64, 64, 0.4), (12000, 12000, 27, 128, 128, 0.4),
    (6000, 6000, 27, 256, 256, 0.45), (2000, 2000, 27, 512, 512, 0.45),
    (3000, 2500, 27, 64, 128, 0.3), (2500, 2000, 27, 128, 256, 0.3),
    (1500, 1200, 27, 256, 512, 0.3), (1200, 1000, 27, 512, 256, 0.3),
    (900, 800, 27, 1024, 256, 0.3), (1000, 900, 27, 128, 64, 0.3),
    (1500, 1400, 27, 48, 16, 0.3), (1500, 1400, 27, 16, 48, 0.3),
    (1000, 777, 8, 256, 64, 0.5), (5000, 4000, 8, 64, 256, 0.5),
    (800, 600, 27, 512, 512, 0.0), (700, 500, 8, 64, 64, 0.0)]


@pytest.mark.parametrize('V_in,V_out,K3,C_in,C_out,hit',
                         BF16_CONV_CASES + BF16_DW_CASES)
def test_sparse_conv_dw_bf16_kernel(gen, V_in, V_out, K3, C_in, C_out, hit):
    """The bf16 dW kernel against the plain bf16 dW (float32 out), an
    offset without a hit exactly zero, and the same bits on a rerun (no
    float atomics)."""
    feats, nbr, _, _ = _bf16_conv_inputs(gen, V_in, V_out, K3, C_in, C_out,
                                         hit)
    nbr[..., K3 - 1] = -1
    g = torch.randn(2, V_out, C_out, device='cuda', generator=gen).bfloat16()
    got = sp.sparse_conv_dw_bf16_cuda(feats, nbr, g)
    assert got.dtype == torch.float32
    _close(got, sp.sparse_conv_dw_plain_bf16(feats, nbr, g))
    assert bool((got[K3 - 1] == 0).all())
    assert torch.equal(sp.sparse_conv_dw_bf16_cuda(feats, nbr, g), got)


@pytest.mark.parametrize('C', [64, 256])
def test_bf16_dw_split_and_direct_offsets(gen, C):
    """A call in which some offsets split and others do not (a few
    offsets hold most hits): against the plain bf16 dW, the same bits
    twice; the split table on the device equals its mirror."""
    B, V, K3 = 2, 6000, 27
    feats = torch.randn(B, V, C, device='cuda', generator=gen).bfloat16()
    nbr = _random_map(gen, B, V, V, K3, 0.02)
    nbr[..., :3] = _random_map(gen, B, V, V, 3, 0.9)
    g = torch.randn(B, V, C, device='cuda', generator=gen).bfloat16()
    plan = sp.conv_plan(nbr)
    cut = sp.bf16_dw_launch(K3, C, C, _cuda.sm_count(torch.device('cuda')))
    _, S = sp.bf16_dw_split_table(plan.hit_counts.tolist(), cut.max_splits)
    assert max(S) > 1 and min(S) == 1
    got = sp.sparse_conv_dw_bf16_cuda(feats, nbr, g, plan)
    _close(got, sp.sparse_conv_dw_plain_bf16(feats, nbr, g))
    assert torch.equal(sp.sparse_conv_dw_bf16_cuda(feats, nbr, g, plan), got)


@pytest.mark.parametrize('K3,max_splits', [(27, 132), (27, 66), (27, 27),
                                           (8, 132), (32, 40), (1, 5)])
def test_bf16_dw_table_matches_mirror(gen, K3, max_splits):
    """The device's dW split table (`dw_plan`) equals
    `sp.bf16_dw_split_table` on skewed, sparse and empty counts."""
    lib = _cuda._library('sparse_conv_bf16')
    fn = lib.ptt_sparse_conv_dw_bf16_table
    fn.argtypes = [_cuda.ptr, _cuda.i32, _cuda.i32, _cuda.ptr, _cuda.ptr]
    fn.restype = _cuda.i32
    rng = np.random.RandomState(K3 * max_splits)
    for counts in ([int(x) for x in 60_000 * rng.rand(K3) ** 3],
                   [int(x) if rng.rand() < 0.5 else 0
                    for x in 9000 * rng.rand(K3)],
                   [0] * K3, [rng.randint(0, 300) for _ in range(K3)]):
        dev = torch.tensor(counts, dtype=torch.int32, device='cuda')
        out = torch.full((1 + K3, ), -1, dtype=torch.int32, device='cuda')
        assert fn(dev.data_ptr(), K3, max_splits, out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream) == 0
        chunk, S = sp.bf16_dw_split_table(counts, max_splits)
        assert out.tolist() == [chunk, *S]


def test_bf16_dw_launch_smem_matches_kernel(gen):
    """The shared memory `sp.bf16_dw_stage_shape` computes for each dW
    block shape is what the kernel library allocates, within an H100
    block's 227 KB; shapes the kernel does not take are refused."""
    lib = _cuda._library('sparse_conv_bf16')
    fn = lib.ptt_sparse_conv_dw_bf16_smem
    fn.argtypes = [_cuda.i32, _cuda.i32]
    fn.restype = _cuda.i32
    for bm in (64, 128):
        for bn in (64, 128, 256):
            smem = sp.bf16_dw_stage_shape(bm, bn)[1]
            assert fn(bm, bn) == smem <= sp.SMEM_PER_BLOCK
    assert fn(32, 64) == fn(128, 512) == fn(256, 256) == -1


def test_bf16_kernels_round_float32_inputs(gen):
    """float32 operands are rounded to bf16 by the wrapper: the same
    result as bf16 operands."""
    feats, nbr, w, out_mask = _bf16_conv_inputs(gen, 1200, 900, 27, 48, 80,
                                                0.3)
    f32 = feats.float() + 1e-3 * torch.randn(feats.shape, device='cuda',
                                             generator=gen)
    assert torch.equal(
        sp.sparse_conv_bf16_cuda(f32, nbr, w, out_mask),
        sp.sparse_conv_bf16_cuda(f32.bfloat16(), nbr, w.bfloat16(), out_mask,
                                 out_dtype=torch.float32))
    g = torch.randn(2, 900, 80, device='cuda', generator=gen)
    assert torch.equal(sp.sparse_conv_dw_bf16_cuda(f32, nbr, g),
                       sp.sparse_conv_dw_bf16_cuda(f32.bfloat16(), nbr,
                                                   g.bfloat16()))


@pytest.mark.parametrize('B,V,C_in,C_out', [
    (2, 1000, 512, 256), (2, 700, 256, 512), (1, 300, 128, 64),
    (2, 500, 96, 48), (1, 130, 1024, 256)])
def test_bf16_offset_split_path(gen, B, V, C_in, C_out):
    """Small levels in bf16: offsets split across blocks, the float32
    partials added in order and rounded once (bf16 out) or not (float32
    out); the same bits twice."""
    launch = sp.bf16_tile_launch(B, V, sp._round_step(C_in),
                                 sp._round_step(C_out),
                                 _cuda.sm_count(torch.device('cuda')))
    assert launch.splits > 1
    feats, nbr, w, mask = _bf16_conv_inputs(gen, V, V, 27, C_in, C_out, 0.4,
                                            B=B)
    got = sp.sparse_conv_bf16_cuda(feats, nbr, w, mask)
    _close_bf16(got, sp.sparse_conv_apply_bf16(feats, nbr, w, mask))
    assert torch.equal(sp.sparse_conv_bf16_cuda(feats, nbr, w, mask), got)
    got32 = sp.sparse_conv_dfeats_bf16_cuda(feats, nbr, w, mask,
                                            out_dtype=torch.float32)
    _close(got32, sp.sparse_conv_apply_bf16(feats.float(), nbr, w, mask))


@pytest.mark.parametrize('C_in,C_out', [(64, 64), (256, 256), (48, 64)])
def test_bf16_dense_product(gen, C_in, C_out):
    """K3 = 1 over the identity map: the kernel is a dense product of the
    features and W[0], against torch.matmul of the bf16 values in
    float32 (one wgmma N and stage width each)."""
    B, V = 2, 1000
    feats = torch.randn(B, V, C_in, device='cuda', generator=gen).bfloat16()
    w = (torch.randn(1, C_in, C_out, device='cuda', generator=gen) * 0.1
         ).bfloat16()
    nbr = torch.arange(V, dtype=torch.int32, device='cuda').expand(
        B, V)[..., None].contiguous()
    mask = torch.ones(B, V, dtype=torch.bool, device='cuda')
    got = sp.sparse_conv_bf16_cuda(feats, nbr, w, mask,
                                   out_dtype=torch.float32)
    _close(got, feats.float() @ w[0].float())


def test_bf16_warpgroup_skips_an_offset(gen):
    """A tile whose first warpgroup's 64 rows hit offset 0 only and whose
    second's hit offsets 0 and 1 (rows sort by hit mask): the first
    skips offset 1's stages, and both match the plain conv."""
    B, V, C = 1, 128, 128
    feats = torch.randn(B, 300, C, device='cuda', generator=gen).bfloat16()
    nbr = torch.randint(0, 300, (B, V, 2), device='cuda', generator=gen,
                        dtype=torch.int32)
    nbr[0, ::2, 1] = -1  # even rows: mask 0b01, odd rows: 0b11
    w = torch.randn(2, C, C, device='cuda', generator=gen) * 0.1
    mask = torch.ones(B, V, dtype=torch.bool, device='cuda')
    plan = sp.conv_plan(nbr)
    masks = plan.row_mask.gather(1, plan.order.long())[0]
    assert bool((masks[:64] == 1).all() and (masks[64:] == 3).all())
    got = sp.sparse_conv_bf16_cuda(feats, nbr, w, mask, plan, torch.float32)
    _close(got, sp.sparse_conv_apply_bf16(feats.float(), nbr, w, mask))


@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('V', [20000, 900])
def test_bf16_conv_same_bits_twice(gen, V, out_dtype):
    """Two launches of the forward and of dfeats give the same bits, with
    splits (V = 900) and without (V = 20000): no atomics, the split
    partials added in a fixed order."""
    feats, nbr, w, mask = _bf16_conv_inputs(gen, V, V, 27, 128, 256, 0.3)
    for launch in (sp.sparse_conv_bf16_cuda, sp.sparse_conv_dfeats_bf16_cuda):
        a = launch(feats, nbr, w, mask, out_dtype=out_dtype)
        b = launch(feats, nbr, w, mask, out_dtype=out_dtype)
        assert torch.equal(a, b)


def test_bf16_launch_smem_matches_kernel(gen):
    """The shared memory `sp.bf16_stage_shape` computes for each launch
    shape is what the kernel library allocates, within an H100 block's
    227 KB; shapes the kernel does not take are refused."""
    lib = _cuda._library('sparse_conv_bf16')
    fn = lib.ptt_sparse_conv_bf16_smem
    fn.argtypes = [_cuda.i32, _cuda.i32]
    fn.restype = _cuda.i32
    for kc, bn in ((64, 64), (64, 128), (64, 256), (32, 64), (16, 64)):
        smem = sp.bf16_stage_shape(kc, bn)[1]
        assert fn(kc, bn) == smem <= sp.SMEM_PER_BLOCK
    assert fn(32, 128) == fn(16, 256) == fn(8, 64) == -1


@pytest.mark.parametrize('self_map', [True, False])
def test_sparse_conv_bf16_backward_on_card(gen, self_map):
    """The conv autograd.Function in bf16 (bf16 forward, mirrored or
    reversed bf16 dfeats, bf16 dW) against autograd of the plain bf16
    conv on a real map: dfeats within one bf16 ulp (both round a float32
    sum once), dW within one bf16 ulp of the plain one, which autograd
    rounds to bf16 at the weights' cast."""
    f0, nbr, mask = _cuda_level_and_map(gen, self_map, 32)
    f0 = f0.bfloat16()
    w0 = torch.randn(27, 32, 48, device='cuda', generator=gen) * 0.1
    cot = torch.randn(2, nbr.shape[1], 48, device='cuda',
                      generator=gen).bfloat16()
    grads = []
    for conv in (lambda f, w: sp.sparse_conv(f, nbr, w, mask, self_map),
                 lambda f, w: sp.sparse_conv_apply_bf16(f, nbr, w, mask)):
        f = f0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        out = conv(f, w)
        assert out.dtype == torch.bfloat16
        (out.float() * cot.float()).sum().backward()
        grads.append((f.grad, w.grad))
    (gf, gw), (wf, ww) = grads
    assert gf.dtype == torch.bfloat16 and gw.dtype == torch.float32
    _close_bf16(gf, wf)
    err = (gw - ww).abs()
    assert bool((err <= _bf16_ulp(ww) + 1e-4 * (1 + float(ww.abs().max())))
                .all()), float(err.max())


def test_bf16_wrappers_refuse_other_types(gen):
    feats, nbr, w, mask = _bf16_conv_inputs(gen, 300, 200, 27, 16, 16, 0.3)
    with pytest.raises(ValueError, match='feats'):
        sp.sparse_conv_bf16_cuda(feats.half(), nbr, w, mask)
    with pytest.raises(ValueError, match='out_dtype'):
        sp.sparse_conv_bf16_cuda(feats, nbr, w, mask, out_dtype=torch.half)
    with pytest.raises(ValueError, match='g'):
        sp.sparse_conv_dw_bf16_cuda(feats, nbr, torch.zeros(
            2, 200, 16, dtype=torch.half, device='cuda'))


# --------------------------------------------------------------------------
# the runtime: the Runner on the card
# --------------------------------------------------------------------------
def test_runner_tiny_config_card_vs_cpu(gen, tmp_path, monkeypatch):
    """configs/grounding/synthetic_smoke.py through the Runner for one
    epoch (4 steps) on the card and on the CPU: the same seeded weights
    (drawn on the CPU), the same batches and the same dropout masks (one
    numpy stream per run, injected through `Dropout.draw`); the first
    step's losses, total and grad norm within the train step's 1e-4
    relative, every step's finite."""
    from pathlib import Path
    from proxytransformation_torch.engine.runner import Runner
    from proxytransformation_torch.utils.config import Config
    path = (Path(__file__).resolve().parents[1]
            / 'configs/grounding/synthetic_smoke.py')
    logs = {}
    for device in ('cuda', 'cpu'):
        masks = np.random.RandomState(0)
        monkeypatch.setattr(
            Dropout, 'draw', lambda self, shape, dev, generator, rs=masks:
            torch.from_numpy(rs.rand(*shape) < 0.8).to(dev))
        cfg = Config.fromfile(str(path))
        cfg.merge_from_dict({'train_cfg.val_interval': 99})
        runner = Runner(cfg, str(tmp_path / device), device=device)
        runner.train()
        assert runner.device.type == device
        logs[device] = runner.train_log
    assert [r['iter'] for r in logs['cuda']] == [1, 2, 3, 4]
    for rec in logs['cuda']:
        assert all(np.isfinite(v) for v in rec.values())
    got, want = logs['cuda'][0], logs['cpu'][0]
    for k in ('loss_cls', 'loss_bbox', 'd0.loss_cls', 'd0.loss_bbox',
              'total_loss', 'grad_norm'):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-6, k


# --------------------------------------------------------------------------
# occupancy: the bilinear painting and the tiny Runner, card vs CPU
# --------------------------------------------------------------------------
def test_bilinear_painting_card_vs_cpu(gen):
    """`batch_point_sample(aligned=True)` on the card against the CPU on
    the same inputs: within 1e-6 · (1 + max|x|)."""
    from proxytransformation_torch.models.point_fusion import (
        batch_point_sample)
    rng = np.random.RandomState(3)
    B, V, Hf, Wf, C, N, H, W = 2, 5, 30, 40, 16, 5000, 120, 160
    feats = rng.randn(B, V, Hf, Wf, C).astype(np.float32)
    pts = rng.uniform([-2, -2, -0.5], [2, 2, 3], (B, N, 3)).astype(np.float32)
    proj = np.tile(np.array([[90, 0, W / 2, 0], [0, 90, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    proj[:, :, 0, 3] = rng.uniform(-20, 20, (B, V))
    views = rng.rand(B, V) > 0.2
    args = [torch.from_numpy(a) for a in (feats, pts, proj)]
    want = batch_point_sample(*args, (H, W), views_mask=torch.from_numpy(
        views), aligned=True)
    got = batch_point_sample(*[a.cuda() for a in args], (H, W),
                             views_mask=torch.from_numpy(views).cuda(),
                             aligned=True)
    err = float((got.cpu() - want).abs().max())
    assert err <= 1e-6 * (1 + float(want.abs().max())), err
    assert bool((want != 0).any(-1).float().mean() > 0.3)


@pytest.mark.parametrize('mtype', ['EmbodiedOccPredictor',
                                   'DenseFusionOccPredictor'])
def test_tiny_occupancy_runner_card_vs_cpu(gen, tmp_path, mtype):
    """configs/occupancy/synthetic_smoke.py (one step, val) through the
    Runner on the card and on the CPU from the same seeded fresh weights:
    the first step's losses within 1e-5 relative; then val on the card
    with the CPU run's trained weights gives the CPU's results."""
    from proxytransformation_torch.engine.runner import Runner
    from proxytransformation_torch.utils.config import Config
    runners = {}
    for device in ('cpu', 'cuda'):
        cfg = Config.fromfile('configs/occupancy/synthetic_smoke.py')
        cfg.merge_from_dict(Config.parse_cfg_options([
            'train_dataloader.dataset.length=2', f'model.type={mtype!r}']))
        runners[device] = Runner(cfg, str(tmp_path / device), device=device)
        runners[device].train()
    cpu, card = runners['cpu'], runners['cuda']
    for k, v in cpu.train_log[0].items():
        if k.startswith('loss_') or k == 'total_loss':
            assert abs(card.train_log[0][k] - v) <= 1e-5 * abs(v), k
    card.model.load_state_dict(cpu.model.state_dict())
    want = cpu.val(init_state=False)
    got = card.val(init_state=False)
    assert set(got) == set(want) and 'mIoU' in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3, (k, got[k], v)


# --------------------------------------------------------------------------
# the text towers, the bottleneck's and the brick stages' convs
# --------------------------------------------------------------------------
BASE_TOWERS = ('bert-base-uncased', 'roberta-base', 'facebook/flava-full',
               't5-base', 'deberta-base', 'clip-vit-base-patch32',
               'eva02-l-14-336')


@pytest.mark.parametrize('t_type', BASE_TOWERS)
def test_text_tower_card_vs_cpu(gen, t_type):
    """A base-size tower on the card against the same weights on the CPU,
    within 1e-4 · (1 + max|cpu|), one padded row."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.text_variants import (
        build_text_encoder)
    cpu, _ = build_text_encoder(t_type)
    flax_init_(cpu, torch.Generator().manual_seed(0))
    card, _ = build_text_encoder(t_type)
    card.load_state_dict(cpu.state_dict())
    card.to('cuda')
    rng = np.random.RandomState(0)
    ids = rng.randint(0, min(cpu.vocab_size, 30000), (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    mask[1, 20:] = False
    with torch.no_grad():
        want = cpu(torch.from_numpy(ids), torch.from_numpy(mask))
        got = card(torch.from_numpy(ids).cuda(),
                   torch.from_numpy(mask).cuda()).cpu()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * (1 + float(want.abs().max())), err


def _level(gen, B, n, span, cap, extent=(512, 512, 512)):
    pts = torch.rand(B, n, 3, device='cuda', generator=gen) * span
    mask = torch.ones(B, n, dtype=torch.bool, device='cuda')
    mask[-1, n * 3 // 4:] = False
    return sp.voxelize_points(pts, mask, pts, 0.01, cap, extent)


@pytest.mark.parametrize('C', [64, 128])
def test_brick_conv_at_8c_widths(gen, C):
    """Pack, the brick conv at C_in = C_out = 8C (512, 1024), unpack: each
    kernel call against its plain version, and the whole against the
    cell conv."""
    from proxytransformation_torch.ops import brick
    lvl = _level(gen, 2, 20000, 1.0, 20000)
    feats = torch.randn(2, 20000, C, device='cuda', generator=gen)
    feats = torch.where(lvl.mask[..., None], feats, 0.0)
    w = torch.randn(27, C, C, device='cuda', generator=gen) / (27 * C) ** 0.5
    blvl, pmap, unb8, _ = brick.build_brick_level(lvl, 20000)
    bnbr = sp.build_neighbor_map(blvl, blvl, 3, 1)
    bf = brick.brick_pack(feats, pmap, unb8, blvl.mask, lvl.mask)
    wb = brick.brick_expand(w)
    assert wb.shape == (27, 8 * C, 8 * C)
    bo = sp.sparse_conv(bf, bnbr, wb, blvl.mask, self_map=True)
    plain = sp.sparse_conv_apply(bf, bnbr, wb, blvl.mask)
    tol = 1e-4 * (1 + float(plain.abs().max()))
    assert float((bo - plain).abs().max()) <= tol
    out = brick.brick_unpack(bo, pmap, unb8, blvl.mask, lvl.mask)
    cell = sp.sparse_conv_apply(feats, sp.build_neighbor_map(lvl, lvl, 3, 1),
                                w, lvl.mask)
    assert float((out - cell).abs().max()) <= 1e-4 * (
        1 + float(cell.abs().max()))
    assert torch.equal(brick.brick_unpack(bf, pmap, unb8, blvl.mask,
                                          lvl.mask), feats)


@pytest.mark.parametrize('C', [64, 128])
def test_brick_conv_bf16_at_8c_widths(gen, C):
    """The bf16 form at the brick widths (8C = 512 and 1024 in and out,
    `bf16_tile_launch`'s column blocks 2 and 4): pack, conv and unpack
    against the plain bf16 conv, float32 out within the float32
    tolerance, bf16 out within one bf16 ulp."""
    from proxytransformation_torch.ops import brick
    lvl = _level(gen, 2, 20000, 1.0, 20000)
    feats = torch.randn(2, 20000, C, device='cuda', generator=gen)
    feats = torch.where(lvl.mask[..., None], feats, 0.0).to(torch.bfloat16)
    w = torch.randn(27, C, C, device='cuda', generator=gen) / (27 * C) ** 0.5
    blvl, pmap, unb8, _ = brick.build_brick_level(lvl, 20000)
    bnbr = sp.build_neighbor_map(blvl, blvl, 3, 1)
    bf = brick.brick_pack(feats, pmap, unb8, blvl.mask, lvl.mask)
    assert bf.dtype == torch.bfloat16
    wb = brick.brick_expand(w)
    cut = sp.bf16_tile_launch(2, blvl.capacity, 8 * C, 8 * C,
                              _cuda.sm_count(bf.device))
    assert cut.col_blocks == 8 * C // 256
    _close(sp.sparse_conv_bf16_cuda(bf, bnbr, wb, blvl.mask.contiguous(),
                                    out_dtype=torch.float32),
           sp.sparse_conv_apply_bf16(bf.float(), bnbr, wb, blvl.mask))
    bo = sp.sparse_conv(bf, bnbr, wb, blvl.mask, self_map=True)
    _close_bf16(bo, sp.sparse_conv_apply_bf16(bf, bnbr, wb, blvl.mask))
    assert torch.equal(brick.brick_unpack(bf, pmap, unb8, blvl.mask,
                                          lvl.mask), feats)


def test_bottleneck_convs_on_card(gen):
    """MinkResNet-50's eval forward on the card against its CPU plain
    path on the same weights and level: every stage within 1e-4 ·
    (1 + max)."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.sparse_resnet import MinkResNet
    caps = (20000, 20000, 12000, 6000, 3000, 1500)
    cpu = MinkResNet(50, 3, caps, norm='batch')
    flax_init_(cpu, torch.Generator().manual_seed(0))
    card = MinkResNet(50, 3, caps, norm='batch').cuda()
    card.load_state_dict(cpu.state_dict())
    lvl = _level(gen, 2, 20000, 2.0, caps[0])
    cpu_lvl = sp.SparseLevel(*(getattr(lvl, f).cpu() for f in (
        'keys', 'coords', 'feats', 'mask', 'origin')), lvl.extent,
        lvl.stride, lvl.voxel_size)
    with torch.no_grad():
        got, _, _ = card(lvl)
        want, _, _ = cpu(cpu_lvl)
    for g, w in zip(got, want):
        assert torch.equal(g.keys.cpu(), w.keys)
        err = float((g.feats.cpu() - w.feats).abs().max())
        assert err <= 1e-4 * (1 + float(w.feats.abs().max())), err


@pytest.mark.parametrize('depth', [18, 101])
def test_resnet_depths_on_card(gen, depth):
    """The 2D ResNet of basic blocks (18) and of 33 bottlenecks (101) on
    the card against the same module's CPU path on the same weights and
    images, TF32 off: every stage within 1e-4 · (1 + max)."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.resnet import ResNet
    cpu = ResNet(depth, 16)
    flax_init_(cpu, torch.Generator().manual_seed(depth))
    card = ResNet(depth, 16).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 224, 224, 3), generator=gen, device='cuda')
    with torch.no_grad():
        got = card(x)
        want = cpu(x.cpu())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.cpu(), w)
