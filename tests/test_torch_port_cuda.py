"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a GPU every test skips with its reason. This file
imports neither JAX nor the JAX package, so it runs on a GPU host that
has no JAX; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Ball query and the lookups must be bit-exact; the sparse conv within
|k - p| <= 1e-4 * (1 + max|p|) (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from proxytransformation_torch.device import full_float32
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape, batch_to_device)
from proxytransformation_torch.ops import ball_query as bq
from proxytransformation_torch.ops import sparse as sp

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
