"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: without a GPU every test skips with its reason. This file
imports neither JAX nor the JAX package, so it runs on a GPU host that
has no JAX; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Ball query, the lookups and the row gather must be bit-exact; the sparse
conv, its weight gradient and its input gradient within
|k - p| <= 1e-4 * (1 + max|p|) (float32 sums in another order).
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
from proxytransformation_torch.ops import ball_query as bq
from proxytransformation_torch.ops import sparse as sp
from proxytransformation_torch.tools import gather_probe

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


def test_row_gather_kernel(gen):
    table, idx = gather_probe.probe_inputs('cuda')
    assert torch.equal(gather_probe.row_gather(table, idx),
                       gather_probe.row_gather_plain(table, idx))


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
                               build_lr_schedule(steps_per_epoch=1))
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
