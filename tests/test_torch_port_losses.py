"""The port's loss-side pieces against the JAX package's, on the CPU.

Exact 9-DoF IoU, the Hungarian assignment (subset DP and
Jonker-Volgenant, against the JAX functions and scipy), the losses and
match costs, `GroundingHead.loss` with its gradients, and the euler
rotation and box corners they rest on. Inputs come from numpy seeds.
Assignments must be equal bit for bit; each float tolerance is stated
where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from proxytransformation_tpu.models import grounding_head as jhead
from proxytransformation_tpu.models import losses as jloss
from proxytransformation_tpu.ops import box3d_overlap as jiou
from proxytransformation_tpu.ops import hungarian as jhun
from proxytransformation_tpu.structures import boxes as jboxes
from proxytransformation_tpu.structures import rotation as jrot
from proxytransformation_torch.models import grounding_head as thead
from proxytransformation_torch.models import losses as tloss
from proxytransformation_torch.ops import box3d_overlap as tiou
from proxytransformation_torch.ops import hungarian as thun
from proxytransformation_torch.structures import boxes as tboxes
from proxytransformation_torch.structures import rotation as trot


def t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, lo=0.0, hi=2.0):
    return np.concatenate([rng.uniform(lo, hi, (n, 3)),
                           rng.uniform(0.3, 1.5, (n, 3)),
                           rng.uniform(-1, 1, (n, 3))], -1).astype(np.float32)


def test_euler_rotation_and_corners_match():
    """float32 products of sines and cosines: 1e-6."""
    rng = np.random.RandomState(0)
    ang = rng.uniform(-3, 3, (4, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trot.euler_angles_to_matrix(t(ang)).numpy(),
        np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(ang))),
        atol=1e-6)
    b = _boxes(rng, 20)
    np.testing.assert_allclose(
        tboxes.bbox_to_corners(t(b)).numpy(),
        np.asarray(jboxes.bbox_to_corners(jnp.asarray(b))), atol=1e-6)


@pytest.mark.parametrize('case', ['random', 'identical', 'disjoint',
                                  'nested'])
def test_box3d_iou_matches(case):
    """Both entry points. The vertices come from sines, cosines and
    atan2, whose float32 results differ by an ulp or so between the two
    libraries: 2e-5 absolute on IoU in [0, 1]."""
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 12), _boxes(rng, 15)
    if case == 'identical':
        b[:12] = a
    elif case == 'disjoint':
        b[:, :3] += 10.0
    elif case == 'nested':
        b[:12] = a
        b[:12, 3:6] = a[:, 3:6] * 0.5
    want = np.asarray(jiou.box3d_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.box3d_iou(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    want_al = np.asarray(jiou.box3d_iou_aligned(jnp.asarray(a[:, None]),
                                                jnp.asarray(b[None])))
    got_al = tiou.box3d_iou_aligned(t(a[:, None]), t(b[None])).numpy()
    np.testing.assert_allclose(got_al, want_al, atol=2e-5)
    if case == 'identical':
        np.testing.assert_allclose(np.diag(got[:, :12]), 1.0, atol=2e-5)
    if case == 'disjoint':
        assert np.all(got == 0)
    if case == 'nested':
        np.testing.assert_allclose(np.diag(got[:, :12]), 0.125, atol=2e-5)


def _scipy(cost, num_gts):
    out = np.full(cost.shape[:2], -1)
    for i, g in enumerate(num_gts):
        if g:
            rows, cols = linear_sum_assignment(cost[i, :, :g])
            out[i, rows] = cols
    return out


@pytest.mark.parametrize('G', [1, 3, 8, 16])
def test_hungarian_bit_exact(G):
    """Random costs, valid gt counts from 0 to G: DP (G <= 14) and JV
    against the JAX functions and scipy, bit for bit."""
    rng = np.random.RandomState(G)
    B, Q = 5, 24
    cost = rng.randn(B, Q, G).astype(np.float32)
    num = np.array([G, G - 1, 0, max(G // 2, 1), 1])[:B].clip(0, G)
    want_jv = np.asarray(jhun.hungarian_assign_jv(jnp.asarray(cost),
                                                  jnp.asarray(num)))
    got_jv = thun.hungarian_assign_jv(t(cost), t(num)).numpy()
    np.testing.assert_array_equal(got_jv, want_jv)
    np.testing.assert_array_equal(got_jv, _scipy(cost, num))
    if G <= 14:
        want = np.asarray(jhun.hungarian_assign_dp(jnp.asarray(cost),
                                                   jnp.asarray(num)))
        got = thun.hungarian_assign(t(cost), t(num)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _scipy(cost, num))
    else:
        got = thun.hungarian_assign(t(cost), t(num)).numpy()
        np.testing.assert_array_equal(got, want_jv)


def test_hungarian_ties_follow_jax():
    """Integer costs tie everywhere: `torch.argmin` keeps the first
    minimum like `jnp.argmin`, so DP and JV agree with JAX on ties too."""
    rng = np.random.RandomState(7)
    cost = rng.randint(0, 3, (4, 10, 5)).astype(np.float32)
    num = np.array([5, 3, 2, 4])
    for tf, jf in ((thun.hungarian_assign_dp, jhun.hungarian_assign_dp),
                   (thun.hungarian_assign_jv, jhun.hungarian_assign_jv)):
        np.testing.assert_array_equal(
            tf(t(cost), t(num)).numpy(),
            np.asarray(jf(jnp.asarray(cost), jnp.asarray(num))))
    x = torch.tensor([[3., 1., 1., 0., 0.]])
    assert int(torch.argmin(x, dim=1)[0]) == int(jnp.argmin(
        jnp.asarray(x.numpy()), axis=1)[0]) == 3


def test_losses_and_costs_match():
    """float32 elementwise math and sums in another order: 1e-5
    relative."""
    rng = np.random.RandomState(2)
    pred = rng.randn(2, 7, 12).astype(np.float32) * 3
    tgt = (rng.rand(2, 7, 12) < 0.3).astype(np.float32)
    w = rng.rand(2, 7, 12).astype(np.float32)
    for kw in ({}, {'weight': w}, {'weight': w, 'avg_factor': 5.0}):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        tkw = {k: t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        np.testing.assert_allclose(
            float(tloss.sigmoid_focal_loss(t(pred), t(tgt), **tkw)),
            float(jloss.sigmoid_focal_loss(jnp.asarray(pred),
                                           jnp.asarray(tgt), **jkw)),
            rtol=1e-5)
    src, dst = _boxes(rng, 9), _boxes(rng, 9)
    for mode in ('l1', 'l2', 'smooth_l1'):
        for group in ('g8', 'g4'):
            np.testing.assert_allclose(
                tloss.chamfer_corner_loss(t(src), t(dst), mode, group),
                np.asarray(jloss.chamfer_corner_loss(
                    jnp.asarray(src), jnp.asarray(dst), mode, group)),
                rtol=1e-5, atol=1e-6, err_msg=f'{mode} {group}')
    logits = rng.randn(7, 12).astype(np.float32) * 3
    logits[:, -2:] = -np.inf
    maps = (rng.rand(4, 12) < 0.3).astype(np.float32)
    tmask = np.arange(12) < 10
    np.testing.assert_allclose(
        tloss.binary_focal_cost(t(logits), t(maps), t(tmask)).numpy(),
        np.asarray(jloss.binary_focal_cost(jnp.asarray(logits),
                                           jnp.asarray(maps),
                                           jnp.asarray(tmask))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tloss.bbox_l1_cost(t(src), t(dst[:4])).numpy(),
        np.asarray(jloss.bbox_l1_cost(jnp.asarray(src), jnp.asarray(dst[:4]))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tloss.iou3d_cost(t(src), t(dst)).numpy(),
        np.asarray(jloss.iou3d_cost(jnp.asarray(src), jnp.asarray(dst))),
        atol=2e-5)


def test_grounding_head_loss_matches():
    """`GroundingHead.loss` on the same hidden states, boxes and targets:
    the assignments bit for bit, the 4 losses to 1e-5 relative, and
    their gradients with respect to the hidden states and boxes to 1e-5
    of the largest entry (float32 sums in another order)."""
    rng = np.random.RandomState(3)
    L, B, Q, D, T, M, G = 2, 2, 12, 16, 6, 64, 4
    hidden = rng.randn(L, B, Q, D).astype(np.float32)
    centers = rng.uniform(0, 2, (B, Q, 3))
    boxes = np.concatenate([np.broadcast_to(centers, (L, B, Q, 3)),
                            rng.uniform(0.3, 1.2, (L, B, Q, 3)),
                            rng.uniform(-0.5, 0.5, (L, B, Q, 3))],
                           -1).astype(np.float32)
    text = rng.randn(B, T, D).astype(np.float32)
    tmask = np.arange(T)[None].repeat(B, 0) < [[6], [4]]
    gt = _boxes(rng, B * G).reshape(B, G, 9)
    gmask = np.arange(G)[None].repeat(B, 0) < [[4], [2]]
    pm = np.zeros((B, G, M), np.float32)
    pm[:, :, 1] = 1.0
    pm[0, 1, 2] = 1.0
    qmask = rng.rand(B, Q) > 0.2

    jh = jhead.GroundingHead(embed_dims=D, max_text_len=M,
                             num_pred_layer=L + 1)
    args = tuple(map(jnp.asarray, (hidden, boxes, text, tmask, gt, gmask,
                                   pm, qmask)))
    params = jh.init(jax.random.PRNGKey(0), *args, method=jh.loss)
    seen = []
    assign_fn = jhead.hungarian_assign

    def loss_fn(h, bx):
        def rec(cost, num):
            out = assign_fn(cost, num)
            # called once per layer under the head's vmap
            jax.debug.callback(lambda a: seen.append(np.asarray(a)), out)
            return out
        jhead.hungarian_assign = rec
        try:
            out = jh.apply(params, h, bx, *args[2:], method=jh.loss)
        finally:
            jhead.hungarian_assign = assign_fn
        return sum(jax.tree_util.tree_leaves(out)), out

    (_, want), (dh_want, db_want) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(args[0], args[1])

    head = thead.GroundingHead(D, 9, M)
    with torch.no_grad():
        head.cls_branches[0].bias.copy_(
            t(params['params']['cls_branch']['bias_value']))
    h = t(hidden).requires_grad_()
    bx = t(boxes).requires_grad_()
    targs = tuple(map(t, (text, tmask, gt, gmask, pm, qmask)))
    got = head.loss(h, bx, *targs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assign = head.assign(torch.stack([head.cls_branches[0](
        x, targs[0], targs[1]) for x in h]), bx, targs[1], targs[2],
        targs[3], targs[4], targs[5])
    jax.effects_barrier()
    np.testing.assert_array_equal(assign.numpy(), np.stack(seen[:L]))
    sum(got[k] for k in sorted(got)).backward()
    for g, w in ((h.grad, dh_want), (bx.grad, db_want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
