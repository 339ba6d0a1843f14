"""The port's train step against the JAX package's, on the CPU.

The milestone: the tiny grounder of tests/test_detector.py (text width
64, one text and one image proxy block, so DropPath's rate is 0) takes
two AdamW steps on both sides from one `fake_reference_state_dict`. The
JAX side is `engine/train.py::make_train_step(model,
build_optimizer(params))` under `jax.jit`, compiled once for both steps;
its gradients are read from the optimizer state through a recording
wrapper around the unchanged optax transform. The preshape's dropout
(rate 0.2, five draws per proxy block) is the one random draw of the
step: both sides use the same seeded keep masks, injected through a flax
method interceptor on the JAX side and `Dropout.draw` on the port's.

Checked after each step: the 4 losses, 'total_loss' and 'grad_norm',
every gradient (the JAX tree through `state_dict_from_jax`), the updated
parameters and running statistics; the level-0 voxel keys and the
Hungarian assignments of both layers bit for bit; frozen parameters bit
for bit unchanged.

Also here: the conv's backward formulas (mirrored and reversed dfeats,
plain dW) against `jax.grad` of the JAX `sparse_conv_apply` and the
interpret-mode Pallas dW; the any-map conv against the interpret-mode
Pallas `sparse_conv_gather_gemm`; the train-mode norms against flax;
DropPath's scaling; the max-pool's tie split and `scatter_replace`'s
gradient with duplicate points against `jax.grad`.
"""
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from proxytransformation_tpu.converter.torch_weights import convert_detector
from proxytransformation_tpu.engine import train as jtrain
from proxytransformation_tpu.models import detector as jdet_mod
from proxytransformation_tpu.models import grounding_head as jhead_mod
from proxytransformation_tpu.models import norms as jnorms
from proxytransformation_tpu.models import preshape as jpre
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_tpu.ops.sparse_conv_pallas import (
    sparse_conv_dw_gather_gemm, sparse_conv_gather_gemm)
from proxytransformation_tpu.parallel import replicate, shard_batch
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine import train as ttrain
from proxytransformation_torch.models import detector as tdet_mod
from proxytransformation_torch.models import grounding_head as thead_mod
from proxytransformation_torch.models import norms as tnorms
from proxytransformation_torch.models import preshape as tpre
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)
from proxytransformation_torch.ops import sparse as tsp

from test_detector import tiny_batch
from test_torch_port_detector import TINY, tiny_state_dict

KEEP = 0.8   # 1 - the preshape's dropout rate


# --------------------------------------------------------------------------
# the milestone: two train steps
# --------------------------------------------------------------------------
def _port_name(path):
    """flax path of a preshape Dropout → the port's module name."""
    _, block, sub, drop = path
    branch, i = block.rsplit('_', 1)
    n = int(drop.split('_')[1])
    name = (('drop_pa', 'drop_qa', 'drop_proj')[n] if sub == 'attn'
            else ('drop1', 'drop2')[n])
    return f'preshape.{branch}.{i}.{sub}.{name}'


def _keep_mask(name, shape):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    return rng.rand(*shape) < KEEP


def _recording(tx):
    """`tx` whose state also keeps the last gradients it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                       params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _capture(store, key):
    def wrap(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            arr = out.keys if key == 'keys' else out
            jax.debug.callback(
                lambda x: store.setdefault(key, []).append(np.asarray(x)),
                arr)
            return out
        return wrapped
    return wrap


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _adam_moments(opt_state, params):
    """The two groups' Adam (mu, nu) trees of the optax state merged into
    params-shaped trees (zeros for the frozen group)."""
    inner = opt_state.inner_states
    masked = lambda x: isinstance(x, optax.MaskedNode)

    def merge(field):
        trees = [getattr(inner[g].inner_state[1], field)
                 for g in ('default', 'decoder')]
        return jax.tree_util.tree_map(
            lambda a, b, p: np.asarray(p * 0 if masked(a) and masked(b)
                                       else (b if masked(a) else a)),
            *trees, params, is_leaf=masked)

    return merge('mu'), merge('nu')


def run_jax(sd, batch, steps, monkeypatch, cfg=TINY, compiler_options=None,
            mesh=None):
    """`steps` JAX train steps of the grounder `cfg` from state dict `sd`,
    compiled once (with XLA's `compiler_options`, when given); with a
    `mesh`, the batch sharded over it and the state replicated (the JAX
    Runner's data parallelism, `proxytransformation_tpu.parallel`)."""
    masks, seen = {}, {}

    def interceptor(next_fun, args, kwargs, ctx):
        if (isinstance(ctx.module, fnn.Dropout) and ctx.module.rate > 0
                and ctx.method_name == '__call__'):
            path = ctx.module.scope.path
            name = _port_name(path)
            x = args[0]
            masks[name] = _keep_mask(name, x.shape)
            return jnp.where(masks[name], x / KEEP, 0.0)
        return next_fun(*args, **kwargs)

    monkeypatch.setattr(jhead_mod, 'hungarian_assign', _capture(
        seen, 'assign')(jhead_mod.hungarian_assign))
    monkeypatch.setattr(jdet_mod, 'voxelize_points', _capture(
        seen, 'keys')(jdet_mod.voxelize_points))
    model = JGrounder(**cfg)
    variables = convert_detector(sd)
    tx = _recording(jtrain.build_optimizer(variables['params']))
    state = jtrain.create_train_state(model, variables, tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        jb, state = shard_batch(jb, mesh), replicate(state, mesh)
    out = []
    with fnn.intercept_methods(interceptor):
        step = jax.jit(jtrain.make_train_step(model, tx)).lower(
            state, jb, jax.random.PRNGKey(0)).compile(
                compiler_options=compiler_options)
        for _ in range(steps):
            state, metrics = step(state, jb, jax.random.PRNGKey(0))
            grads = jax.tree_util.tree_map(np.asarray, state.opt_state[1])
            stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
            params = jax.tree_util.tree_map(np.asarray, state.params)
            mu, nu = _adam_moments(state.opt_state[0], params)
            out.append(dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_numpy(state_dict_from_jax(
                    {'params': grads, 'batch_stats': stats})),
                state=_numpy(state_dict_from_jax(
                    {'params': params, 'batch_stats': stats})),
                mu=_numpy(state_dict_from_jax(
                    {'params': mu, 'batch_stats': stats})),
                nu=_numpy(state_dict_from_jax(
                    {'params': nu, 'batch_stats': stats}))))
    jax.effects_barrier()
    return out, masks, seen


def run_port(sd, batch, masks, steps, adam=None, cfg=TINY):
    """`steps` port train steps of the grounder `cfg` from state dict
    `sd`; `adam` = a JAX step's record continues from its Adam moments
    after one step."""
    model = TGrounder(**cfg, device='cpu')
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    for name, mod in model.named_modules():
        if isinstance(mod, tpre.Dropout) and name in masks:
            mod.draw = (lambda shape, device, generator, m=masks[name]:
                        torch.from_numpy(m))
    seen = {}
    assign = thead_mod.GroundingHead.assign
    voxelize = tdet_mod.voxelize_points

    def rec_assign(self, *a, **kw):
        out = assign(self, *a, **kw)
        seen.setdefault('assign', []).append(out.numpy())
        return out

    def rec_voxelize(*a, **kw):
        out = voxelize(*a, **kw)
        seen.setdefault('keys', []).append(out.keys.numpy())
        return out

    thead_mod.GroundingHead.assign = rec_assign
    tdet_mod.voxelize_points = rec_voxelize
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if ttrain.param_label(n) == 'frozen'}
    try:
        opt = ttrain.build_optimizer(model)
        if adam is not None:
            for name, p in model.named_parameters():
                if ttrain.param_label(name) != 'frozen':
                    opt.state[p] = {
                        'mu': torch.from_numpy(adam['mu'][name].copy()),
                        'nu': torch.from_numpy(adam['nu'][name].copy())}
            for group in opt.param_groups:
                group['count'] = 1
        step = ttrain.make_train_step(
            model, opt,
            ttrain.build_lr_schedule(ttrain.BASE_LR, steps_per_epoch=1))
        tb = batch_to_device(batch, 'cpu')
        out = []
        for _ in range(steps):
            metrics = step(tb)
            grads = {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).numpy().copy()
                     for n, p in model.named_parameters()}
            out.append(dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads=grads,
                state={k: v.numpy().copy()
                       for k, v in model.state_dict().items()}))
    finally:
        thead_mod.GroundingHead.assign = assign
        tdet_mod.voxelize_points = voxelize
    frozen_same = all(torch.equal(p, frozen0[n])
                      for n, p in model.named_parameters() if n in frozen0)
    return out, seen, frozen_same, len(frozen0)


@pytest.fixture(scope='module')
def both_steps():
    mp = pytest.MonkeyPatch()
    try:
        sd = tiny_state_dict()
        batch = {k: np.asarray(v) for k, v in
                 tiny_batch(np.random.RandomState(1), L=8).items()}
        want, masks, jseen = run_jax(sd, batch, 2, mp)
    finally:
        mp.undo()
    got, tseen, frozen_same, n_frozen = run_port(sd, batch, masks, 2)
    # the second step again, from the JAX package's state after the first
    forced, _, _, _ = run_port(want[0]['state'], batch, masks, 1,
                               adam=want[0])
    return dict(want=want, got=got, forced=forced[0], masks=masks,
                jseen=jseen, tseen=tseen, frozen_same=frozen_same,
                n_frozen=n_frozen)


def test_dropout_masks_reach_both_sides(both_steps):
    # 5 draws per proxy block, one text and one image block
    assert len(both_steps['masks']) == 10


@pytest.mark.parametrize('step', [0, 1])
def test_integer_stages_bit_exact(both_steps, step):
    """Level-0 voxel keys (downstream of the ball queries, FPS and the
    dropout masks) and the Hungarian assignment of every decoder layer."""
    j, t = both_steps['jseen'], both_steps['tseen']
    np.testing.assert_array_equal(t['keys'][step], j['keys'][step])
    # the JAX callback fires once per layer (under the head's vmap)
    want = np.stack(j['assign'][2 * step:2 * step + 2])
    got = t['assign'][step]
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() == 2 * (2 + 3)   # every valid gt matched


def test_losses_and_norm_match_step_1(both_steps):
    """Losses to 2e-5 relative (float32 sums in another order through the
    whole network); grad_norm to 1e-4 relative (it adds up every
    gradient, the largest ~1e2)."""
    want = both_steps['want'][0]['metrics']
    got = both_steps['got'][0]['metrics']
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-4 if k == 'grad_norm' else 2e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def test_losses_and_norm_match_step_2(both_steps):
    """Two free-running steps. Adam's first step moves every parameter
    entry by about lr·sign(g) wherever |g| ≫ eps, so an entry whose
    gradient is at rounding level moves by ±lr on one side only (a bias
    before a train-mode BatchNorm, whose true gradient is 0, or a kernel
    entry few voxels reach). The losses still agree to 2e-5 relative,
    but the second step's gradients carry that drift through every
    ReLU and max-pool near a tie: grad_norm to 1e-2 relative. The second
    step's gradients and update are checked tightly from the JAX
    package's state after the first (the `forced` tests)."""
    want = both_steps['want'][1]['metrics']
    got = both_steps['got'][1]['metrics']
    assert set(got) == set(want)
    for k, v in want.items():
        rtol = 1e-2 if k == 'grad_norm' else 2e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def _grad_tol(want, grad_norm):
    """Per tensor: 5e-4 of its largest entry (a gradient runs back
    through ~20 sparse convs and train-mode norms, each summing in another
    order; the largest error seen is 2.8e-4 of it) plus 1e-6 of the
    global gradient norm (entries whose true value is 0, like a bias
    before a train-mode BatchNorm, hold only rounding noise of the terms
    that cancel there)."""
    return 5e-4 * float(np.abs(want).max()) + 1e-6 * grad_norm


def _step_record(both_steps, step):
    if step == 0:
        return both_steps['want'][0], both_steps['got'][0]
    return both_steps['want'][1], both_steps['forced']


@pytest.mark.parametrize('step', [0, 1])
def test_every_gradient_matches(both_steps, step):
    """Every gradient, the JAX tree read through `state_dict_from_jax`;
    the second step from the JAX package's state after the first."""
    want, got = _step_record(both_steps, step)
    gn = want['metrics']['grad_norm']
    assert set(got['grads']) <= set(want['grads'])
    bad = [(k, float(np.abs(g - want['grads'][k]).max()))
           for k, g in got['grads'].items()
           if np.abs(g - want['grads'][k]).max()
           > _grad_tol(want['grads'][k], gn)]
    assert not bad, f'{bad[:5]} ({len(bad)} of {len(got["grads"])})'


@pytest.mark.parametrize('step', [0, 1])
def test_updated_params_and_stats_match(both_steps, step):
    """Parameters after the AdamW step and the running statistics, each
    entry within 1e-6 absolute plus 1e-5 of the tensor's largest
    magnitude, plus what the gradient's own tolerance allows: Adam
    scales every entry by its own gradient history, so a gradient error
    δ on an entry of size |g| moves its update by about lr·δ/|g|, at most
    ±lr either way where δ ≥ |g| and the sign itself is not determined.
    That adds 2.2 lr · min(1, tol_g / |g|)."""
    want, got = _step_record(both_steps, step)
    gn = want['metrics']['grad_norm']
    assert set(got['state']) <= set(want['state'])
    lr = 5e-4
    bad = []
    for k, g in got['state'].items():
        w = want['state'][k]
        tol = 1e-6 + 1e-5 * np.abs(w).max()
        if k in want['grads']:
            gk = np.abs(want['grads'][k])
            tol = tol + 2.2 * lr * np.minimum(
                1.0, _grad_tol(gk, gn) / np.maximum(gk, 1e-30))
        if np.any(np.abs(g - w) > tol):
            bad.append((k, float(np.abs(g - w).max())))
    assert not bad, bad[:5]


def test_frozen_parameters_unchanged(both_steps):
    assert both_steps['n_frozen'] > 0
    assert both_steps['frozen_same']


# --------------------------------------------------------------------------
# the conv's backward formulas
# --------------------------------------------------------------------------
def _level_and_map(self_map, seed=1, C_in=8):
    rng = np.random.RandomState(seed)
    B, N = 2, 900
    pts = rng.uniform(0, 2.5, (B, N, 3)).astype(np.float32)
    pmask = rng.rand(B, N) < 0.95
    lvl = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(pmask),
                              jnp.asarray(pts), voxel_size=0.05,
                              capacity=640, extent=(64, 64, 64))
    if self_map:
        out_lvl, stride = lvl, 1
    else:
        out_lvl, stride = jsp.downsample_coords(lvl, 320), 2
    nbr = jsp.build_neighbor_map(lvl, out_lvl, kernel_size=3, stride=stride)
    f0 = np.where(np.asarray(lvl.mask)[..., None],
                  rng.randn(B, 640, C_in), 0.0).astype(np.float32)
    return f0, np.asarray(nbr), np.asarray(out_lvl.mask), rng


@pytest.mark.parametrize('self_map', [True, False])
def test_conv_backward_matches_jax_grad(self_map):
    """The port's autograd.Function on the CPU (mirrored or reversed
    dfeats, plain dW) against jax.grad of the JAX sparse_conv_apply on a
    real map: float32 sums in another order, 1e-5 of the largest entry."""
    f0, nbr, mask, rng = _level_and_map(self_map)
    w = (rng.randn(27, 8, 12) * 0.1).astype(np.float32)
    cot = rng.randn(nbr.shape[0], nbr.shape[1], 12).astype(np.float32)

    def loss(f, wt):
        return jnp.sum(jsp.sparse_conv_apply(f, jnp.asarray(nbr), wt,
                                             jnp.asarray(mask)) * cot)

    df_ref, dw_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f0),
                                                    jnp.asarray(w))
    ft = torch.tensor(f0, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = tsp.sparse_conv(ft, torch.tensor(nbr), wt, torch.tensor(mask),
                          self_map=self_map)
    (out * torch.tensor(cot)).sum().backward()
    for got, want in ((ft.grad, df_ref), (wt.grad, dw_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize('self_map', [True, False])
def test_dw_plain_matches_pallas_dw(self_map):
    """`sparse_conv_dw_plain` against the interpret-mode Pallas dW kernel
    on inputs rounded to bf16 values, so the kernel's bf16 cast is exact
    and only the float32 sums' order differs: 1e-5 of the largest entry."""
    f0, nbr, mask, rng = _level_and_map(self_map, seed=2, C_in=16)
    f0 = _bf16(f0)
    g = _bf16(np.where(mask[..., None],
                       rng.randn(nbr.shape[0], nbr.shape[1], 24), 0.0))
    want = np.asarray(sparse_conv_dw_gather_gemm(
        jnp.asarray(f0), jnp.asarray(nbr), jnp.asarray(g),
        jnp.asarray(mask), interpret=True))
    got = tsp.sparse_conv_dw_plain(torch.tensor(f0), torch.tensor(nbr),
                                   torch.tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('Ci,Co,K3', [(3, 7, 27), (16, 150, 27),
                                      (64, 64, 8)])
def test_any_map_conv_matches_pallas_gather_gemm(Ci, Co, K3):
    """TPU kernel row 4: the port's conv on the sorted random maps of
    tests/test_sparse_conv_pallas.py::_synthetic (no column structure)
    against the interpret-mode `sparse_conv_gather_gemm`, bf16-valued
    float32 inputs (its cast is exact): 1e-5 of the largest entry."""
    rng = np.random.RandomState(Ci + Co)
    B, Vi, Vo = 2, 700, 300
    feats = _bf16(rng.randn(B, Vi, Ci))
    nbr = np.sort(rng.randint(0, Vi, (B, Vo, K3)), axis=1).astype(np.int32)
    nbr = np.where(rng.rand(B, Vo, K3) < 0.4, -1, nbr).astype(np.int32)
    w = _bf16(rng.randn(K3, Ci, Co) * 0.1)
    mask = rng.rand(B, Vo) < 0.9
    want = np.asarray(sparse_conv_gather_gemm(
        jnp.asarray(feats), jnp.asarray(nbr), jnp.asarray(w),
        jnp.asarray(mask), interpret=True))
    got = tsp.sparse_conv(torch.tensor(feats), torch.tensor(nbr),
                          torch.tensor(w), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_reverse_map_inverts_each_offset():
    _, nbr, _, _ = _level_and_map(False)
    V_in = 640
    r = tsp.reverse_map(torch.tensor(nbr), V_in).numpy()
    B, V_out, K3 = nbr.shape
    for b in range(B):
        for k in range(K3):
            hit = nbr[b, :, k] >= 0
            np.testing.assert_array_equal(
                r[b, nbr[b, hit, k], k], np.arange(V_out)[hit])
            assert (r[b, :, k] >= 0).sum() == hit.sum()


# --------------------------------------------------------------------------
# train-mode pieces
# --------------------------------------------------------------------------
def test_masked_batch_norm_train_matches_flax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 50, 6).astype(np.float32) * 3 + 1
    mask = rng.rand(2, 50) < 0.7
    mod = jnorms.MaskedBatchNorm()
    v = mod.init(jax.random.PRNGKey(0), x, mask, False)
    v = {'params': {'scale': jnp.asarray(rng.rand(6) + 0.5, jnp.float32),
                    'bias': jnp.asarray(rng.randn(6), jnp.float32)},
         'batch_stats': {'mean': jnp.asarray(rng.randn(6), jnp.float32),
                         'var': jnp.asarray(rng.rand(6) + 0.5,
                                            jnp.float32)}}
    want, upd = mod.apply(v, x, mask, True, mutable=['batch_stats'])
    bn = tnorms.BatchNormParams(6)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(np.asarray(v['params']['scale'])))
        bn.bias.copy_(torch.tensor(np.asarray(v['params']['bias'])))
        bn.running_mean.copy_(torch.tensor(np.asarray(
            v['batch_stats']['mean'])))
        bn.running_var.copy_(torch.tensor(np.asarray(
            v['batch_stats']['var'])))
    got = bn.masked(torch.tensor(x), torch.tensor(mask), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for name, key in (('running_mean', 'mean'), ('running_var', 'var')):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd['batch_stats'][key]),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_flax_batch_norm_train_matches_flax():
    """flax 0.12 nn.BatchNorm in train mode: momentum 0.99, fast
    variance over every non-feature axis, no mask."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, 5, 9).astype(np.float32) * 2 + 0.5
    mod = fnn.BatchNorm(use_running_average=False)
    v = mod.init(jax.random.PRNGKey(0), x)
    v = {'params': {'scale': jnp.asarray(rng.rand(9) + 0.5, jnp.float32),
                    'bias': jnp.asarray(rng.randn(9), jnp.float32)},
         'batch_stats': {'mean': jnp.asarray(rng.randn(9), jnp.float32),
                         'var': jnp.asarray(rng.rand(9) + 0.5,
                                            jnp.float32)}}
    want, upd = mod.apply(v, x, mutable=['batch_stats'])
    bn = tnorms.BatchNormParams(9)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(np.asarray(v['params']['scale'])))
        bn.bias.copy_(torch.tensor(np.asarray(v['params']['bias'])))
        bn.running_mean.copy_(torch.tensor(np.asarray(
            v['batch_stats']['mean'])))
        bn.running_var.copy_(torch.tensor(np.asarray(
            v['batch_stats']['var'])))
    got = bn.flax(torch.tensor(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for name, key in (('running_mean', 'mean'), ('running_var', 'var')):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(upd['batch_stats'][key]),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_drop_path_scales_kept_samples():
    """One draw per sample, broadcast over the other axes; kept samples
    are divided by keep = 1 - rate, as the reference's x / keep."""
    dp = tpre.DropPath(0.25)
    x = torch.randn(4, 3, 5)
    keep = torch.tensor([True, False, True, False]).reshape(4, 1, 1)
    shapes = []

    def draw(shape, device, generator):
        shapes.append(shape)
        return keep

    dp.draw = draw
    out = dp(x, train=True)
    assert shapes == [(4, 1, 1)]
    want = torch.where(keep, x / 0.75, torch.zeros_like(x))
    assert torch.equal(out, want)
    assert torch.equal(dp(x, train=False), x)
    # the JAX module with the same mask: x / keep where kept
    jmask = np.asarray(keep)
    jout = jnp.where(jmask, jnp.asarray(x.numpy()) / 0.75, 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_max_pool_gradient_splits_ties_like_jax():
    """Post-ReLU zeros tie in the max pool: both frameworks split the
    gradient evenly among the tied inputs."""
    rng = np.random.RandomState(5)
    feats = np.maximum(rng.randn(1, 12, 4), 0).astype(np.float32)
    feats[0, :4, 0] = 0.0                       # a column of ties
    nbr = rng.randint(-1, 12, (1, 6, 8)).astype(np.int32)
    nbr[0, 0, :4] = np.arange(4)
    mask = np.ones((1, 6), bool)
    cot = rng.randn(1, 6, 4).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jsp.sparse_max_pool(
        f, jnp.asarray(nbr), jnp.asarray(mask)) * cot))(jnp.asarray(feats))
    ft = torch.tensor(feats, requires_grad=True)
    (tsp.sparse_max_pool(ft, torch.tensor(nbr), torch.tensor(mask))
     * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_scatter_replace_gradient_with_duplicates():
    """Duplicate point indices: the gradient reaches only the winning
    (last) write, as jax.grad of the reference's scatter gives it."""
    rng = np.random.RandomState(6)
    B, N, M, K = 2, 10, 3, 4
    pts = rng.randn(B, N, 3).astype(np.float32)
    idx = rng.randint(-1, N, (B, M, K)).astype(np.int32)
    idx[:, 0, :2] = 3                    # duplicates
    idx[:, 2, 3] = 3
    cl = rng.randn(B, M, K, 3).astype(np.float32)
    cot = rng.randn(B, N, 3).astype(np.float32)
    want = jax.grad(lambda c: jnp.sum(jpre._scatter_replace(
        jnp.asarray(pts), jnp.asarray(idx), c) * cot))(jnp.asarray(cl))
    ct = torch.tensor(cl, requires_grad=True)
    (tpre.scatter_replace(torch.tensor(pts), torch.tensor(idx), ct)
     * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(ct.grad.numpy(), np.asarray(want))


def test_lr_schedule_matches_optax():
    """MultiStep milestones [8, 11] x steps per epoch, gamma 0.1: the
    reference's optax schedule, value for value in float32."""
    want = jtrain.build_lr_schedule(5e-4, steps_per_epoch=3)
    got = ttrain.build_lr_schedule(5e-4, steps_per_epoch=3)
    for step in (0, 1, 23, 24, 25, 32, 33, 34, 100):
        assert got(step) == float(np.float32(want(step))), step


def parity_report() -> None:
    """Print the train step's parity errors (port vs JAX package, CPU)."""
    steps = both_steps.__wrapped__()
    for step in (0, 1):
        want, got = _step_record(steps, step)
        free = steps['got'][step]['metrics']
        print(f'step {step + 1}: ' + ', '.join(
            f'{k} rel err {abs(free[k] - v) / abs(v):.2g}'
            for k, v in sorted(want['metrics'].items())))
        gn = want['metrics']['grad_norm']
        rel = {k: float(np.abs(g - want['grads'][k]).max()
                        / max(np.abs(want['grads'][k]).max(), 1e-30))
               for k, g in got['grads'].items()
               if np.abs(want['grads'][k]).max() > 1e-6 * gn}
        worst = max(rel, key=rel.get)
        print(f'  gradients ({"from the JAX state" if step else "free"}): '
              f'{len(rel)} tensors above 1e-6 of grad_norm, max error '
              f'{rel[worst]:.3g} of the tensor max ({worst}); '
              f'{len(got["grads"]) - len(rel)} below it (the frozen text '
              f'tower, biases before a train-mode norm)')
        st = {k: float(np.abs(g - want['state'][k]).max())
              for k, g in got['state'].items()}
        worst = max(st, key=st.get)
        print(f'  updated state: max abs err {st[worst]:.3g} ({worst})')


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_port_train.py (from the
    # repository root; JAX on the CPU, as the tests pin it)
    jax.config.update('jax_platforms', 'cpu')
    parity_report()
