"""The whole bfloat16 grounder against the JAX package's, on the CPU.

The tiny grounder of tests/test_torch_port_detector.py with
`compute_dtype='bfloat16', remat_painting=True` on both sides, the same
weights and batch: one predict here, one AdamW train step in
tests/test_torch_port_bf16_train.py.

The JAX side is the model as the TPU runs it (`tpu_conv_path`): every
K3 > 1 sparse conv of bfloat16 features goes through the package's own
custom_vjp (`ops/sparse.py::_sparse_conv_pallas_ad`, the TPU forward and
backward) with its two Pallas kernels replaced by their XLA oracles
(bf16-rounded features, weights and gradients, float32 sums: the
functions that tests/test_torch_port_bf16_ops.py holds the kernels to),
compiled with every bfloat16 operation rounded (`xla_allow_excess_precision`
off; see tests/test_torch_port_bf16_modules.py). The JAX CPU path would
instead multiply bfloat16 features by float32 weights and sum each input
gradient in bfloat16, offset by offset: another function. The stem's
float32 xyz features keep the float32 CPU path on both sides, as the
port dispatches on the features' dtype.

Integer stages must match bit for bit: the neck's kept voxel sets and
the query mask. Floats cannot match to float32 rounding: where two
float32 sums taken in another order round to neighbouring bfloat16
values, the one-ulp difference travels on through every later bfloat16
layer. So each float output is held within a stated tolerance, under the
float32-vs-bfloat16 gap, and against the distance of the port's
*float32* model from the same JAX bfloat16 output, which must be larger
(the test tells bfloat16 from float32).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter.torch_weights import convert_detector
from proxytransformation_tpu.models import sparse_resnet as jsparse_resnet
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_tpu.ops import sparse as jsp
from proxytransformation_tpu.ops import sparse_conv_pallas as jpallas
from proxytransformation_torch.models import detector as tdet_mod
from proxytransformation_torch.models import sparse_neck as tneck_mod
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)

from test_detector import tiny_batch
from test_torch_port_detector import PREDICT_KEYS, TINY, tiny_state_dict

BF16_TINY = dict(TINY, compute_dtype='bfloat16', remat_painting=True)
EXACT = {'xla_allow_excess_precision': False}


@pytest.fixture(autouse=True, scope='module')
def two_torch_threads():
    """Two intra-op threads for the port's CPU ops in this module (its
    tensors are small: eight threads only add overhead, and the test
    workers share the machine's cores); the caller's count comes back."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_values(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


@contextlib.contextmanager
def tpu_conv_path():
    """The JAX sparse convs of bfloat16 features on their TPU path, the
    Pallas kernels as their XLA oracles (see the module docstring)."""
    mp = pytest.MonkeyPatch()

    def colwin(feats, nbr, weights, out_mask, **_):
        out = jsp.sparse_conv_apply(_bf16_values(feats), nbr,
                                    _bf16_values(weights), out_mask)
        return out.astype(feats.dtype)

    def dw(feats, nbr, g, out_mask, **_):
        f = _bf16_values(feats)
        g = _bf16_values(jnp.where(out_mask[..., None], g, 0.0))
        w0 = jnp.zeros((nbr.shape[-1], feats.shape[-1], g.shape[-1]))
        _, vjp = jax.vjp(lambda w: jsp.sparse_conv_apply(f, nbr, w, out_mask),
                         w0)
        return vjp(g)[0]

    def sparse_conv(feats, nbr, weights, out_mask, self_map=False):
        if nbr.shape[-1] > 1 and feats.dtype == jnp.bfloat16:
            return jsp._sparse_conv_pallas_ad(self_map, feats, nbr, weights,
                                              out_mask)
        return jsp.sparse_conv_apply(feats, nbr, weights, out_mask)

    mp.setattr(jpallas, 'sparse_conv_gather_gemm_colwin', colwin)
    mp.setattr(jpallas, 'sparse_conv_dw_gather_gemm', dw)
    mp.setattr(jsparse_resnet, 'sparse_conv', sparse_conv)
    try:
        yield mp
    finally:
        mp.undo()


def _margins(record):
    """Wrap the port's selection cuts to record, at each, the smallest
    score margin between the last kept and the first dropped voxel or
    query (per sample where anything is dropped)."""
    mp = pytest.MonkeyPatch()

    def margin(scores, valid, k):
        s = torch.where(valid, scores.float(),
                        torch.full_like(scores.float(), float('-inf')))
        s = torch.sort(s, dim=1, descending=True).values
        return [float(s[b, k - 1] - s[b, k]) for b in range(s.shape[0])
                if int(valid[b].sum()) > k]

    def wrap(module, name, valid_of):
        fn = getattr(module, name)

        def recorded(*a, **kw):
            scores, valid, k = valid_of(*a)
            record.append((name, k, margin(scores, valid, k)))
            return fn(*a, **kw)
        mp.setattr(module, name, recorded)

    wrap(tneck_mod, 'compact_topk', lambda lvl, s, k, *_: (s, lvl.mask, k))
    wrap(tneck_mod, 'compact_by_score', lambda a, s, m, k: (s, m, k))
    wrap(tdet_mod, 'topk_stable', lambda s, k: (s, torch.isfinite(s), k))
    return mp


def run_predict():
    sd = tiny_state_dict()
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1)).items() if k in PREDICT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = convert_detector(sd)
    jmodel = JGrounder(**BF16_TINY)

    def jboth(m, b):
        """Predict (as the model's __call__ runs it) and the neck tokens,
        in one program."""
        text = m.encode_text(b['input_ids'], b['text_mask'])
        neck = m.extract_feat(b, text, False)
        hidden, boxes, qmask = m.forward_transformer(*neck, text,
                                                     b['text_mask'], False)
        bb, sc = m.bbox_head.predict(hidden, boxes, text, b['text_mask'],
                                     qmask)
        return {'bboxes_3d': bb, 'scores_3d': sc, 'query_mask': qmask}, neck

    with tpu_conv_path():
        want, jneck = jax.jit(
            lambda v, b: jmodel.apply(v, b, method=jboth)).lower(
                variables, jb).compile(compiler_options=EXACT)(variables, jb)
    tb = batch_to_device(batch, 'cpu')
    got, margins = {}, []
    for cd in ('bfloat16', 'float32'):
        port = TGrounder(**dict(BF16_TINY, compute_dtype=cd), device='cpu')
        port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        mp = _margins(margins if cd == 'bfloat16' else [])
        try:
            out = port(tb)
            with torch.no_grad():
                neck = port.extract_feat(
                    tb, port.encode_text(tb['input_ids'], tb['text_mask']))
        finally:
            mp.undo()
        got[cd] = (out, neck)
    return dict(want=want, jneck=jneck, got=got, margins=margins)


@pytest.fixture(scope='module')
def predict():
    return run_predict()


def _token_sets(xyz, mask, levels: int, P: int):
    """Per sample and neck level, the set of kept voxel positions."""
    xyz, mask = np.asarray(xyz), np.asarray(mask)
    return [[{tuple(p) for p in xyz[b, lv * P:(lv + 1) * P][
        mask[b, lv * P:(lv + 1) * P]].round(5)} for lv in range(levels)]
        for b in range(xyz.shape[0])]


def test_bf16_predict_selection_matches(predict):
    """Every cut keeps the same voxels and queries: the neck's token sets
    per level, and the query mask. The score margins at each cut of the
    port (last kept minus first dropped, per sample) are printed; ties
    at 0.0 are siblings sharing their parent's score, broken by position
    on both sides."""
    for cut in predict['margins']:
        print('cut', cut)
    out, neck = predict['got']['bfloat16']
    jneck = predict['jneck']
    np.testing.assert_array_equal(out['query_mask'].numpy(),
                                  np.asarray(predict['want']['query_mask']))
    assert out['query_mask'].numpy().sum() > 0
    P = TINY['pts_prune_threshold']
    got = _token_sets(neck[2].numpy(), neck[3].numpy(), 4, P)
    assert got == _token_sets(jneck[2], jneck[3], 4, P)


# measured on this batch (`parity_report`), port bf16 against JAX bf16:
# boxes max 4.9e-4, mean 9.9e-5 (of boxes up to 2.39); scores max 6.0e-6,
# mean 1.6e-6 (of scores up to 0.0105). JAX's float32 predict is 2.4
# (boxes: it selects another query) and 4.4e-4 (scores) from its bf16 one.
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5


def test_bf16_predict_outputs_match(predict):
    """Boxes and scores within BOX_ATOL / SCORE_ATOL of JAX's bf16
    predict (one-ulp differences of float32 sums taken in another order,
    carried through ~20 bf16 layers), and a mean error at most a fifth
    of the port's float32 model's against the same JAX output (the test
    tells bf16 from float32)."""
    want = predict['want']
    for k, atol in (('bboxes_3d', BOX_ATOL), ('scores_3d', SCORE_ATOL)):
        w = np.asarray(want[k])
        err = {cd: np.abs(predict['got'][cd][0][k].numpy() - w)
               for cd in ('bfloat16', 'float32')}
        assert predict['got']['bfloat16'][0][k].dtype == torch.float32
        assert err['bfloat16'].max() <= atol, (k, err['bfloat16'].max())
        assert err['bfloat16'].mean() <= 0.2 * err['float32'].mean(), k


def test_remat_painting_leaves_outputs_and_gradients():
    """`remat_painting=True` recomputes the painting in the backward:
    predict outputs, losses and every gradient equal bit for bit."""
    sd = tiny_state_dict()
    batch = batch_to_device({k: np.asarray(v) for k, v in tiny_batch(
        np.random.RandomState(1), L=8).items()}, 'cpu')
    runs = []
    for remat in (False, True):
        model = TGrounder(**dict(BF16_TINY, remat_painting=remat),
                          device='cpu')
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        out = model(batch)
        losses = model.loss(batch, torch.Generator().manual_seed(0))
        sum(losses[k] for k in sorted(losses)).backward()
        runs.append((out, losses, {n: p.grad for n, p in
                                   model.named_parameters()
                                   if p.grad is not None}))
    (o0, l0, g0), (o1, l1, g1) = runs
    for k in o0:
        assert torch.equal(o0[k], o1[k]), k
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    assert g0.keys() == g1.keys() and len(g0) > 100
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def parity_report() -> None:
    """Print the bf16 predict's parity errors, the float32 model's
    distance from the same JAX output, and JAX's own float32-vs-bf16
    gap (its float32 model on the CPU conv path)."""
    r = run_predict()
    want = r['want']
    batch = {k: jnp.asarray(np.asarray(v)) for k, v in tiny_batch(
        np.random.RandomState(1)).items() if k in PREDICT_KEYS}
    variables = convert_detector(tiny_state_dict())
    j32 = JGrounder(**dict(BF16_TINY, compute_dtype='float32'))
    want32 = jax.jit(lambda v, b: j32.apply(v, b, mode='predict'))(
        variables, batch)
    for k in ('bboxes_3d', 'scores_3d'):
        w = np.asarray(want[k])
        for cd in ('bfloat16', 'float32'):
            err = np.abs(r['got'][cd][0][k].numpy() - w)
            print(f'{k}: port {cd} vs JAX bf16: max {err.max():.3g}, mean '
                  f'{err.mean():.3g}')
        gap = np.abs(np.asarray(want32[k]) - w)
        print(f'{k}: JAX float32 vs JAX bf16: max {gap.max():.3g}, mean '
              f'{gap.mean():.3g}; max |ref| {np.abs(w).max():.3g}')
    for cut in r['margins']:
        print('cut', cut)


if __name__ == '__main__':
    # PYTHONPATH=.:tests python tests/test_torch_port_bf16_model.py (from
    # the repository root; JAX on the CPU, as the tests pin it)
    jax.config.update('jax_platforms', 'cpu')
    torch.set_num_threads(2)
    parity_report()

