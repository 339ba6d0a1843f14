"""The port's text-tower zoo against the JAX package's, on the CPU.

Each tower (BERT, Roberta, T5, DeBERTa, open_clip) at a tiny size (2
layers, width 32, 4 heads, ids in range, one padded row) against
`jax.jit` of the JAX tower's `apply`, the way the grounder runs it, with
the weights carried both ways: the port's state_dict through the JAX
package's converters, and the JAX `init` through `state_dict_from_jax`
into a strict `load_state_dict`. Tolerance: 1e-5 · (1 + max|ref|)
(float32 sums in another order). Also the t_type dispatch, the host
checks of ids and lengths, flax's initialisers, the towers loaded from
HF models built from in-code configs (where `transformers` imports),
the grounder with a T5-small tower against the JAX grounder, and the
train / test CLIs with a full-size CLIP-base tower.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.models import text_variants as J
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.engine.train import (
    build_lr_schedule, build_optimizer, make_train_step, param_label)
from proxytransformation_torch.models import text_variants as T
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)
from proxytransformation_torch.models.init import flax_init_
from proxytransformation_torch.models.layers import random_init_

from test_detector import tiny_batch
from test_text_variants import _torch_open_clip_tower
from test_torch_port_detector import PREDICT_KEYS, TINY
from test_torch_port_runtime_engine import SMOKE, two_threads  # noqa: F401

B, L, VOCAB = 2, 9, 100
# (name, port class, JAX class, keywords of both, JAX converter)
TOWERS = {
    'bert': (T.BertTextEncoder, J.BertTextEncoder,
             dict(vocab_size=VOCAB, width=32, layers=2, heads=4,
                  intermediate=64, max_positions=16),
             J.convert_hf_bert_text),
    'roberta': (T.RobertaTextEncoder, J.RobertaTextEncoder,
                dict(vocab_size=VOCAB, width=32, layers=2, heads=4,
                     intermediate=64, max_positions=18),
                J.convert_hf_bert_text),
    't5': (T.T5TextEncoder, J.T5TextEncoder,
           dict(vocab_size=VOCAB, width=32, layers=2, heads=4, d_ff=64),
           J.convert_hf_t5_encoder),
    'deberta': (T.DebertaTextEncoder, J.DebertaTextEncoder,
                dict(vocab_size=VOCAB, width=32, layers=2, heads=4,
                     intermediate=64, max_rel=16),
                lambda sd: J.convert_hf_deberta(sd, heads=4)),
    # max_rel below L: the span slice of the relative table
    'deberta_span': (T.DebertaTextEncoder, J.DebertaTextEncoder,
                     dict(vocab_size=VOCAB, width=32, layers=2, heads=4,
                          intermediate=64, max_rel=4),
                     lambda sd: J.convert_hf_deberta(sd, heads=4)),
    'open_clip': (T.OpenCLIPTextEncoder, J.OpenCLIPTextEncoder,
                  dict(vocab_size=VOCAB, width=32, layers=2, heads=4,
                       max_positions=12),
                  J.convert_open_clip_text),
}


@pytest.fixture(autouse=True)
def _threads(two_threads):  # noqa: F811
    yield


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 6:] = 0
    ids[1, 6:] = 1            # Roberta's and HF's pad id
    return ids, mask


def close(got, want, what=''):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()),
                               err_msg=what)


def jax_apply(jcls, kw, params, ids, mask):
    mod = jcls(**kw)
    return np.asarray(jax.jit(lambda p, i, m: mod.apply({'params': p}, i, m))(
        params, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.mark.parametrize('name', sorted(TOWERS))
def test_port_weights_through_the_jax_converter(name):
    """The port's seeded weights, read by the JAX package's converter."""
    tcls, jcls, kw, convert = TOWERS[name]
    ids, mask = inputs()
    port = tcls(**kw)
    random_init_(port, torch.Generator().manual_seed(1), std=0.2)
    params = convert({k: v.numpy() for k, v in port.state_dict().items()})
    want = jax_apply(jcls, kw, params, ids, mask)
    got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (B, L, 32)
    close(got, want, name)


@pytest.mark.parametrize('name', sorted(TOWERS))
def test_jax_init_into_the_port(name):
    """The JAX `init`, inverted by `state_dict_from_jax` into a strict
    load; the port's state_dict converts back to the same tree."""
    tcls, jcls, kw, convert = TOWERS[name]
    ids, mask = inputs(1)
    variables = jax.jit(jcls(**kw).init)(jax.random.PRNGKey(0),
                                         jnp.asarray(ids), jnp.asarray(mask))
    params = jax.tree_util.tree_map(np.asarray, variables['params'])
    sd = state_dict_from_jax({'params': {'text_encoder': params}},
                             deberta_heads=4)
    port = tcls(**kw)
    port.load_state_dict({k[len('text_encoder.'):]: v
                          for k, v in sd.items()})
    back = convert({k: v.numpy() for k, v in port.state_dict().items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, back), params)
    close(port(torch.from_numpy(ids), torch.from_numpy(mask)),
          jax_apply(jcls, kw, params, ids, mask), name)


def test_deberta_scale_rounds_as_jitted_jax():
    """q / sqrt(f32(3·hd)) of a compile-time constant: XLA multiplies by
    the float32 reciprocal, and the port's factor gives the same bits."""
    q = np.random.RandomState(0).randn(4096).astype(np.float32)
    for hd in (8, 64):
        want = np.asarray(jax.jit(
            lambda x: x / jnp.sqrt(jnp.float32(hd * 3)))(q))
        inv = np.float32(1.0) / np.sqrt(np.float32(hd * 3))
        np.testing.assert_array_equal(
            (torch.from_numpy(q) * float(inv)).numpy(), want)


# every t_type the JAX package's tests and dispatch table name
T_TYPES = ('roberta-base', 'bert-base-uncased', 'facebook/flava-full',
           't5-small', 't5-base', 't5-large', 'deberta-base',
           'deberta-large', 'ViT-bigG-14', 'ViT-H-14', 'EVA02-L-14-336',
           'EVA02-E-14-plus', 'openai/clip-vit-base-patch32',
           'clip-vit-base-patch16', 'clip-vit-large-patch14',
           'openai/clip-vit-large-patch14-336', 'clip')


def _shape(enc):
    """(family, width, layers, heads, vocabulary) of a port tower."""
    layers = len(enc.transformer.resblocks) if hasattr(enc, 'transformer') \
        else len(enc.encoder.block) if hasattr(enc, 'shared') \
        else len(enc.encoder.layer) if hasattr(enc, 'encoder') \
        else len(enc.text_model.encoder.layers)
    return (enc.width, layers, enc.heads, enc.vocab_size)


@pytest.mark.parametrize('t_type', T_TYPES)
def test_dispatch_matches_jax(t_type):
    jenc, jwidth = J.build_text_encoder(t_type)
    with torch.device('meta'):
        enc, width = T.build_text_encoder(t_type)
    family = type(enc).__name__
    want = type(jenc).__name__
    assert family == want
    assert width == jwidth
    assert _shape(enc) == (jenc.width, jenc.layers, jenc.heads,
                           jenc.vocab_size)
    if isinstance(jenc, J.T5TextEncoder):
        assert enc.encoder.block[0].layer[1].DenseReluDense.wi.out_features \
            == jenc.d_ff
    elif hasattr(jenc, 'intermediate'):
        assert enc.encoder.layer[0].intermediate.dense.out_features == \
            jenc.intermediate
    with pytest.raises(ValueError, match='unknown t_type'):
        T.build_text_encoder('word2vec')


@pytest.mark.parametrize('t_type,vocab,max_len', [
    ('bert-base-uncased', 30522, 512), ('t5-small', 32128, None),
    ('roberta-base', 50265, 512), ('ViT-H-14', 49408, 77),
    ('clip-vit-base-patch32', 49408, 77), ('deberta-base', 50265, None)])
def test_ids_and_lengths_are_checked_on_the_host(t_type, vocab, max_len):
    with torch.device('meta'):
        enc, _ = T.build_text_encoder(t_type)
    ids = np.full((2, 8), 5, np.int32)
    enc.check_ids(ids)
    ids[1, 3] = vocab
    with pytest.raises(ValueError, match=rf"t_type='{t_type}'.*{vocab}.*"
                                         rf"vocabulary of {vocab}"):
        enc.check_ids(ids)
    if max_len is None:
        enc.check_ids(np.zeros((1, 600), np.int32))
    else:
        enc.check_ids(np.zeros((1, max_len), np.int32))
        with pytest.raises(ValueError, match=f'at most {max_len} positions'):
            enc.check_ids(np.zeros((1, max_len + 1), np.int32))


def test_tower_refuses_ids_beyond_its_vocabulary():
    """A CPU tensor is checked in the forward itself."""
    port = T.BertTextEncoder(**TOWERS['bert'][2])
    ids, mask = inputs()
    ids[0, 0] = VOCAB + 7
    with pytest.raises(ValueError, match=f'token id {VOCAB + 7}'):
        port(torch.from_numpy(ids), torch.from_numpy(mask))


@pytest.mark.parametrize('name', ['bert', 't5', 'deberta', 'open_clip'])
def test_flax_init_follows_model_init(name):
    """Every parameter drawn by `flax_init_` has the law of its JAX
    twin's `init`: the same constants where flax sets one, else a draw of
    the same spread (std within 15 %, mean within 0.1 std)."""
    tcls, jcls, kw, _ = TOWERS[name]
    kw = dict(kw, vocab_size=512)
    ids, mask = inputs()
    variables = jax.jit(jcls(**kw).init)(jax.random.PRNGKey(0),
                                         jnp.asarray(ids), jnp.asarray(mask))
    want = state_dict_from_jax({'params': {'text_encoder': jax.tree_util.
                                           tree_map(np.asarray,
                                                    variables['params'])}},
                               deberta_heads=4)
    port = flax_init_(tcls(**kw), torch.Generator().manual_seed(0))
    got = port.state_dict()
    assert set(got) == {k[len('text_encoder.'):] for k in want}
    for k, w in want.items():
        g, w = got[k[len('text_encoder.'):]].numpy(), w.numpy()
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert abs(g.std() / w.std() - 1) < 0.15, (k, g.std(), w.std())
        assert abs(g.mean()) < 0.1 * w.std() + 0.1 * abs(w.mean()) + 1e-3, k


# --------------------------------------------------------------------------
# upstream models (transformers / open_clip layouts)
# --------------------------------------------------------------------------
def _hf_models(transformers):
    common = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return {
        'bert': (transformers.BertModel(transformers.BertConfig(
            max_position_embeddings=16, **common)), 'bert'),
        'roberta': (transformers.RobertaModel(transformers.RobertaConfig(
            max_position_embeddings=18, pad_token_id=1, type_vocab_size=1,
            **common)),
            'roberta'),
        't5': (transformers.T5EncoderModel(transformers.T5Config(
            vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4, dropout_rate=0.0, feed_forward_proj='relu',
            layer_norm_epsilon=1e-6)), 't5'),
        'deberta': (transformers.DebertaModel(transformers.DebertaConfig(
            max_position_embeddings=16, relative_attention=True,
            max_relative_positions=-1, position_biased_input=False,
            pos_att_type=['c2p', 'p2c'], type_vocab_size=0, **common)),
            'deberta'),
    }


def test_hf_models_load_into_the_port():
    """Random-weight HF models from in-code configs: their state_dicts
    load strictly (pooler, tied embeddings and index buffers accepted and
    unused) and the port gives their `last_hidden_state` at the valid
    tokens."""
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(0)
    ids, mask = inputs(2)
    for name, (hf, tower) in _hf_models(transformers).items():
        hf.eval()
        with torch.no_grad():
            ref = hf(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()
                     ).last_hidden_state.numpy()
        port = TOWERS[tower][0](**TOWERS[tower][2])
        port.load_state_dict(hf.state_dict())
        with torch.no_grad():
            got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        valid = mask[..., None].astype(bool)
        close(np.where(valid, got, 0), np.where(valid, ref, 0), name)


@pytest.mark.parametrize('prefix', ['', 'text.'])
def test_open_clip_tower_loads_into_the_port(prefix):
    """tests/test_text_variants.py's torch-MHA open_clip tower (exact
    GELU, LayerNorm eps 1e-5 there and 1e-6 in the JAX package and the
    port): its state_dict, bare or `text.`-prefixed, loads strictly."""
    torch.manual_seed(0)
    tower = _torch_open_clip_tower(torch, vocab=VOCAB, width=32, layers=2,
                                   heads=4, ctx=12).eval()
    for m in tower.modules():
        if isinstance(m, torch.nn.LayerNorm):
            m.eps = 1e-6
    ids = np.random.RandomState(2).randint(0, VOCAB, (2, 9))
    with torch.no_grad():
        ref = tower(torch.from_numpy(ids)).numpy()
    port = T.OpenCLIPTextEncoder(**TOWERS['open_clip'][2])
    port.load_state_dict({prefix + k: v for k, v in
                          tower.state_dict().items()})
    with torch.no_grad():
        close(port(torch.from_numpy(ids)), ref)


# --------------------------------------------------------------------------
# the grounder with another tower, and the CLIs
# --------------------------------------------------------------------------
def test_grounder_with_t5_small_matches_jax():
    """The tiny grounder with t_type='t5-small' (the JAX grounder builds a
    non-CLIP tower at its published size: 512 wide, 6 layers, a
    text_feat_map narrower than CLIP's) from the JAX `init`: predict
    within the detector tests' tolerance (atol 1e-5, rtol 1e-4), the
    query masks equal; then a train step leaves the tower untouched."""
    rng = np.random.RandomState(1)
    batch = {k: np.asarray(v) for k, v in tiny_batch(rng).items()}
    batch['input_ids'] = rng.randint(0, 32128, batch['input_ids'].shape
                                     ).astype(np.int32)
    jmodel = JGrounder(**TINY, t_type='t5-small')
    jb = {k: jnp.asarray(batch[k]) for k in PREDICT_KEYS}
    variables = jax.jit(lambda k, b: jmodel.init(k, b, mode='predict'))(
        jax.random.PRNGKey(0), jb)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, mode='predict'))(
        variables, jb)
    port = TGrounder(**TINY, t_type='t5-small', device='cpu')
    assert port.text_feat_map.in_features == 512
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    got = port(batch_to_device({k: batch[k] for k in PREDICT_KEYS}, 'cpu'))
    np.testing.assert_array_equal(got['query_mask'].numpy(),
                                  np.asarray(want['query_mask']))
    for k in ('bboxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)

    tower = {n: p.detach().clone()
             for n, p in port.named_parameters() if n.startswith('text_')}
    step = make_train_step(port, build_optimizer(port),
                           build_lr_schedule(1e-3, steps_per_epoch=1))
    metrics = step(batch_to_device(batch, 'cpu'),
                   torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics['total_loss']))
    params = dict(port.named_parameters())
    for n, before in tower.items():
        if param_label(n) == 'frozen':
            assert params[n].grad is None, n
            assert torch.equal(params[n], before), n
        else:                                    # text_feat_map trains
            assert not torch.equal(params[n], before), n


def test_grounder_refuses_ids_beyond_the_tower_vocabulary():
    port = TGrounder(**TINY, t_type='bert-base-uncased', device='cpu')
    ids = np.full((2, 8), 30522, np.int32)
    with pytest.raises(ValueError, match="t_type='bert-base-uncased'"):
        port.check_text_ids(ids)
    port.check_text_ids(ids - 1)


@pytest.mark.parametrize('depth', [50, 101])
def test_grounder_refuses_bottleneck_depths(depth):
    with pytest.raises(ValueError, match='64/128/256/512'):
        TGrounder(**dict(TINY, backbone3d_depth=depth), device='cpu')


def test_cli_train_then_test_with_a_clip_base_tower(tmp_path):
    """tools.train (one epoch, four steps) then tools.test on the tiny
    grounder config with `model.t_type='clip-vit-base-patch32'`: the
    full-size tower takes every id of the CLIP tokenizer."""
    from proxytransformation_torch.tools import test as ttest
    from proxytransformation_torch.tools import train as ttrain
    work = str(tmp_path / 'work')
    opts = ['--cfg-options', "model.t_type='clip-vit-base-patch32'",
            'train_dataloader.dataset.length=4',
            'val_dataloader.dataset.length=2']
    runner = ttrain.main([SMOKE, '--device', 'cpu', '--work-dir', work,
                          *opts])
    enc = runner.model.text_encoder
    assert isinstance(enc, T.CLIPTextEncoder) and enc.width == 512
    assert runner.model.text_feat_map.in_features == 512
    ckpt = sorted((tmp_path / 'work').glob('ckpt_*'))[-1]
    results = ttest.main([SMOKE, str(ckpt), '--device', 'cpu',
                          '--work-dir', work, *opts])
    assert results and all(np.isfinite(v) for v in results.values())
