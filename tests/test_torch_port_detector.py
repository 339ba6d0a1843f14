"""The port's whole predict forward against the JAX package's, on the CPU.

The tiny grounder of tests/test_detector.py (text width 64, so that the
reference-layout state dict is consistent) runs predict on the same
numpy batch on both sides, with the same weights: the port loads
`fake_reference_state_dict` directly, the JAX twin through
`convert_detector`. The selection stages (ball queries, FPS, voxel keys,
neighbor maps, top-k) agree exactly on this input, so the query masks
must be equal and the boxes and scores agree to float32 rounding
(atol=1e-5, rtol=1e-4: sums in another order).

Also here: the weights round trip, the no-JAX import guard of the port,
and the device rule of its entry point.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter.torch_weights import (
    convert_detector, fake_reference_state_dict)
from proxytransformation_tpu.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as JGrounder)
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.models.detector import (
    SparseFeatureFusion3DGrounderPreshape as TGrounder, batch_to_device)

from test_detector import tiny_batch

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(num_queries=16, voxel_size=0.05, n_points=1024,
            img_base_channels=4, text_width=64, text_layers=2, text_heads=4,
            grid_size=4, text_blocks=1, img_blocks=1, dynamic_drop_radio=0.5,
            num_sub=8, backbone3d_depth=14,
            sparse_capacities=(1024, 800, 512, 256, 128, 64),
            voxel_extent=(128, 128, 128), neck_out_channels=64,
            pts_prune_threshold=64, decoder_layers=2, embed_dims=64,
            num_heads=4, ffn_channels=128, img_spacial_dim=2,
            max_text_len=64)
PREDICT_KEYS = ('imgs', 'points', 'points_mask', 'input_ids', 'text_mask',
                'proj_mats', 'views_mask')


def tiny_state_dict(seed=0):
    return fake_reference_state_dict(
        np.random.RandomState(seed), embed_dim=64, num_heads=4,
        text_blocks=1, img_blocks=1, img_spacial_dim=2, input_dim=4 * 32,
        real_cluster=32, backbone3d_depth=14,
        neck_channels=(64 + 16, 128 + 32, 256 + 64, 512 + 128), neck_out=64,
        decoder_layers=2, dec_embed=64, dec_ffn=128, with_backbone2d=True,
        img_depth=50, img_base=4, with_text_encoder=True, text_width=64,
        text_layers=2)


def run_both():
    """(JAX predict, port predict, JAX neck tokens, port neck tokens)."""
    sd = tiny_state_dict()
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(1)).items()
             if k in PREDICT_KEYS}
    jmodel = JGrounder(**TINY)
    variables = convert_detector(sd)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda v, b: jmodel.apply(v, b, mode='predict'))(
        variables, jb)

    def jfeat(m, b):
        return m.extract_feat(b, m.encode_text(b['input_ids'],
                                               b['text_mask']), False)

    jneck = jax.jit(lambda v, b: jmodel.apply(v, b, method=jfeat))(
        variables, jb)
    port = TGrounder(**TINY, device='cpu')
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    tb = batch_to_device(batch, 'cpu')
    got = port(tb)
    with torch.no_grad():
        tneck = port.extract_feat(
            tb, port.encode_text(tb['input_ids'], tb['text_mask']))
    return want, got, jneck, tneck


@pytest.fixture(scope='module')
def both():
    return run_both()


def test_predict_matches_jax(both):
    want, got, _, _ = both
    np.testing.assert_array_equal(got['query_mask'].numpy(),
                                  np.asarray(want['query_mask']))
    assert got['query_mask'].numpy().sum() > 0
    for k in ('bboxes_3d', 'scores_3d'):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_neck_tokens_match_jax(both):
    """The (B, 4·P) token set the decoder reads: pruned voxel selection
    exact, features and positions to float32 rounding. These come out of
    ~20 stacked sparse convs and norms: an entry near zero carries the
    rounding of terms as large as the layer's activations, so the
    absolute tolerance is 1e-5 of the largest magnitude."""
    _, _, jneck, tneck = both
    np.testing.assert_array_equal(tneck[3].numpy(), np.asarray(jneck[3]))
    for i, name in ((0, 'feats'), (1, 'scores'), (2, 'xyz')):
        want = np.asarray(jneck[i])
        np.testing.assert_allclose(tneck[i].numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=1e-4,
                                   err_msg=name)


def test_state_dict_round_trip():
    sd = tiny_state_dict(seed=3)
    back = state_dict_from_jax(convert_detector(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert tuple(back[k].shape) == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_reference_state_dict_loads_strictly():
    port = TGrounder(**TINY, device='cpu')
    sd = tiny_state_dict(seed=4)
    missing, unexpected = port.load_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    assert not missing and not unexpected
    assert set(port.state_dict()) == set(sd)


def test_port_imports_no_jax():
    pattern = re.compile(
        r'^\s*(import|from)\s+(jax|flax|proxytransformation_tpu)\b', re.M)
    files = sorted((ROOT / 'proxytransformation_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_entry_point_device_rule():
    if torch.cuda.is_available():
        model = TGrounder(**TINY)
        assert model.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            TGrounder(**TINY)
    assert TGrounder(**TINY, device='cpu').device.type == 'cpu'


def tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_predict_turns_tf32_off():
    """The model owns its precision: with the caller's TF32 flags on,
    every stage of predict runs with both off, and the caller's flags
    come back after it."""
    port = TGrounder(**TINY, device='cpu')
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in tiny_state_dict(seed=5).items()})
    seen = []
    for stage in (port.backbone, port.text_encoder, port.backbone_3d,
                  port.decoder):
        stage.register_forward_pre_hook(lambda m, a: seen.append(tf32_flags()))
    batch = {k: np.asarray(v) for k, v in
             tiny_batch(np.random.RandomState(2)).items()
             if k in PREDICT_KEYS}
    saved = tf32_flags()
    try:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = (True, True)
        port(batch_to_device(batch, 'cpu'))
        assert tf32_flags() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert seen and all(flags == (False, False) for flags in seen)


def parity_report() -> None:
    """Print the slice's parity errors (port vs JAX package, CPU)."""
    want, got, jneck, tneck = run_both()
    same = np.array_equal(got['query_mask'].numpy(),
                          np.asarray(want['query_mask']))
    print(f'query_mask equal: {same}, neck selection equal: '
          f'{np.array_equal(tneck[3].numpy(), np.asarray(jneck[3]))}')
    pairs = [(k, got[k], want[k]) for k in ('bboxes_3d', 'scores_3d')]
    pairs += [(f'neck {name}', tneck[i], jneck[i])
              for i, name in ((0, 'feats'), (1, 'scores'), (2, 'xyz'))]
    for name, g, w in pairs:
        w = np.asarray(w)
        err = np.abs(g.numpy() - w)
        print(f'{name}: max abs err {err.max():.3g}, max |ref| '
              f'{np.abs(w).max():.3g}')


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_port_detector.py (from the
    # repository root; JAX on the CPU, as the tests pin it)
    jax.config.update('jax_platforms', 'cpu')
    parity_report()
