"""The rest of the port's models/misc.py against the JAX package's, on
the CPU: the anchor generators, `ChannelMapper`, `get_sine_pos_embed`,
`TransformerEncoder` and the two match costs, and their registration.

The same inputs, made from a seed with numpy, go through both sides;
`ChannelMapper` and `TransformerEncoder` run the JAX module's own
parameters, brought over by `convert.py::state_dict_from_jax`.
Tolerances:

- the anchor grids bit for bit (`linspace32` is `jnp.linspace` as XLA's
  CPU code rounds it, held bit for bit up to 34 points and within two
  float32 steps of the range beyond);
- `TransformerEncoder` (2 layers, width 32, 4 heads, with and without a
  padding mask) and `ChannelMapper` (3 levels) within NET_TOL ·
  (1 + max|ref|), their padded slots 0 on both sides;
- the positional embedding and the costs within GEO_TOL · (1 + max|ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.models import misc as jmisc
from proxytransformation_tpu.ops.sparse import SparseLevel as JLevel
from proxytransformation_tpu.utils import registry as jregistry
from proxytransformation_torch.convert import state_dict_from_jax
from proxytransformation_torch.models import misc as tmisc
from proxytransformation_torch.ops.sparse import SparseLevel as TLevel
from proxytransformation_torch.utils import registry as tregistry

NET_TOL = 1e-5
GEO_TOL = 1e-6


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rel, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = rel * (1 + np.abs(want).max())
    assert err <= tol, (what, err, tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# anchors
# --------------------------------------------------------------------------
def test_linspace32_is_jnp_linspace():
    """Every length up to 34 bit for bit, three longer ones within two
    float32 steps of the range (each length is one XLA compile)."""
    rng = np.random.RandomState(0)
    for n in (*range(1, 35), 41, 100, 257):
        for _ in range(8):
            a, b = (float(x) for x in rng.uniform(-80, 80, 2))
            if rng.rand() < 0.3:
                a, b = (float(x) for x in rng.randint(-40, 40, 2))
            want = np.asarray(jnp.linspace(a, b, n))
            got = tmisc.linspace32(a, b, n)
            if n <= 34:
                np.testing.assert_array_equal(got, want,
                                              err_msg=str((a, b, n)))
            else:
                step = np.spacing(np.float32(max(abs(a), abs(b))))
                assert np.abs(got - want).max() <= 2 * step


GRIDS = {
    # the occupancy config's range and grid, two sizes and two rotations
    'embodied_occ': dict(ranges=[[-3.2, -3.2, -0.78, 3.2, 3.2, 1.78]],
                         sizes=((0.8, 0.6, 1.1), (0.3, 0.3, 0.4)),
                         rotations=(0.0, 1.5707963), featmap=(40, 40, 16)),
    # two ranges, the class's defaults, a small odd grid
    'two_ranges': dict(ranges=[[0, -39.68, -0.6, 69.12, 39.68, -0.6],
                               [0, -2.5, -1.78, 5.0, 2.5, 0.2]],
                       featmap=(7, 5, 3)),
}


@pytest.mark.parametrize('grid', sorted(GRIDS))
@pytest.mark.parametrize('cls', ['Anchor3DRangeGenerator',
                                 'AlignedAnchor3DRangeGenerator'])
@pytest.mark.parametrize('align_corner', [False, True])
def test_anchor_grids_equal_jax(grid, cls, align_corner):
    kw = dict(GRIDS[grid])
    featmap = kw.pop('featmap')
    tgen = getattr(tmisc, cls)(align_corner=align_corner, **kw)
    jgen = getattr(jmisc, cls)(align_corner=align_corner, **kw)
    got = tgen.grid_anchors(featmap, device='cpu')
    want = jgen.grid_anchors(featmap)
    assert len(got) == len(want) == len(kw['ranges'])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == 'cpu'
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_anchor_grid_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    gen = tmisc.Anchor3DRangeGenerator([[0, 0, 0, 1, 1, 1]])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gen.grid_anchors((2, 2, 2))


# --------------------------------------------------------------------------
# ChannelMapper
# --------------------------------------------------------------------------
def _levels(rng, chans, B=2, V=37):
    out = []
    for c in chans:
        mask = rng.rand(B, V) > 0.3
        feats = rng.randn(B, V, c).astype(np.float32) * mask[..., None]
        keys = np.where(mask, np.arange(V), 2**31 - 1).astype(np.int32)
        coords = rng.randint(0, 50, (B, V, 3)).astype(np.int32)
        origin = rng.randn(B, 3).astype(np.float32)
        out.append((keys, coords, feats, mask, origin))
    return out


def test_channel_mapper_matches_jax():
    rng = np.random.RandomState(1)
    chans = (16, 24, 40)
    raw = _levels(rng, chans)
    jlevels = [JLevel(*(jnp.asarray(a) for a in r)) for r in raw]
    jmod = jmisc.ChannelMapper(out_channels=32)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jlevels))
    want = jmod.apply(variables, jlevels)
    tmod = tmisc.ChannelMapper(chans, 32, device='cpu')
    tmod.load_state_dict(state_dict_from_jax(variables))
    got = tmod([TLevel(*(torch.from_numpy(a) for a in r)) for r in raw])
    assert len(got) == len(want) == 3
    for g, w, r in zip(got, want, raw):
        close(g.feats.detach(), w.feats, NET_TOL)
        assert not g.feats[~torch.from_numpy(r[3])].any()
        np.testing.assert_array_equal(g.keys.numpy(), r[0])


# --------------------------------------------------------------------------
# TransformerEncoder
# --------------------------------------------------------------------------
@pytest.fixture(scope='module')
def encoder():
    """The JAX encoder (2 layers, width 32, 4 heads, FFN 64) with its
    initial parameters, and the port's from the same ones."""
    jmod = jmisc.TransformerEncoder(embed_dims=32, num_layers=2,
                                    num_heads=4, feedforward_channels=64)
    x = jnp.zeros((2, 11, 32), jnp.float32)
    variables = _np(jmod.init(jax.random.PRNGKey(3), x))
    tmod = tmisc.TransformerEncoder(32, 2, 4, 64, device='cpu')
    tmod.load_state_dict(state_dict_from_jax(variables))
    return jmod, variables, tmod


@pytest.mark.parametrize('masked', [False, True])
def test_transformer_encoder_matches_jax(encoder, masked):
    jmod, variables, tmod = encoder
    rng = np.random.RandomState(4)
    x = rng.randn(2, 11, 32).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 11), bool)
        mask[0, 7:] = False
        mask[1, 3:5] = False
    want = jmod.apply(variables, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
    close(got, want, NET_TOL)


def test_state_dict_from_jax_fills_every_encoder_tensor(encoder):
    _, variables, tmod = encoder
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(tmod.state_dict())
    assert len(sd) == 2 * 12


# --------------------------------------------------------------------------
# the positional embedding and the costs
# --------------------------------------------------------------------------
@pytest.mark.parametrize('num_feats', [16, 128])
def test_sine_pos_embed_matches_jax(num_feats):
    pos = np.random.RandomState(5).uniform(-2, 6, (3, 50, 3)).astype(
        np.float32)
    got = tmisc.get_sine_pos_embed(torch.from_numpy(pos), num_feats)
    want = jmisc.get_sine_pos_embed(jnp.asarray(pos), num_feats)
    assert got.shape == (3, 50, 3 * num_feats)
    close(got, want, GEO_TOL)


def test_match_costs_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(20, 9).astype(np.float32) * 3
    labels = rng.randint(0, 9, 5)
    close(tmisc.focal_loss_cost(torch.from_numpy(logits),
                                torch.from_numpy(labels)),
          jmisc.focal_loss_cost(jnp.asarray(logits), jnp.asarray(labels)),
          GEO_TOL)
    gt = rng.rand(5, 9).astype(np.float32)
    close(tmisc.token_map_cost(torch.from_numpy(logits),
                               torch.from_numpy(gt)),
          jmisc.token_map_cost(jnp.asarray(logits), jnp.asarray(gt)),
          GEO_TOL)


def test_registered_under_the_jax_names():
    for reg, names in (('TASK_UTILS', ('Anchor3DRangeGenerator',
                                       'AlignedAnchor3DRangeGenerator')),
                       ('MODELS', ('ChannelMapper', 'TransformerEncoder'))):
        for name in names:
            assert name in getattr(jregistry, reg)
            assert getattr(tregistry, reg).get(name) is getattr(tmisc, name)
    built = tregistry.MODELS.build(dict(type='TransformerEncoder',
                                        embed_dims=16, num_layers=1,
                                        num_heads=2, feedforward_channels=8,
                                        device='cpu'))
    assert len(built.layers) == 1
