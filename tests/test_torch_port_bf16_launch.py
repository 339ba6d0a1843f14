"""Launch shapes of the bf16 forward / dfeats conv kernel, on the CPU.

`csrc/sparse_conv_bf16.cu` takes its cut from `ops/sparse.py::
bf16_tile_launch` (stage width, output channels a block, column blocks,
splits of a tile's steps) and lays its stages out in shared memory as
`bf16_stage_shape` counts them; its producer writes every 16-byte copy
at the address `bf16_swizzle` mirrors. Held here: the shapes of every
conv class of the flagship, the shared memory within an H100 block's
227 KB, the swizzle a bijection within a stage that spreads the rows a
tensor-core read takes over distinct banks, and the float32 kernel's
`_tile_launch` as it was.

The bf16 dW kernel takes its cut from `bf16_dw_launch` and its splits
from the device's split table, which `bf16_dw_split_table` mirrors; its
copies land where `bf16_dw_copy_offset` says. Held here: every flagship
dW class (shared memory, splits within one wave, split partials under a
quarter of the float32 rule's), the table covering every hit once, a
torch replay of the split plan against the plain bf16 dW, and the
float32 kernel's `dw_launch_shape` as it was. numpy, torch and the port
only: no JAX, no card.
"""
import numpy as np
import pytest
import torch

from proxytransformation_torch.ops import sparse as sp

H100_SMS = 132
# (class, V_out, C_in, C_out) of the flagship's bf16 convs (MinkResNet-34
# with capacities 50k / 20k / 6k / 2k, the neck at up to 4000 rows), and
# of their input gradients: the strided convs' over the finer level
FLAGSHIP_FORWARD = [
    ('stage 1 strided', 50_000, 64, 64), ('stage 1 self', 50_000, 64, 64),
    ('stage 2 strided', 20_000, 64, 128), ('stage 2 self', 20_000, 128, 128),
    ('stage 3 strided', 6000, 128, 256), ('stage 3 self', 6000, 256, 256),
    ('stage 4 strided', 2000, 256, 512), ('stage 4 self', 2000, 512, 512),
    ('neck out 3', 2000, 1024, 256), ('neck up 3', 4000, 512, 512),
    ('neck out 2', 4000, 512, 256), ('neck up 2', 4000, 256, 256),
    ('neck out 1', 4000, 256, 256), ('neck up 1', 4000, 128, 128),
    ('neck out 0', 4000, 128, 256)]
FLAGSHIP_DFEATS = [
    ('stage 1 strided', 80_000, 64, 64), ('stage 2 strided', 50_000, 128, 64),
    ('stage 3 strided', 20_000, 256, 128), ('stage 4 strided', 6000, 512, 256),
    *[(label, V, C_out, C_in) for label, V, C_in, C_out in FLAGSHIP_FORWARD
      if 'strided' not in label]]
ALL_CLASSES = FLAGSHIP_FORWARD + FLAGSHIP_DFEATS
KERNEL_SHAPES = [(64, 64), (64, 128), (64, 256), (32, 64), (16, 64)]


@pytest.mark.parametrize('label,V,C_in,C_out', ALL_CLASSES)
def test_flagship_classes_gather_once_for_up_to_256_channels(label, V, C_in,
                                                            C_out):
    """Every flagship width is a multiple of 64: 64-channel stages, N =
    C_out up to 256 (one gather of the rows for all of C_out), a column
    block for each further 256 (512: two, the neck's 1024-wide input
    gradient: four); a ring of 4-8 stages in 192 KB, one block an SM."""
    cut = sp.bf16_tile_launch(2, V, C_in, C_out, H100_SMS)
    assert cut.kc == 64
    assert cut.bn == min(C_out, 256)
    assert cut.col_blocks == max(1, C_out // 256)
    assert (cut.stages, cut.smem) == sp.bf16_stage_shape(cut.kc, cut.bn)
    assert cut.stages == {64: 8, 128: 6, 256: 4}[cut.bn]
    assert cut.smem <= sp.SMEM_PER_BLOCK
    assert 1 <= cut.splits <= 8


@pytest.mark.parametrize('V', [50_000, 20_000, 6000, 4000, 2000, 900, 130, 1])
@pytest.mark.parametrize('C_in,C_out', [(64, 64), (128, 128), (512, 256),
                                        (256, 512), (48, 80), (96, 16)])
def test_splits_fill_the_card_and_only_small_levels_split(V, C_in, C_out):
    """A call splits only when its tiles fill less than a wave of one
    block an SM; the splits then give one to two waves (at most 8)."""
    cut = sp.bf16_tile_launch(2, V, C_in, C_out, H100_SMS)
    blocks = 2 * -(-V // sp.BF16_TILE_ROWS) * cut.col_blocks
    if blocks >= H100_SMS:
        assert cut.splits == 1
    else:
        assert 2 <= cut.splits <= 8
        assert blocks * cut.splits <= 2 * H100_SMS
        assert blocks * cut.splits >= H100_SMS or cut.splits == 8


@pytest.mark.parametrize('C_in,kc', [(16, 16), (48, 16), (80, 16), (32, 32),
                                     (96, 32), (160, 32), (64, 64),
                                     (1024, 64)])
def test_stage_width_divides_c_in(C_in, kc):
    """A stage is 64 input channels, 32 or 16 where C_in is not a
    multiple of 64 (then 64 output channels a block)."""
    cut = sp.bf16_tile_launch(2, 5000, C_in, 256, H100_SMS)
    assert cut.kc == kc and C_in % kc == 0
    assert cut.bn == (256 if kc == 64 else 64)


@pytest.mark.parametrize('kc,bn', KERNEL_SHAPES)
def test_stage_shapes_fit_one_block_an_sm(kc, bn):
    """The ring holds 4 to 8 stages, all of it within 192 KB; with the
    barriers, the tile's rows and the alignment slack within 232,448
    bytes; every stage a whole number of 1024-byte swizzle atoms."""
    stages, smem = sp.bf16_stage_shape(kc, bn)
    stage = 2 * kc * (sp.BF16_TILE_ROWS + bn)
    assert 4 <= stages <= sp.BF16_MAX_STAGES
    assert stages * stage <= sp.BF16_RING_BYTES
    assert stage % 1024 == 0 and (2 * kc * sp.BF16_TILE_ROWS) % 1024 == 0
    assert smem == stages * stage + sp.BF16_BLOCK_FIXED_BYTES
    assert smem <= sp.SMEM_PER_BLOCK


def _stage_offsets(kc, bn):
    """Byte offsets, before the swizzle, of every 16-byte copy of a stage
    as the kernel's producer computes them: the gathered rows (row r,
    chunk c: r * 2kc + 16c), then the W slice in 64-column atoms of kc
    rows of 128 bytes (row k, chunk nc: ((nc // 8) * kc + k) * 128 +
    16 * (nc % 8)). Returns (A offsets (rows, chunks), W offsets (kc, bn
    / 8), the A bytes)."""
    row = 2 * kc
    r, c = np.meshgrid(np.arange(sp.BF16_TILE_ROWS), np.arange(kc // 8),
                       indexing='ij')
    a = r * row + c * 16
    k, nc = np.meshgrid(np.arange(kc), np.arange(bn // 8), indexing='ij')
    w = ((nc // 8) * kc + k) * 128 + (nc % 8) * 16
    return a, w, sp.BF16_TILE_ROWS * row


@pytest.mark.parametrize('kc,bn', KERNEL_SHAPES)
def test_swizzle_is_a_bijection_within_a_stage(kc, bn):
    """Every copy of a stage lands on its own 16-byte slot, and the slots
    tile the stage: the gathered rows' [0, kA) and the W slice's
    [kA, kA + kW), each a bijection."""
    a, w, a_bytes = _stage_offsets(kc, bn)
    sa = sp.bf16_swizzle(a, 2 * kc)
    sw = a_bytes + sp.bf16_swizzle(w, 128)
    for got, lo, n in ((sa, 0, a.size), (sw, a_bytes, w.size)):
        assert np.all(got % 16 == 0)
        assert np.array_equal(np.sort(got.ravel()),
                              lo + 16 * np.arange(n))


@pytest.mark.parametrize('row_bytes', [128, 64, 32])
def test_swizzle_spreads_a_core_matrix_over_the_banks(row_bytes):
    """A wgmma core matrix is one 16-byte chunk of 8 consecutive rows:
    after the swizzle those 8 chunks sit in 8 distinct 16-byte bank
    groups (128 bytes of banks), so a read of them takes one pass. The
    swizzle keeps a row's chunks within its row and is its own inverse."""
    chunks = row_bytes // 16
    for r0 in range(0, 64, 8):
        for c in range(chunks):
            off = np.array([(r0 + i) * row_bytes + c * 16 for i in range(8)])
            got = sp.bf16_swizzle(off, row_bytes)
            assert len(set((got // 16 % 8).tolist())) == 8
            assert np.array_equal(got // row_bytes, off // row_bytes)
            assert np.array_equal(sp.bf16_swizzle(got, row_bytes), off)


def _tile_launch_pr6(B, V_out, C_out, n_sm):
    """The float32 tile path's rule as the float32 kernels were built
    for (ops/sparse.py::_tile_launch), frozen."""
    cols = 64 if C_out <= 64 else 128
    blocks = B * -(-V_out // 128) * -(-C_out // cols)
    target = 10 * n_sm
    splits = 1 if blocks >= target else min(16, -(-target // blocks))
    return cols, splits


@pytest.mark.parametrize('B', [1, 2, 6])
def test_float32_tile_launch_unchanged(B):
    for V in (1, 130, 2000, 4000, 6000, 20_000, 50_000, 100_000):
        for C_out in (3, 16, 64, 96, 128, 256, 512):
            for n_sm in (132, 114):
                assert sp._tile_launch(B, V, C_out, n_sm) == \
                    _tile_launch_pr6(B, V, C_out, n_sm)


# ---------------------------------------------------------------- dW
# (class, calls a step, C_in, C_out, hits a call) of the flagship's bf16
# dW calls, hits as the float32 dW's bound counted them on an H100
# (`chip_smoke.py`); the hits spread over 27 offsets by `_offset_counts`
FLAGSHIP_DW = [('stage 1 self', 5, 64, 64, 664_000),
               ('stage 2 self', 7, 128, 128, 254_000),
               ('stage 3 self', 11, 256, 256, 73_000),
               ('stage 4 self', 5, 512, 512, 14_000),
               ('neck', 7, 256, 256, 70_000)]
DW_KERNEL_SHAPES = [(64, 64), (64, 128), (64, 256), (128, 64), (128, 128),
                    (128, 256)]


def _offset_counts(hits, K3=27, seed=0):
    """`hits` spread over K3 offsets: each 0.4-1.0 of the others'
    share, the center offset the most (every kept row hits itself)."""
    w = np.random.RandomState(seed).uniform(0.4, 1.0, K3)
    w[K3 // 2] = 1.2
    return [int(x) for x in hits * w / w.sum()]


def _split_bytes(counts, C_in, C_out):
    """Bytes of float32 split partials a call writes: under the bf16 dW
    rule (`bf16_dw_split_table`: offsets with more than one split), and
    under the float32 kernel's `dw_launch_shape` (every split), the rule
    the bf16 kernel took before `bf16_dw_launch`."""
    cut = sp.bf16_dw_launch(len(counts), C_in, C_out, H100_SMS)
    _, S = sp.bf16_dw_split_table(counts, cut.max_splits)
    _, _, target, _ = sp.dw_launch_shape(200_000, len(counts), C_in, C_out,
                                         H100_SMS)
    _, old = sp.dw_split_table(counts, target)
    cc = 4 * C_in * C_out
    return sum(s for s in S if s > 1) * cc, sum(old) * cc


@pytest.mark.parametrize('label,calls,C_in,C_out,hits', FLAGSHIP_DW)
def test_dw_flagship_classes(label, calls, C_in, C_out, hits):
    """Every flagship dW class: 128 input channels a block (64 at C_in
    64), N = min(C_out, 256); a ring of 4-12 stages within 232,448 bytes
    of shared memory; splits only where the K3 x tiles blocks leave room
    in one wave of one block an SM, and then at most one wave of them."""
    K3 = 27
    cut = sp.bf16_dw_launch(K3, C_in, C_out, H100_SMS)
    assert cut.bm == min(128, C_in) and cut.bn == min(256, C_out)
    assert cut.tiles == (C_in // cut.bm) * (C_out // cut.bn)
    assert (cut.stages, cut.smem) == sp.bf16_dw_stage_shape(cut.bm, cut.bn)
    assert 4 <= cut.stages <= sp.BF16_DW_MAX_STAGES
    assert cut.smem <= sp.SMEM_PER_BLOCK
    counts = _offset_counts(hits)
    chunk, S = sp.bf16_dw_split_table(counts, cut.max_splits)
    assert sum(S) <= cut.max_splits
    if K3 * cut.tiles >= H100_SMS:  # stage 4 self: 216 blocks, no split
        assert cut.max_splits == K3 and cut.sum_blocks == 0 and max(S) == 1
    else:
        assert K3 * cut.tiles < sum(S) * cut.tiles <= H100_SMS
        assert cut.sum_blocks >= 1
    assert chunk >= sp.BF16_DW_MIN_HITS
    new, old = _split_bytes(counts, C_in, C_out)
    assert new <= old / 4


def test_dw_flagship_step_writes_a_quarter_of_the_partials():
    """Summed over a bf16 step's self and neck calls, the split partials
    of the bf16 dW rule are under a quarter of those the
    float32 rule wrote (~2.2 GB a step)."""
    new = old = 0
    for _, calls, C_in, C_out, hits in FLAGSHIP_DW:
        n, o = _split_bytes(_offset_counts(hits), C_in, C_out)
        new, old = new + calls * n, old + calls * o
    assert 2.0e9 < old < 2.5e9
    assert new < old / 4


@pytest.mark.parametrize('K3,max_splits', [(27, 132), (27, 66), (27, 33),
                                           (27, 27), (8, 132), (8, 5),
                                           (1, 132), (32, 40)])
@pytest.mark.parametrize('kind', ['flagship', 'skewed', 'sparse', 'empty',
                                  'tiny'])
def test_dw_split_table_covers_every_hit_once(K3, max_splits, kind):
    """The split table's mirror: every hit of every offset in exactly one
    split, in order (split s of offset k takes hits [s * chunk, (s + 1)
    * chunk) of k's list); an offset without a hit takes one split (its
    block writes zeros); the grid's max_splits hold every split; the
    chunk is the least that fits (or no offset splits) and at least
    BF16_DW_MIN_HITS; an offset with one split takes no workspace slot,
    the others' slots fit the workspace the wrapper allocates."""
    rng = np.random.RandomState(K3 + max_splits)
    counts = {'flagship': _offset_counts(254_000, K3),
              'skewed': [int(x) for x in 40_000 * rng.rand(K3) ** 4],
              'sparse': [int(x) if rng.rand() < 0.5 else 0
                         for x in 9000 * rng.rand(K3)],
              'empty': [0] * K3,
              'tiny': [int(x) for x in rng.randint(0, 300, K3)]}[kind]
    chunk, S = sp.bf16_dw_split_table(counts, max_splits)
    assert len(S) == K3 and sum(S) <= max(max_splits, K3)
    for c, n in zip(counts, S):
        ranges = [(s * chunk, min((s + 1) * chunk, c)) for s in range(n)]
        covered = [h for lo, hi in ranges for h in range(lo, hi)]
        assert covered == list(range(c))
        assert n == 1 or all(hi > lo for lo, hi in ranges)
    assert chunk >= sp.BF16_DW_MIN_HITS or max(S) == 1
    if K3 < max_splits and chunk > sp.BF16_DW_MIN_HITS:
        smaller = sum(max(1, -(-c // (chunk - 1))) for c in counts)
        assert smaller > max_splits
    slots = sum(n for n in S if n > 1)
    assert slots <= max_splits and (slots == 0 or K3 < max_splits)


def _replay_split_dw(feats, nbr, g, plan, max_splits):
    """dW as the bf16 kernel cuts it, in plain torch: each split's
    partial over its hits (bf16 values, float32 sums), written directly
    for an offset with one split, else added in split order."""
    B, V_in, C_in = feats.shape
    x = feats.to(torch.bfloat16).float().reshape(-1, C_in)
    gf = g.to(torch.bfloat16).float().reshape(-1, g.shape[-1])
    V_out, K3 = nbr.shape[1:]
    counts = plan.hit_counts.tolist()
    chunk, S = sp.bf16_dw_split_table(counts, max_splits)
    dw = torch.empty(K3, C_in, g.shape[-1])
    for k in range(K3):
        parts = []
        for s in range(S[k]):
            r = plan.hits[k, s * chunk:min((s + 1) * chunk, counts[k])].long()
            src = (r // V_out) * V_in + nbr.reshape(-1, K3)[r, k].long()
            parts.append(x[src].t() @ gf[r])
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        dw[k] = acc
    return dw, S


@pytest.mark.parametrize('max_splits', [5, 27, 60])
def test_dw_split_replay_matches_plain(max_splits):
    """A torch replay of the split plan on a small map (an offset without
    a hit, offsets split several ways) equals the plain bf16 dW within
    the float32 tolerance, and the empty offset is exactly zero."""
    rng = np.random.RandomState(max_splits)
    B, V_in, V_out, K3, C_in, C_out = 2, 900, 700, 27, 48, 80
    nbr = rng.randint(0, V_in, (B, V_out, K3))
    nbr = np.where(rng.rand(B, V_out, K3) < 0.6, nbr, -1)
    nbr[..., 4] = -1
    nbr = torch.tensor(nbr.astype(np.int32))
    feats = torch.tensor(rng.randn(B, V_in, C_in).astype(np.float32))
    g = torch.tensor(rng.randn(B, V_out, C_out).astype(np.float32))
    plan = sp.conv_plan(nbr)
    got, S = _replay_split_dw(feats, nbr, g, plan, max_splits)
    if max_splits > K3:
        assert max(S) >= 2
    want = sp.sparse_conv_dw_plain_bf16(feats, nbr, g)
    tol = 1e-4 * (1.0 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    assert bool((got[4] == 0).all())


@pytest.mark.parametrize('bm,bn', DW_KERNEL_SHAPES)
def test_dw_stage_shapes_fit_one_block_an_sm(bm, bn):
    """A dW ring holds 4 to 12 stages of 64 hits within 192 KB, each
    operand tile a whole number of 8192-byte atoms; the index ring
    holds the 3D steps the hit rows run ahead (D = stages - 2)."""
    stages, smem = sp.bf16_dw_stage_shape(bm, bn)
    stage = 2 * sp.BF16_DW_HITS * (bm + bn)
    assert 4 <= stages <= sp.BF16_DW_MAX_STAGES
    assert stages * stage <= sp.BF16_DW_RING_BYTES
    assert (2 * sp.BF16_DW_HITS * bm) % 8192 == 0 and stage % 8192 == 0
    assert 3 * (stages - 2) < sp.BF16_DW_IDX_SLOTS
    assert smem == stages * stage + sp.BF16_DW_FIXED_BYTES
    assert smem <= sp.SMEM_PER_BLOCK


@pytest.mark.parametrize('width', [64, 128, 256])
def test_dw_copy_offsets_are_a_bijection(width):
    """Every 16-byte copy of a dW operand tile (64 hits x width
    channels) lands on its own slot and the slots tile the operand, and
    the 8 copies of one core matrix (8 consecutive hits, one 8-channel
    chunk) sit in 8 distinct 16-byte bank groups."""
    h, c = np.meshgrid(np.arange(sp.BF16_DW_HITS), np.arange(0, width, 8),
                       indexing='ij')
    off = sp.bf16_dw_copy_offset(h, c)
    assert np.array_equal(np.sort(off.ravel()),
                          16 * np.arange(sp.BF16_DW_HITS * width // 8))
    for h0 in range(0, sp.BF16_DW_HITS, 8):
        for ch in range(0, width, 8):
            got = sp.bf16_dw_copy_offset(np.arange(h0, h0 + 8), ch)
            assert len(set((got // 16 % 8).tolist())) == 8


@pytest.mark.parametrize('C_in,C_out', [(16, 16), (48, 80), (96, 16),
                                        (64, 512), (1024, 256), (160, 48)])
def test_dw_launch_for_other_widths(C_in, C_out):
    """Widths the wrapper pads to 16: the block covers them with zero
    channels past C_in / C_out; the sum pass launches only where an
    offset can split."""
    for K3 in (27, 8):
        cut = sp.bf16_dw_launch(K3, C_in, C_out, H100_SMS)
        assert cut.bm == (64 if C_in <= 64 else 128)
        assert cut.bn == (64 if C_out <= 64 else 128 if C_out <= 128
                          else 256)
        assert cut.max_splits >= K3
        assert (cut.sum_blocks > 0) == (cut.max_splits > K3)
        assert cut.sum_blocks <= 2 * H100_SMS


def _dw_launch_shape_frozen(rows, K3, C_in, C_out, n_sm):
    """The float32 dW kernel's rule as it was built (ops/sparse.py::
    dw_launch_shape), frozen."""
    tm = 0 if C_in <= 4 else 8 if C_in > 64 else 4
    tn = 8 if C_out > 64 and tm else 4
    c_tiles = 1 if tm == 0 else -(-C_in // (16 * tm))
    tiles = c_tiles * -(-C_out // (16 * tn))
    pairs_target = max(1, -(-8 * n_sm // tiles))
    grid_pairs = max(pairs_target, -(-K3 * rows // 4096)) + K3
    return tm, tn, pairs_target, grid_pairs


def test_float32_dw_launch_shape_unchanged():
    for rows in (1, 260, 4000, 12_000, 100_000, 200_000):
        for C_in in (3, 16, 64, 96, 128, 256, 512):
            for C_out in (3, 64, 128, 256, 512):
                for K3 in (27, 8):
                    assert sp.dw_launch_shape(rows, K3, C_in, C_out, 132) == \
                        _dw_launch_shape_frozen(rows, K3, C_in, C_out, 132)
