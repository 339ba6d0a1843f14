"""Launch shapes of the bf16 forward / dfeats conv kernel, on the CPU.

`csrc/sparse_conv_bf16.cu` takes its cut from `ops/sparse.py::
bf16_tile_launch` (stage width, output channels a block, column blocks,
splits of a tile's steps) and lays its stages out in shared memory as
`bf16_stage_shape` counts them; its producer writes every 16-byte copy
at the address `bf16_swizzle` mirrors. Held here: the shapes of every
conv class of the flagship, the shared memory within an H100 block's
227 KB, the swizzle a bijection within a stage that spreads the rows a
tensor-core read takes over distinct banks, and the float32 kernel's
`_tile_launch` as it was. numpy and the port only: no JAX, no card.
"""
import numpy as np
import pytest

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
