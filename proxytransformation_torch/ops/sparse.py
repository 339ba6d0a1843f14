"""Sparse 3D voxel engine: levels, coordinate maps and sparse convs.

Counterpart of proxytransformation_tpu/ops/sparse.py (a MinkowskiEngine
replacement with static shapes). A level is a capacity-bounded set of
voxels per sample: int32 linearized keys sorted ascending (invalid slots
hold SENTINEL), integer coords, features and a validity mask. Neighbor
maps are lookups of shifted keys in the sorted keys, built once per
level pair and shared by every conv on that pair, together with the
map's `conv_plan` (row hit masks, mask-sorted rows, per-offset hit
lists) that the sparse-conv kernels read.

Kernels (`csrc/`), each with its plain PyTorch version here: the
q-1/q/q+1 key lookup (`lookup_pmz.cu`), its center-only form, the
gather-GEMM sparse convolution (`sparse_conv.cu`, also the input
gradient) and its weight gradient (`sparse_conv_dw.cu`), and the bf16
form of both convs (`sparse_conv_bf16.cu`, on the tensor cores), which
bfloat16 features take. A CUDA tensor launches the kernel, a CPU tensor
takes the plain version (which does not read the plan).

Every sort is stable, like every `jnp.argsort` of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .common import recip32

SENTINEL = 2**31 - 1

Extent = Tuple[int, int, int]
DEFAULT_EXTENT: Extent = (1280, 1280, 512)

LOOKUP_PMZ = _cuda.CudaKernel(
    'lookup_pmz', 'lookup_pmz', 'ptt_lookup_pmz',
    [_cuda.ptr, _cuda.ptr, *[_cuda.i32] * 5, *[_cuda.ptr] * 5],
    source='proxytransformation_torch/csrc/lookup_pmz.cu',
    replaces='proxytransformation_tpu/ops/merge_join_pallas.py:194')
LOOKUP_CENTER = _cuda.CudaKernel(
    'lookup_center', 'lookup_pmz', 'ptt_lookup_center',
    [_cuda.ptr, _cuda.ptr, *[_cuda.i32] * 5, *[_cuda.ptr] * 3],
    source='proxytransformation_torch/csrc/lookup_pmz.cu',
    replaces='proxytransformation_tpu/ops/merge_join_pallas.py:287')
_CONV_ARGS = [*[_cuda.ptr] * 6, *[_cuda.i32] * 10, *[_cuda.ptr] * 3]
SPARSE_CONV = _cuda.CudaKernel(
    'sparse_conv', 'sparse_conv', 'ptt_sparse_conv', _CONV_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
# the same source launched by the conv's backward for the input gradient
# (reference ops/sparse.py:515, :534) as its own kernel symbols, counted
# and timed on its own
SPARSE_CONV_DFEATS = _cuda.CudaKernel(
    'sparse_conv_dfeats', 'sparse_conv', 'ptt_sparse_conv', _CONV_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
SPARSE_CONV_DW = _cuda.CudaKernel(
    'sparse_conv_dw', 'sparse_conv_dw', 'ptt_sparse_conv_dw',
    [*[_cuda.ptr] * 5, *[_cuda.i32] * 10, *[_cuda.ptr] * 3],
    source='proxytransformation_torch/csrc/sparse_conv_dw.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:399')
# the bf16 forms: bf16 operands on the tensor cores, float32 sums
_CONV_BF16_ARGS = [*[_cuda.ptr] * 6, *[_cuda.i32] * 11, *[_cuda.ptr] * 3]
SPARSE_CONV_BF16 = _cuda.CudaKernel(
    'sparse_conv_bf16', 'sparse_conv_bf16', 'ptt_sparse_conv_bf16',
    _CONV_BF16_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv_bf16.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
SPARSE_CONV_DFEATS_BF16 = _cuda.CudaKernel(
    'sparse_conv_dfeats_bf16', 'sparse_conv_bf16', 'ptt_sparse_conv_bf16',
    _CONV_BF16_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv_bf16.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
SPARSE_CONV_DW_BF16 = _cuda.CudaKernel(
    'sparse_conv_dw_bf16', 'sparse_conv_bf16', 'ptt_sparse_conv_dw_bf16',
    [*[_cuda.ptr] * 5, *[_cuda.i32] * 10, *[_cuda.ptr] * 3],
    source='proxytransformation_torch/csrc/sparse_conv_bf16.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:399')


@dataclasses.dataclass
class SparseLevel:
    """One resolution level of a batched sparse voxel grid.

    keys (B, V) int32 sorted ascending, SENTINEL at invalid slots;
    coords (B, V, 3) int32 in this level's units; feats (B, V, C);
    mask (B, V) bool; origin (B, 3) world position of coord (0, 0, 0);
    extent, stride (in finest-level units) and voxel_size are static.
    """
    keys: torch.Tensor
    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    origin: torch.Tensor
    extent: Extent = DEFAULT_EXTENT
    stride: int = 1
    voxel_size: float = 0.01

    def _replace(self, **kw) -> 'SparseLevel':
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def world_xyz(self) -> torch.Tensor:
        """(B, V, 3) world positions of the voxels (0 at invalid slots)."""
        xyz = (self.origin[:, None, :]
               + self.coords.float() * (self.stride * self.voxel_size))
        return torch.where(self.mask[..., None], xyz, torch.zeros_like(xyz))

    @property
    def C(self) -> torch.Tensor:
        """MinkowskiEngine-style (N, 4) [b, x, y, z] of the valid voxels,
        in finest-voxel units."""
        b = torch.arange(self.keys.shape[0], device=self.keys.device)
        b = b[:, None].expand_as(self.mask)[self.mask]
        return torch.cat([b[:, None].to(torch.int32),
                          self.coords[self.mask] * self.stride], dim=1)

    @property
    def F(self) -> torch.Tensor:
        """MinkowskiEngine-style (N, C) features of the valid voxels."""
        return self.feats[self.mask]


def linearize(coords: torch.Tensor, extent: Extent) -> torch.Tensor:
    """(…, 3) int coords → int32 keys. Caller guarantees in-extent."""
    ex, ey, ez = extent
    if ex * ey * ez >= 2**31:
        raise ValueError(f'extent {extent} overflows int32 keys')
    c = coords.to(torch.int32)
    return (c[..., 0] * ey + c[..., 1]) * ez + c[..., 2]


def _delinearize(keys: torch.Tensor, extent: Extent) -> torch.Tensor:
    ex, ey, ez = extent
    z = keys % ez
    y = (keys // ez) % ey
    x = keys // (ey * ez)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def _compact_unique(keys: torch.Tensor, payload: torch.Tensor,
                    valid: torch.Tensor, capacity: int):
    """Per-row sorted keys (B, N) → first-occurrence unique, compacted to
    `capacity` slots, still sorted. The FIRST payload of each run is kept.
    Returns out_keys, out_payload (B, capacity) and out_mask."""
    B = keys.shape[0]
    prev = torch.cat([torch.full_like(keys[:, :1], -1), keys[:, :-1]], dim=1)
    is_first = valid & (keys != prev)
    pos = torch.cumsum(is_first.to(torch.int64), dim=1) - 1
    write = is_first & (pos < capacity)
    # unwritten rows all go to one spare slot past the end, then dropped
    slot = torch.where(write, pos, torch.full_like(pos, capacity))
    out_keys = torch.full((B, capacity + 1), SENTINEL, dtype=torch.int32,
                          device=keys.device).scatter_(1, slot, keys)
    out_payload = torch.zeros((B, capacity + 1), dtype=payload.dtype,
                              device=keys.device).scatter_(1, slot, payload)
    out_mask = torch.zeros((B, capacity + 1), dtype=torch.bool,
                           device=keys.device).scatter_(1, slot, write)
    return (out_keys[:, :capacity], out_payload[:, :capacity],
            out_mask[:, :capacity])


# --------------------------------------------------------------------------
# voxelization and coordinate maps
# --------------------------------------------------------------------------
def voxelize_points(points: torch.Tensor, mask: torch.Tensor,
                    feats: torch.Tensor, voxel_size: float, capacity: int,
                    extent: Extent = DEFAULT_EXTENT) -> SparseLevel:
    """Quantize padded clouds (B, N, 3) into the finest sparse level,
    keeping the first point's features in each occupied voxel."""
    big = torch.full_like(points, 1e9)
    origin = torch.amin(torch.where(mask[..., None], points, big), dim=1,
                        keepdim=True)
    q = torch.floor((points - origin) * recip32(voxel_size)).to(torch.int32)
    ext = torch.tensor(extent, dtype=torch.int32, device=points.device)
    in_bounds = torch.all((q >= 0) & (q < ext), dim=-1) & mask
    keys = torch.where(in_bounds, linearize(q, extent),
                       torch.full_like(q[..., 0], SENTINEL))
    order = torch.argsort(keys, dim=1, stable=True)
    k_sorted = torch.gather(keys, 1, order)
    out_keys, payload, out_mask = _compact_unique(
        k_sorted, order, k_sorted != SENTINEL, capacity)
    C = feats.shape[-1]
    of = torch.gather(feats, 1, payload[..., None].expand(-1, -1, C))
    of = torch.where(out_mask[..., None], of, torch.zeros_like(of))
    coords = _delinearize(out_keys, extent)
    coords = torch.where(out_mask[..., None], coords, torch.zeros_like(coords))
    return SparseLevel(out_keys, coords, of, out_mask, origin[:, 0],
                       tuple(extent), 1, voxel_size)


def _shrink_extent(extent: Extent, factor: int = 2) -> Extent:
    return tuple(-(-e // factor) for e in extent)


def downsample_coords(level: SparseLevel, capacity: int) -> SparseLevel:
    """Stride-2 output coordinate map: unique(floor(coords / 2)).
    Features are zero-initialised; the conv fills them in."""
    new_extent = _shrink_extent(level.extent)
    parent = level.coords // 2
    pkeys = torch.where(level.mask, linearize(parent, new_extent),
                        torch.full_like(level.keys, SENTINEL))
    ks = torch.sort(pkeys, dim=1, stable=True).values
    out_keys, _, out_mask = _compact_unique(ks, torch.zeros_like(ks),
                                            ks != SENTINEL, capacity)
    coords = _delinearize(out_keys, new_extent)
    coords = torch.where(out_mask[..., None], coords, torch.zeros_like(coords))
    feats = torch.zeros((level.keys.shape[0], capacity, 1),
                        dtype=level.feats.dtype, device=level.feats.device)
    return SparseLevel(out_keys, coords, feats, out_mask, level.origin,
                       new_extent, level.stride * 2, level.voxel_size)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """Integer kernel offsets, ME convention: odd → centered, even → [0, k)."""
    if kernel_size % 2 == 1:
        r = np.arange(kernel_size) - kernel_size // 2
    else:
        r = np.arange(kernel_size)
    g = np.stack(np.meshgrid(r, r, r, indexing='ij'), -1).reshape(-1, 3)
    return g.astype(np.int32)


def build_neighbor_map(in_level: SparseLevel, out_level: SparseLevel,
                       kernel_size: int, stride: int) -> torch.Tensor:
    """(B, V_out, K³) int32: for each output voxel and kernel offset (z
    fastest), the index of the input voxel, or -1.

    One lookup per (dx, dy) column at the center z answers all the kz
    offsets of the column: they are consecutive integers in key space.
    """
    B, V_out = out_level.keys.shape
    dev = out_level.keys.device
    offs = kernel_offsets(kernel_size)
    ks = kernel_size
    k2 = ks * ks
    offs_xy = torch.as_tensor(offs.reshape(k2, ks, 3)[:, 0, :2], device=dev)
    zoffs = offs.reshape(k2, ks, 3)[0, :, 2]

    base = out_level.coords * stride
    ex, ey, ez = in_level.extent
    cxy = base[:, :, None, :2] + offs_xy[None, None]        # (B, V_out, K2, 2)
    zc = base[:, :, None, 2]                                # (B, V_out, 1)
    xy_ok = ((cxy >= 0) & (cxy < torch.tensor((ex, ey), device=dev))).all(-1)
    qc = ((cxy[..., 0] * ey + cxy[..., 1]) * ez + zc).to(torch.int32)
    qc = torch.where(xy_ok & out_level.mask[:, :, None], qc,
                     torch.full_like(qc, SENTINEL))

    # column-major query order: each run of queries is one (dx, dy)
    # column over consecutive sorted output voxels
    qc_t = qc.transpose(1, 2).contiguous()                  # (B, K2, V_out)
    im, ic, ip = lookup_pmz(in_level.keys, qc_t.reshape(B, -1))
    by_dz = {d: a.reshape(B, k2, V_out).transpose(1, 2)
             for d, a in ((-1, im), (0, ic), (1, ip))}

    parts = []
    for j in range(ks):
        dz = int(zoffs[j])
        z_j = zc + dz
        valid = (z_j >= 0) & (z_j < ez)
        parts.append(torch.where(valid, by_dz[dz], -1))
    nbr = torch.stack(parts, dim=-1).reshape(B, V_out, k2 * ks)
    return torch.where(out_level.mask[:, :, None], nbr, -1).to(torch.int32)


# --------------------------------------------------------------------------
# sorted-key lookups (kernel 2)
# --------------------------------------------------------------------------
def lookup_pmz_plain(keys: torch.Tensor, queries: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `csrc/lookup_pmz.cu` (reference
    `_batched_lookup_pmz`): indices of q-1, q, q+1 in the per-sample
    sorted keys, -1 on a miss or for a SENTINEL query."""
    V = keys.shape[1]
    k64 = keys.long().contiguous()
    q64 = queries.long()
    lo = torch.searchsorted(k64, (q64 - 1).contiguous(), side='left')
    live = queries != SENTINEL
    # keys are unique among valid entries, so q-1, q and q+1 can only sit
    # in the three slots from the lower bound of q-1 on
    res = [torch.full_like(lo, -1) for _ in range(3)]
    for j in range(3):
        pos = lo + j
        val = torch.gather(k64, 1, torch.clamp(pos, max=V - 1))
        d = val - q64
        for t, dz in enumerate((-1, 0, 1)):
            res[t] = torch.where(live & (pos < V) & (d == dz), pos, res[t])
    return tuple(r.to(torch.int32) for r in res)


def lookup_center_plain(keys: torch.Tensor, queries: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch version of the center-only entry (reference
    `_batched_lookup`)."""
    V = keys.shape[1]
    k64 = keys.long().contiguous()
    q64 = queries.long().contiguous()
    lo = torch.searchsorted(k64, q64, side='left')
    val = torch.gather(k64, 1, torch.clamp(lo, max=V - 1))
    hit = (queries != SENTINEL) & (lo < V) & (val == q64)
    return torch.where(hit, lo, torch.full_like(lo, -1)).to(torch.int32)


# csrc/lookup_pmz.cu (both forms): queries a block, the most keys of a
# tile's window it holds in shared memory, and the most fences
LOOKUP_TILE = 1024
LOOKUP_MAX_WINDOW = 6144
LOOKUP_MAX_FENCES = 256


class LookupLaunch(NamedTuple):
    """How `ptt_lookup_pmz` and `ptt_lookup_center` cut a call: `tiles` a
    sample of `LOOKUP_TILE` queries; windows of up to `capacity` keys in
    shared memory (a multiple of 4 that holds a whole sample's keys where
    they are fewer than `LOOKUP_MAX_WINDOW`); `fence_step` F, 0 where the
    whole row fits, else the power of two that keeps ceil(V / F) fences
    within `LOOKUP_MAX_FENCES`; `smem` the dynamic shared-memory bytes
    (the capacity, 4 keys of 16-byte lead, and the fences)."""
    tiles: int
    capacity: int
    fence_step: int
    smem: int


def lookup_launch_shape(B: int, V: int, Q: int) -> LookupLaunch:
    """The `LookupLaunch` of a call's shapes."""
    capacity = min(LOOKUP_MAX_WINDOW, max(4, -(-V // 4) * 4))
    fence_step = 0
    if V > capacity:
        fence_step = 1 << max(0, (-(-V // LOOKUP_MAX_FENCES) - 1).bit_length())
    smem = 4 * (capacity + 4 + (LOOKUP_MAX_FENCES if fence_step else 0))
    return LookupLaunch(-(-Q // LOOKUP_TILE), capacity, fence_step, smem)


def lookup_tile_windows(keys: torch.Tensor, queries: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, n), each (B, tiles) int64: the row keys [lo, lo + n) that
    each tile of `ptt_lookup_pmz` or `ptt_lookup_center` searches, in
    plain PyTorch (`n` is the kernels' `window_len`). The whole row where it fits the capacity,
    else the stretch between the fences around lower_bound(qmin - 1) and
    lower_bound(qmax + 2) over the tile's non-SENTINEL queries; (0, 0)
    for a tile without one."""
    B, V = keys.shape
    Q = queries.shape[1]
    tiles, capacity, step, _ = lookup_launch_shape(B, V, Q)
    q = torch.nn.functional.pad(queries.long(), (0, tiles * LOOKUP_TILE - Q),
                                value=SENTINEL).view(B, tiles, LOOKUP_TILE)
    live = q != SENTINEL
    zero = torch.zeros((B, tiles), dtype=torch.int64, device=keys.device)
    if not step:
        return zero, torch.where(live.any(-1), V, zero)
    qmin = torch.where(live, q, SENTINEL).amin(-1)
    qmax = torch.where(live, q, -SENTINEL - 1).amax(-1)
    fences = keys[:, ::step].long().contiguous()
    nf = fences.shape[1]
    c = torch.searchsorted(fences, (qmin - 1).contiguous())
    d = torch.searchsorted(fences, (qmax + 2).contiguous())
    lo = torch.where(c > 0, (c - 1) * step + 1, 0)
    n = torch.where(d < nf, d * step, V) - lo
    has = live.any(-1)
    return torch.where(has, lo, zero), torch.where(has, n, zero)


def _lookup_launch(keys: torch.Tensor, queries: torch.Tensor,
                   window_len: Optional[torch.Tensor]) -> LookupLaunch:
    """Check a lookup kernel's arguments; its `LookupLaunch`."""
    B, V = keys.shape
    Q = queries.shape[1]
    _cuda.check_cuda('keys', keys, torch.int32, (B, V))
    _cuda.check_cuda('queries', queries, torch.int32, (B, Q))
    if keys.data_ptr() % 16:
        raise ValueError('keys: expected a 16-byte aligned tensor')
    launch = lookup_launch_shape(B, V, Q)
    if window_len is not None:
        _cuda.check_cuda('window_len', window_len, torch.int32,
                         (B, launch.tiles))
    return launch


def lookup_pmz_cuda(keys: torch.Tensor, queries: torch.Tensor,
                    window_len: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch `ptt_lookup_pmz`; returns three (B, Q) int32 tensors. Into
    `window_len` ((B, tiles) int32), when given, the kernel writes each
    tile's key-window length (`lookup_tile_windows`'s n)."""
    _, capacity, fence_step, _ = _lookup_launch(keys, queries, window_len)
    (B, V), Q = keys.shape, queries.shape[1]
    outs = [torch.empty((B, Q), dtype=torch.int32, device=keys.device)
            for _ in range(3)]
    LOOKUP_PMZ(keys.data_ptr(), queries.data_ptr(), B, V, Q, capacity,
               fence_step, *(o.data_ptr() for o in outs),
               None if window_len is None else window_len.data_ptr(),
               _cuda.current_stream(keys))
    return tuple(outs)


def lookup_center_cuda(keys: torch.Tensor, queries: torch.Tensor,
                       window_len: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Launch `ptt_lookup_center`, the same tiles and windows as
    `ptt_lookup_pmz`; returns (B, Q) int32. `window_len` as there."""
    _, capacity, fence_step, _ = _lookup_launch(keys, queries, window_len)
    (B, V), Q = keys.shape, queries.shape[1]
    out = torch.empty((B, Q), dtype=torch.int32, device=keys.device)
    LOOKUP_CENTER(keys.data_ptr(), queries.data_ptr(), B, V, Q, capacity,
                  fence_step, out.data_ptr(),
                  None if window_len is None else window_len.data_ptr(),
                  _cuda.current_stream(keys))
    return out


def _aligned_keys(keys: torch.Tensor) -> torch.Tensor:
    """`keys` contiguous at a 16-byte aligned address (the kernels load
    keys 16 bytes at a time)."""
    keys = keys.contiguous()
    return keys.clone() if keys.data_ptr() % 16 else keys


def lookup_pmz(keys: torch.Tensor, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q-1, q, q+1) index lookup: kernel on CUDA, plain on CPU."""
    if keys.is_cuda:
        return lookup_pmz_cuda(_aligned_keys(keys),
                               queries.to(torch.int32).contiguous())
    return lookup_pmz_plain(keys, queries)


def lookup_center(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match index lookup: kernel on CUDA, plain on CPU."""
    if keys.is_cuda:
        return lookup_center_cuda(_aligned_keys(keys),
                                  queries.to(torch.int32).contiguous())
    return lookup_center_plain(keys, queries)


# --------------------------------------------------------------------------
# sparse convolution (kernel 3) and the other compute primitives
# --------------------------------------------------------------------------
def sparse_conv_apply(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor,
                      out_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sparse conv (reference `sparse_conv_apply`): gather
    the input row of each offset and accumulate its matmul.

    feats (B, V_in, C_in), nbr (B, V_out, K3) with -1 = miss, weights
    (K3, C_in, C_out), out_mask (B, V_out) → (B, V_out, C_out).
    """
    B, V_out, K3 = nbr.shape
    C_in = feats.shape[-1]
    out = torch.zeros((B, V_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    for k in range(K3):
        idx = nbr[..., k]
        hit = idx >= 0
        safe = torch.where(hit, idx, 0).long()
        g = torch.gather(feats, 1, safe[..., None].expand(B, V_out, C_in))
        g = torch.where(hit[..., None], g, torch.zeros_like(g))
        out = out + torch.matmul(g.float(), weights[k].float())
    out = torch.where(out_mask[..., None], out, torch.zeros_like(out))
    return out.to(feats.dtype)


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def sparse_conv_apply_bf16(feats: torch.Tensor, nbr: torch.Tensor,
                           weights: torch.Tensor,
                           out_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the bf16 conv kernel (the TPU kernel's
    casts, reference ops/sparse_conv_pallas.py:782-783): the float32
    plain conv of bf16-rounded features and weights, output in the
    features' dtype."""
    out = sparse_conv_apply(_bf16_values(feats), nbr, _bf16_values(weights),
                            out_mask)
    return out.to(feats.dtype)


class ConvPlan(NamedTuple):
    """What the sparse-conv kernels read of a neighbor map beyond the map
    itself, built once per map (`conv_plan`) and shared by every conv,
    input gradient and weight gradient over it.

    row_mask (B, V) int32: bit k set where nbr[b, v, k] >= 0.
    order (B, V) int32: each sample's rows stably sorted by row_mask, so
      rows with the same hit pattern share a kernel tile.
    hits (K3, B * V) int32: for each offset k, the flattened rows
      b * V + v that hit it, in row order, then -1.
    hit_counts (K3,) int32: the number of rows in each list.
    """
    row_mask: torch.Tensor
    order: torch.Tensor
    hits: torch.Tensor
    hit_counts: torch.Tensor


MAX_PLAN_K3 = 32


def conv_plan(nbr: torch.Tensor) -> ConvPlan:
    """The plan of a (B, V, K3) map: about 25 launches, no host sync (the
    hit lists are built by one scan and a scatter into a fixed capacity,
    and their counts stay on the device)."""
    B, V, K3 = nbr.shape
    if K3 > MAX_PLAN_K3:
        raise ValueError(f'conv_plan: K3 = {K3} > {MAX_PLAN_K3}')
    dev = nbr.device
    R = B * V
    hit = torch.empty((K3, R), dtype=torch.bool, device=dev)  # offset-major
    torch.ge(nbr.reshape(R, K3).t(), 0, out=hit)
    bits = torch.bitwise_left_shift(
        1, torch.arange(K3, dtype=torch.int32, device=dev))
    row_mask = (hit * bits[:, None]).sum(0, dtype=torch.int32).view(B, V)
    order = torch.argsort(row_mask, dim=1, stable=True).to(torch.int32)
    # one scan over all offsets' hits in turn (a device-wide scan; a scan
    # per offset row runs a few blocks): a hit's slot in the flat (K3, R)
    # buffer is k * R + its rank in offset k's list, i.e. its running
    # count minus one minus the hits of offsets before k; misses all go
    # to one spare slot past the end
    counts = hit.sum(1, dtype=torch.int32)
    before = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    shift = torch.arange(-1, K3 * R - 1, R, dtype=torch.int32,
                         device=dev) - before
    pos = hit.view(-1).cumsum(0, dtype=torch.int32).view(K3, R)
    dst = torch.where(hit, pos + shift[:, None], K3 * R)
    hits = torch.full((K3 * R + 1, ), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    hits.index_put_((dst, ), rows.expand(K3, R))
    return ConvPlan(row_mask, order, hits[:K3 * R].view(K3, R), counts)


def _tile_launch(B: int, V_out: int, C_out: int, n_sm: int
                 ) -> Tuple[int, int]:
    """(output channels a block, splits) of a 128-row tile path."""
    cols = 64 if C_out <= 64 else 128
    blocks = B * -(-V_out // 128) * -(-C_out // cols)
    target = 10 * n_sm
    splits = 1 if blocks >= target else min(16, -(-target // blocks))
    return cols, splits


def conv_launch_shape(B: int, V_out: int, K3: int, C_in: int, C_out: int,
                      n_sm: int) -> Tuple[str, int, int]:
    """(path, output channels a block, splits) of `csrc/sparse_conv.cu`
    for a call's shapes: the narrow paths for C_in <= 4 or C_out <= 4;
    else 128-row tiles 128 channels wide (64 where C_out <= 64), their
    offsets split across blocks (at most 16 ways) where the tiles give
    fewer than ~5 waves of two resident blocks an SM (a level's padded
    rows make tiles with no work, and its mask-sorted tiles differ in
    their active offsets, so few waves leave SMs idle)."""
    if C_in <= 4:
        return 'narrow_in', 0, 1
    if C_out <= 4 and K3 * C_in * 16 <= 48 * 1024:
        return 'narrow_out', 0, 1
    return ('tile', *_tile_launch(B, V_out, C_out, n_sm))


_PATHS = {'tile': 0, 'narrow_in': 1, 'narrow_out': 2}
CONV_TILE_ROWS = 128  # rows of a tile-path block (csrc/sparse_conv.cu)
CONV_STEP_C = 16      # input channels of one of its pipeline steps


def _launch_conv(kernel: _cuda.CudaKernel, role: int, feats: torch.Tensor,
                 nbr: torch.Tensor, weights: torch.Tensor,
                 out_mask: torch.Tensor,
                 plan: Optional[ConvPlan]) -> torch.Tensor:
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = weights.shape[-1]
    _cuda.check_cuda('feats', feats, torch.float32, (B, V_in, C_in))
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    _cuda.check_cuda('weights', weights, torch.float32, (K3, C_in, C_out))
    _cuda.check_cuda('out_mask', out_mask, torch.bool, (B, V_out))
    if plan is None:
        plan = conv_plan(nbr)
    _cuda.check_cuda('row_mask', plan.row_mask, torch.int32, (B, V_out))
    _cuda.check_cuda('order', plan.order, torch.int32, (B, V_out))
    path, cols, splits = conv_launch_shape(B, V_out, K3, C_in, C_out,
                                           _cuda.sm_count(feats.device))
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=feats.device)
    ws = (torch.empty((splits, B, V_out, C_out), dtype=torch.float32,
                      device=feats.device) if splits > 1 else out)
    kernel(feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
           out_mask.data_ptr(), plan.row_mask.data_ptr(),
           plan.order.data_ptr(), B, V_in, V_out, K3, C_in, C_out, role,
           _PATHS[path], cols, splits, ws.data_ptr(), out.data_ptr(),
           _cuda.current_stream(feats))
    return out


def sparse_conv_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                     weights: torch.Tensor, out_mask: torch.Tensor,
                     plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Launch `csrc/sparse_conv.cu` (float32 gather-GEMM) over the map's
    plan, built here when none is given."""
    return _launch_conv(SPARSE_CONV, 0, feats, nbr, weights, out_mask, plan)


def sparse_conv_dfeats_cuda(g: torch.Tensor, nbr: torch.Tensor,
                            weights: torch.Tensor, out_mask: torch.Tensor,
                            plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """The same source for the input gradient, as its own kernel symbols:
    a conv of the output gradient over the mirrored or reversed map (see
    `_SparseConvFn`)."""
    return _launch_conv(SPARSE_CONV_DFEATS, 1, g, nbr, weights, out_mask,
                        plan)


BF16_STEP_C = 16  # the widths the bf16 kernels take are multiples of this
BF16_TILE_ROWS = 128         # rows of a forward / dfeats block: two warpgroups
BF16_RING_BYTES = 192 * 1024  # its ring of stages in shared memory
BF16_MAX_STAGES = 8
SMEM_PER_BLOCK = 232_448     # an H100 block's most dynamic shared memory
# a block's shared memory beside its ring: the W slices' mbarriers (8),
# csrc/common.cuh::TileRows<128, 64> (map entries of up to 32 offsets,
# rows, keep flags, active offsets, two warpgroup ORs and the tile's OR),
# and 1 KB for aligning the ring to 1024 bytes
BF16_BLOCK_FIXED_BYTES = 8 * 8 + 4 * (32 * 128 + 128 + 128 + 32 + 2 + 1) + 1024


def _round_step(c: int) -> int:
    return -(-c // BF16_STEP_C) * BF16_STEP_C


class Bf16Launch(NamedTuple):
    """How `ptt_sparse_conv_bf16` cuts a forward or input-gradient call
    (`csrc/sparse_conv_bf16.cu`): `kc` input channels a stage (64, else
    32 or 16), `bn` output channels a block (the wgmma N: 64, 128 or 256;
    64 where kc < 64), `stages` the ring's depth, `smem` the block's
    dynamic shared memory in bytes, `col_blocks` blocks across C_out,
    `splits` of each tile's steps (added by a second kernel where > 1)."""
    kc: int
    bn: int
    stages: int
    smem: int
    col_blocks: int
    splits: int


def bf16_stage_shape(kc: int, bn: int) -> Tuple[int, int]:
    """(stages, smem bytes) of a (kc, bn) block, as `Ring` computes them:
    as many stages of gathered rows (128 x kc) and W slice (kc x bn), in
    bf16, as fit `BF16_RING_BYTES`, at most `BF16_MAX_STAGES`, and
    `BF16_BLOCK_FIXED_BYTES`."""
    stage = 2 * kc * (BF16_TILE_ROWS + bn)
    stages = min(BF16_MAX_STAGES, BF16_RING_BYTES // stage)
    return stages, stages * stage + BF16_BLOCK_FIXED_BYTES


def bf16_tile_launch(B: int, V_out: int, C_in: int, C_out: int,
                     n_sm: int) -> Bf16Launch:
    """The `Bf16Launch` of a call's shapes (C_in and C_out multiples of
    16). A block's gathered rows feed up to 256 output channels; tiles
    that fill less than a wave of one block an SM split their steps into
    about two waves, at most 8 ways (the partials' traffic grows with the
    splits): floor(2 * n_sm / blocks). `tools/conv_bf16_sweep.py` timed
    1-16 splits on the flagship's calls: the best within a few per cent."""
    kc = 64 if C_in % 64 == 0 else 32 if C_in % 32 == 0 else 16
    bn = 64 if kc < 64 or C_out <= 64 else 128 if C_out <= 128 else 256
    col_blocks = -(-C_out // bn)
    blocks = B * -(-V_out // BF16_TILE_ROWS) * col_blocks
    splits = 1 if blocks >= n_sm else min(8, 2 * n_sm // blocks)
    return Bf16Launch(kc, bn, *bf16_stage_shape(kc, bn), col_blocks, splits)


def bf16_swizzle(offset, row_bytes: int):
    """Byte offset of byte `offset` (an int or an integer array) of a tile
    of `row_bytes`-byte rows (128, 64 or 32) in wgmma's swizzled layout,
    the mirror of `csrc/sparse_conv_bf16.cu::swizzle`: the 16-byte chunk
    index, bits [4, 4 + b), XOR bits [7, 7 + b), b = log2(row_bytes / 16)."""
    mask = row_bytes // 16 - 1
    return offset ^ (((offset >> 7) & mask) << 4)


def _bf16_padded(x: torch.Tensor, c: int) -> torch.Tensor:
    """x cast to bfloat16 (once, before a launch), its last axis
    zero-padded to c, contiguous."""
    x = x.to(torch.bfloat16)
    if x.shape[-1] != c:
        x = F.pad(x, (0, c - x.shape[-1]))
    return x.contiguous()


def _launch_conv_bf16(kernel: _cuda.CudaKernel, role: int,
                      feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, out_mask: torch.Tensor,
                      plan: Optional[ConvPlan],
                      out_dtype: Optional[torch.dtype],
                      launch: Optional[Bf16Launch] = None) -> torch.Tensor:
    """The bf16 kernel's launch; `launch` (default `bf16_tile_launch`'s)
    chooses the cut, for `tools/conv_bf16_sweep.py`."""
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = weights.shape[-1]
    for name, t in (('feats', feats), ('weights', weights)):
        if not t.is_cuda or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'{name}: expected a float32 or bfloat16 CUDA '
                             f'tensor, got {t.dtype} on {t.device}')
    out_dtype = feats.dtype if out_dtype is None else out_dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'out_dtype: expected float32 or bfloat16, '
                         f'got {out_dtype}')
    if tuple(weights.shape) != (K3, C_in, C_out):
        raise ValueError(f'weights: expected shape {(K3, C_in, C_out)}, '
                         f'got {tuple(weights.shape)}')
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    _cuda.check_cuda('out_mask', out_mask, torch.bool, (B, V_out))
    if plan is None:
        plan = conv_plan(nbr)
    _cuda.check_cuda('row_mask', plan.row_mask, torch.int32, (B, V_out))
    _cuda.check_cuda('order', plan.order, torch.int32, (B, V_out))
    Ci, Co = _round_step(C_in), _round_step(C_out)
    f = _bf16_padded(feats, Ci)
    w = _bf16_padded(weights, Co)
    if Ci != C_in:
        w = F.pad(w, (0, 0, 0, Ci - C_in)).contiguous()
    if launch is None:
        launch = bf16_tile_launch(B, V_out, Ci, Co,
                                  _cuda.sm_count(feats.device))
    splits = launch.splits
    out = torch.empty((B, V_out, Co), dtype=out_dtype, device=feats.device)
    ws = (torch.empty((splits, B, V_out, Co), dtype=torch.float32,
                      device=feats.device) if splits > 1 else out)
    kernel(f.data_ptr(), nbr.data_ptr(), w.data_ptr(), out_mask.data_ptr(),
           plan.row_mask.data_ptr(), plan.order.data_ptr(), B, V_in, V_out,
           K3, Ci, Co, role, int(out_dtype == torch.float32), launch.kc,
           launch.bn, splits, ws.data_ptr(), out.data_ptr(),
           _cuda.current_stream(feats))
    return out if Co == C_out else out[..., :C_out].contiguous()


def sparse_conv_bf16_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                          weights: torch.Tensor, out_mask: torch.Tensor,
                          plan: Optional[ConvPlan] = None,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Launch the bf16 form of the conv (`csrc/sparse_conv_bf16.cu`,
    `wgmma` bf16 on warpgroups, float32 sums) over the map's plan, built
    here when none is given, cut by `bf16_tile_launch`. float32 features
    or weights are rounded to bfloat16 here, once. Widths that are not a
    multiple of 16 are zero-padded here (the kernel takes multiples of
    16), and the output sliced back. The output is `out_dtype` (default:
    the features')."""
    return _launch_conv_bf16(SPARSE_CONV_BF16, 0, feats, nbr, weights,
                             out_mask, plan, out_dtype)


def sparse_conv_dfeats_bf16_cuda(g: torch.Tensor, nbr: torch.Tensor,
                                 weights: torch.Tensor,
                                 out_mask: torch.Tensor,
                                 plan: Optional[ConvPlan] = None,
                                 out_dtype: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """The bf16 conv for the input gradient, under its own kernel
    symbols (as `sparse_conv_dfeats_cuda`)."""
    return _launch_conv_bf16(SPARSE_CONV_DFEATS_BF16, 1, g, nbr, weights,
                             out_mask, plan, out_dtype)


def sparse_conv_dw_plain(feats: torch.Tensor, nbr: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch weight gradient of `sparse_conv_apply`, the
    version of `csrc/sparse_conv_dw.cu` that the CPU runs: per offset,
    the gathered input rows (zero on a miss) transposed times the output
    gradient `g` (B, V_out, C_out), which is already zero at masked
    outputs. Returns (K3, C_in, C_out) float32."""
    B, V_out, K3 = nbr.shape
    C_in = feats.shape[-1]
    a = feats.float().reshape(B * feats.shape[1], C_in)
    gf = g.float().reshape(B * V_out, -1)
    base = (torch.arange(B, device=nbr.device) * feats.shape[1])[:, None]
    dw = []
    for k in range(K3):
        idx = nbr[..., k]
        hit = (idx >= 0).reshape(-1, 1)
        rows = torch.where(idx >= 0, idx + base, 0).reshape(-1).long()
        gathered = a[rows]
        gathered = torch.where(hit, gathered, torch.zeros_like(gathered))
        dw.append(gathered.transpose(0, 1) @ gf)
    return torch.stack(dw)


# hits a dW split takes at least and at most (csrc/sparse_conv_dw.cu)
DW_MIN_CHUNK, DW_MAX_CHUNK = 256, 4096


def dw_split_table(counts, pairs_target: int) -> Tuple[int, list]:
    """(chunk, splits of each offset) as `csrc/sparse_conv_dw.cu::
    split_table` derives them on the device from the hit counts (a list
    here): equal chunks of all offsets' hits, about `pairs_target` of
    them."""
    H = sum(counts)
    chunk = min(max(-(-H // pairs_target), DW_MIN_CHUNK), DW_MAX_CHUNK)
    return chunk, [-(-c // chunk) for c in counts]


def dw_launch_shape(rows: int, K3: int, C_in: int, C_out: int,
                    n_sm: int) -> Tuple[int, int, int, int]:
    """(tm, tn, pairs_target, grid_pairs) of `csrc/sparse_conv_dw.cu`:
    tm 0 is the narrow path (C_in <= 4, 64 output channels a block), else
    a block covers 16 * tm input and 16 * tn output channels (128 or
    64); the hits are cut into about `pairs_target` splits, enough for ~8
    blocks an SM (4 waves of two) over the channel tiles; `grid_pairs` is
    the most splits the kernel's table can give for `rows` map rows."""
    tm = 0 if C_in <= 4 else 8 if C_in > 64 else 4
    tn = 8 if C_out > 64 and tm else 4
    c_tiles = 1 if tm == 0 else -(-C_in // (16 * tm))
    tiles = c_tiles * -(-C_out // (16 * tn))
    pairs_target = max(1, -(-8 * n_sm // tiles))
    grid_pairs = max(pairs_target, -(-K3 * rows // DW_MAX_CHUNK)) + K3
    return tm, tn, pairs_target, grid_pairs


# csrc/sparse_conv_bf16.cu's dW body: hits a stage, its ring of stages,
# the steps its hit-index ring holds, and the hits a split takes at least
BF16_DW_HITS = 64
BF16_DW_RING_BYTES = 192 * 1024
BF16_DW_MAX_STAGES = 12
BF16_DW_IDX_SLOTS = 32
BF16_DW_MIN_HITS = 256
# a dW block's shared memory beside its ring: the index ring (hit rows
# and input rows of BF16_DW_IDX_SLOTS steps), the split table (chunk,
# total, wtotal; S, base, wbase, counts of up to 32 offsets) and 1 KB for
# aligning the ring to 1024 bytes
BF16_DW_FIXED_BYTES = (4 * 2 * BF16_DW_IDX_SLOTS * BF16_DW_HITS
                       + 4 * (3 + 4 * 32) + 1024)


class Bf16DwLaunch(NamedTuple):
    """How `ptt_sparse_conv_dw_bf16` cuts a call: `bm` input and `bn`
    output channels a block (64 or 128; the wgmma N, 64, 128 or 256),
    `stages` of its ring and `smem` its dynamic shared memory, `tiles`
    channel tiles, a grid of `max_splits` splits of each tile (at least
    K3; more only where one wave of one block an SM has room for them),
    and `sum_blocks` blocks of the split sum (0: no offset can split)."""
    bm: int
    bn: int
    stages: int
    smem: int
    tiles: int
    max_splits: int
    sum_blocks: int


def bf16_dw_stage_shape(bm: int, bn: int) -> Tuple[int, int]:
    """(stages, smem bytes) of a (bm, bn) dW block, as `DwRing` computes
    them: as many 64-hit stages of x rows (64 x bm) and g rows (64 x bn),
    in bf16, as fit `BF16_DW_RING_BYTES`, at most `BF16_DW_MAX_STAGES`,
    and `BF16_DW_FIXED_BYTES`."""
    stage = 2 * BF16_DW_HITS * (bm + bn)
    stages = min(BF16_DW_MAX_STAGES, BF16_DW_RING_BYTES // stage)
    return stages, stages * stage + BF16_DW_FIXED_BYTES


def bf16_dw_launch(K3: int, C_in: int, C_out: int,
                   n_sm: int) -> Bf16DwLaunch:
    """The `Bf16DwLaunch` of a call's shapes (C_in and C_out multiples of
    16): blocks of 128 input channels (64 where C_in <= 64) by min(C_out,
    256) output channels, so a gathered row feeds up to 256 of them; the
    K3 x tiles blocks that exist without a split, and splits of the
    offsets' hits only as far as one wave of one block an SM holds:
    max(K3, n_sm // tiles) a tile (`bf16_dw_split_table`). The sum pass
    adds at most max_splits // 2 offsets of float4s."""
    bm = 64 if C_in <= 64 else 128
    bn = 64 if C_out <= 64 else 128 if C_out <= 128 else 256
    tiles = -(-C_in // bm) * -(-C_out // bn)
    max_splits = max(K3, n_sm // tiles)
    sum_blocks = 0
    if max_splits > K3:
        n4 = min(K3, max_splits // 2) * C_in * C_out // 4
        sum_blocks = max(1, min(2 * n_sm, -(-n4 // 256)))
    return Bf16DwLaunch(bm, bn, *bf16_dw_stage_shape(bm, bn), tiles,
                        max_splits, sum_blocks)


def bf16_dw_split_table(counts, max_splits: int) -> Tuple[int, list]:
    """(chunk, splits of each offset) as `csrc/sparse_conv_bf16.cu::
    dw_plan` derives them on the device from the hit counts (a list
    here): the least chunk whose splits, ceil(count / chunk) and at
    least one an offset, number at most `max_splits` (with max_splits <=
    K3: the largest count, no split), then at least `BF16_DW_MIN_HITS`.
    Offsets with one split write dW directly; the others' partials are
    the workspace."""
    chunk = max(max(counts, default=0), 1)
    if len(counts) < max_splits:
        lo, hi = 1, chunk
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if sum(max(1, -(-c // mid)) for c in counts) <= max_splits:
                hi = mid
            else:
                lo = mid + 1
        chunk = max(lo, BF16_DW_MIN_HITS)
    return chunk, [max(1, -(-c // chunk)) for c in counts]


def bf16_dw_copy_offset(hit, channel):
    """Byte offset of the 16-byte copy that holds `channel` (a multiple
    of 8) of hit row `hit` (0-63) in a dW stage's operand tile (ints or
    integer arrays), the mirror of the copy addresses in `csrc/
    sparse_conv_bf16.cu::dw_tile`: 64-channel atoms of 64 rows of 128
    bytes, 8192 bytes apart, each in the 128-byte swizzle."""
    return (channel // 64) * (BF16_DW_HITS * 128) + bf16_swizzle(
        hit * 128 + (channel % 64) * 2, 128)


def sparse_conv_dw_plain_bf16(feats: torch.Tensor, nbr: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the bf16 dW kernel (the TPU kernel's
    casts, reference ops/sparse_conv_pallas.py:422, :436): the float32
    plain dW of bf16-rounded features and gradient; float32 out."""
    return sparse_conv_dw_plain(_bf16_values(feats), nbr, _bf16_values(g))


def sparse_conv_dw_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                        g: torch.Tensor,
                        plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Launch `csrc/sparse_conv_dw.cu` over the map's per-offset hit
    lists (built here when no plan is given); returns (K3, C_in, C_out)
    f32."""
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = g.shape[-1]
    _cuda.check_cuda('feats', feats, torch.float32, (B, V_in, C_in))
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    _cuda.check_cuda('g', g, torch.float32, (B, V_out, C_out))
    if plan is None:
        plan = conv_plan(nbr)
    _cuda.check_cuda('hits', plan.hits, torch.int32, (K3, B * V_out))
    _cuda.check_cuda('hit_counts', plan.hit_counts, torch.int32, (K3, ))
    tm, tn, pairs_target, grid_pairs = dw_launch_shape(
        B * V_out, K3, C_in, C_out, _cuda.sm_count(feats.device))
    dw = torch.empty((K3, C_in, C_out), dtype=torch.float32,
                     device=feats.device)
    ws = torch.empty((grid_pairs, C_in, C_out), dtype=torch.float32,
                     device=feats.device)
    SPARSE_CONV_DW(feats.data_ptr(), nbr.data_ptr(), g.data_ptr(),
                   plan.hits.data_ptr(), plan.hit_counts.data_ptr(), B, V_in,
                   V_out, K3, C_in, C_out, tm, tn, pairs_target, grid_pairs,
                   ws.data_ptr(), dw.data_ptr(), _cuda.current_stream(feats))
    return dw


def sparse_conv_dw_bf16_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                             g: torch.Tensor,
                             plan: Optional[ConvPlan] = None
                             ) -> torch.Tensor:
    """Launch the bf16 dW kernel (`csrc/sparse_conv_bf16.cu`, `wgmma` with
    the hits as k) over the map's per-offset hit lists (built here when
    no plan is given), cut by `bf16_dw_launch`; returns (K3, C_in, C_out)
    float32. float32 features or gradients are rounded to bfloat16 here,
    once; widths that are not a multiple of 16 are zero-padded here and
    the result sliced back."""
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = g.shape[-1]
    for name, t in (('feats', feats), ('g', g)):
        if not t.is_cuda or t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'{name}: expected a float32 or bfloat16 CUDA '
                             f'tensor, got {t.dtype} on {t.device}')
    if tuple(g.shape[:2]) != (B, V_out):
        raise ValueError(f'g: expected shape {(B, V_out, C_out)}, '
                         f'got {tuple(g.shape)}')
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    if plan is None:
        plan = conv_plan(nbr)
    _cuda.check_cuda('hits', plan.hits, torch.int32, (K3, B * V_out))
    _cuda.check_cuda('hit_counts', plan.hit_counts, torch.int32, (K3, ))
    Ci, Co = _round_step(C_in), _round_step(C_out)
    f, gb = _bf16_padded(feats, Ci), _bf16_padded(g, Co)
    cut = bf16_dw_launch(K3, Ci, Co, _cuda.sm_count(feats.device))
    dw = torch.empty((K3, Ci, Co), dtype=torch.float32, device=feats.device)
    ws = (torch.empty((cut.max_splits, Ci, Co), dtype=torch.float32,
                      device=feats.device) if cut.sum_blocks else None)
    SPARSE_CONV_DW_BF16(f.data_ptr(), nbr.data_ptr(), gb.data_ptr(),
                        plan.hits.data_ptr(), plan.hit_counts.data_ptr(), B,
                        V_in, V_out, K3, Ci, Co, cut.bm, cut.bn,
                        cut.max_splits, cut.sum_blocks,
                        None if ws is None else ws.data_ptr(),
                        dw.data_ptr(), _cuda.current_stream(feats))
    if (Ci, Co) != (C_in, C_out):
        dw = dw[:, :C_in, :C_out].contiguous()
    return dw


def sparse_conv_dw(feats: torch.Tensor, nbr: torch.Tensor, g: torch.Tensor,
                   plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Weight gradient: kernel on CUDA, plain on CPU; bfloat16 features
    take the bf16 form."""
    bf16 = feats.dtype == torch.bfloat16
    if feats.is_cuda:
        if bf16:
            return sparse_conv_dw_bf16_cuda(feats, nbr.contiguous(), g, plan)
        return sparse_conv_dw_cuda(feats.float().contiguous(),
                                   nbr.contiguous(), g.contiguous(), plan)
    if bf16:
        return sparse_conv_dw_plain_bf16(feats, nbr, g)
    return sparse_conv_dw_plain(feats, nbr, g)


def sparse_conv_dfeats(g: torch.Tensor, nbr: torch.Tensor,
                       weights: torch.Tensor, out_mask: torch.Tensor,
                       plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """The backward's conv of `g`: kernel on CUDA, plain on CPU; a
    bfloat16 `g` takes the bf16 form."""
    bf16 = g.dtype == torch.bfloat16
    if g.is_cuda:
        launch = (sparse_conv_dfeats_bf16_cuda if bf16 else
                  sparse_conv_dfeats_cuda)
        return launch(g.contiguous(), nbr.contiguous(), weights.contiguous(),
                      out_mask.contiguous(), plan)
    if bf16:
        return sparse_conv_apply_bf16(g, nbr, weights, out_mask)
    return sparse_conv_apply(g, nbr, weights, out_mask)


def reverse_map(nbr: torch.Tensor, V_in: int) -> torch.Tensor:
    """rnbr (B, V_in, K3) with rnbr[b, nbr[b, v, k], k] = v, -1 where no
    output reads that input at that offset: one int32 scatter. A map of
    `build_neighbor_map` reads each input at most once per offset, so no
    two writes collide (reference ops/sparse.py:517-530)."""
    B, V_out, K3 = nbr.shape
    dev = nbr.device
    b = torch.arange(B, device=dev)[:, None, None]
    k = torch.arange(K3, device=dev)[None, None, :]
    v = torch.arange(V_out, dtype=torch.int32, device=dev)[None, :, None]
    spare = B * V_in * K3          # one slot past the end takes the misses
    dst = torch.where(nbr >= 0, (b * V_in + nbr) * K3 + k, spare)
    rnbr = torch.full((spare + 1, ), -1, dtype=torch.int32, device=dev)
    rnbr.scatter_(0, dst.reshape(-1), v.expand(B, V_out, K3).reshape(-1))
    return rnbr[:spare].reshape(B, V_in, K3)


class _SparseConvFn(torch.autograd.Function):
    """A K³>1 sparse conv whose backward follows the reference's
    `_sparse_conv_pallas_bwd` (ops/sparse.py:487): g masked by out_mask;
    dW from `sparse_conv_dw`; dfeats a forward conv of g over the same
    map (and the same plan) with mirrored-transposed weights for a self
    map (kernel_offsets is symmetric under index reversal), or over the
    reversed map (whose plan the kernel's wrapper builds) with transposed
    weights and an all-true mask for a strided one.

    bfloat16 features take the bf16 forms (reference
    `_sparse_conv_pallas_bwd` casts g, features and weights to bf16):
    the output and dfeats are bfloat16, dW float32."""

    @staticmethod
    def forward(ctx, feats, nbr, weights, out_mask, self_map, plan):
        ctx.save_for_backward(feats, nbr, weights, out_mask)
        ctx.self_map = self_map
        ctx.plan = plan
        bf16 = feats.dtype == torch.bfloat16
        if feats.is_cuda:
            launch = sparse_conv_bf16_cuda if bf16 else sparse_conv_cuda
            return launch(feats.contiguous(), nbr.contiguous(),
                          weights.contiguous(), out_mask.contiguous(), plan)
        if bf16:
            return sparse_conv_apply_bf16(feats, nbr, weights, out_mask)
        return sparse_conv_apply(feats, nbr, weights, out_mask)

    @staticmethod
    def backward(ctx, g):
        feats, nbr, weights, out_mask = ctx.saved_tensors
        plan = ctx.plan
        g = torch.where(out_mask[..., None], g,
                        torch.zeros_like(g)).to(feats.dtype)
        dfeats = dW = None
        if ctx.needs_input_grad[2]:
            dW = sparse_conv_dw(feats, nbr, g, plan).to(weights.dtype)
        if ctx.needs_input_grad[0]:
            if ctx.self_map:
                dfeats = sparse_conv_dfeats(
                    g, nbr, weights.transpose(1, 2).flip(0), out_mask, plan)
            else:
                B, V_in = feats.shape[:2]
                # the reversed map's plan: built by the kernel's wrapper
                dfeats = sparse_conv_dfeats(
                    g, reverse_map(nbr, V_in), weights.transpose(1, 2),
                    torch.ones((B, V_in), dtype=torch.bool,
                               device=feats.device))
            dfeats = dfeats.to(feats.dtype)
        return dfeats, None, dW, None, None, None


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
                out_mask: torch.Tensor, self_map: bool = False,
                plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Sparse conv: every K³>1 conv goes through `_SparseConvFn` (its
    kernels on a CUDA tensor, their plain versions on a CPU one); K³ = 1
    convs take the plain version and autograd on both (as the JAX
    package leaves K³ = 1 to XLA). `self_map` marks a stride-1 map of a
    level onto itself, which picks the backward's dfeats formula. `plan`
    is the map's `conv_plan`, built once where the map is built; the
    kernels build it themselves when none is given, the plain versions
    do not read it."""
    if nbr.shape[-1] > 1:
        return _SparseConvFn.apply(feats, nbr, weights, out_mask, self_map,
                                   plan)
    return sparse_conv_apply(feats, nbr, weights, out_mask)


def sparse_max_pool(feats: torch.Tensor, nbr: torch.Tensor,
                    out_mask: torch.Tensor) -> torch.Tensor:
    """Max pooling over the neighbor map (misses ignored)."""
    B, V_out, K3 = nbr.shape
    C = feats.shape[-1]
    hit = nbr >= 0
    safe = torch.where(hit, nbr, 0).long().reshape(B, -1)
    g = torch.gather(feats, 1, safe[..., None].expand(B, V_out * K3, C))
    g = g.reshape(B, V_out, K3, C)
    g = torch.where(hit[..., None], g, torch.full_like(g, float('-inf')))
    out = torch.amax(g, dim=2)
    zero = torch.zeros_like(out)
    out = torch.where(hit.any(-1)[..., None], out, zero)
    return torch.where(out_mask[..., None], out, zero)


def generative_transpose_map(fine: SparseLevel, coarse: SparseLevel
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-2 stride-2 transpose conv map evaluated at the fine level's
    coordinates: (parent_idx (B, V_f), offset_id in [0, 8))."""
    parent = fine.coords // 2
    off = fine.coords - parent * 2
    off_id = (off[..., 0] * 2 + off[..., 1]) * 2 + off[..., 2]
    pkeys = torch.where(fine.mask, linearize(parent, coarse.extent),
                        torch.full_like(fine.keys, SENTINEL))
    return lookup_center(coarse.keys, pkeys), off_id.to(torch.int32)


def generative_transpose_apply(coarse_feats: torch.Tensor,
                               parent_idx: torch.Tensor,
                               offset_id: torch.Tensor,
                               weights: torch.Tensor,
                               out_mask: torch.Tensor) -> torch.Tensor:
    """out[v] = coarse[parent(v)] @ W[offset(v)], weights (8, C_in, C_out);
    summed in float32 (bfloat16 features promoted), output in the
    features' dtype."""
    B, V = parent_idx.shape
    C_in = coarse_feats.shape[-1]
    hit = parent_idx >= 0
    safe = torch.where(hit, parent_idx, 0).long()
    g = torch.gather(coarse_feats, 1, safe[..., None].expand(B, V, C_in))
    g = torch.where(hit[..., None], g, torch.zeros_like(g))
    onehot = torch.nn.functional.one_hot(offset_id.long(), 8).to(g.dtype)
    # one contraction over (offset, channel), zero outside the voxel's
    # offset — the einsum 'bvc,bvk,kcd->bvd' of the reference
    x = (onehot[..., :, None] * g[..., None, :]).reshape(B, V, 8 * C_in)
    out = torch.matmul(x.float(), weights.reshape(8 * C_in, -1).float())
    out = torch.where(out_mask[..., None], out, torch.zeros_like(out))
    return out.to(coarse_feats.dtype)


def _stable_rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each row entry by descending score, ties by position."""
    order = torch.argsort(-scores, dim=1, stable=True)
    ar = torch.arange(scores.shape[1], device=scores.device)
    return torch.empty_like(order).scatter_(
        1, order, ar[None].expand_as(order))


def compact_topk(level: SparseLevel, scores: torch.Tensor, capacity: int,
                 extras: Tuple[torch.Tensor, ...] = ()):
    """Physically prune to the `capacity` best-scoring valid voxels, kept
    in ascending key order. Returns (new_level, new_extras, src) with src
    the (B, capacity) int32 source row of each slot (-1 at padding)."""
    B, V = level.keys.shape
    dev = level.keys.device
    s = torch.where(level.mask, scores,
                    torch.full_like(scores, float('-inf')))
    rank = _stable_rank_desc(s)
    keep = level.mask & (rank < capacity)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    ar = torch.arange(V, device=dev)[None].expand(B, V)
    src = torch.full((B, capacity + 1), -1, dtype=torch.int64,
                     device=dev).scatter_(1, slot, torch.where(keep, ar, -1))
    src = src[:, :capacity]
    valid = src >= 0
    safe = torch.where(valid, src, 0)

    def take(a, fill=0):
        idx = safe.reshape(B, capacity, *([1] * (a.ndim - 2)))
        idx = idx.expand(B, capacity, *a.shape[2:])
        g = torch.gather(a, 1, idx)
        v = valid.reshape(B, capacity, *([1] * (a.ndim - 2)))
        return torch.where(v, g, torch.full_like(g, fill))

    new_level = SparseLevel(
        keys=take(level.keys, SENTINEL), coords=take(level.coords),
        feats=take(level.feats), mask=valid & take(level.mask, False),
        origin=level.origin, extent=level.extent, stride=level.stride,
        voxel_size=level.voxel_size)
    return new_level, tuple(take(e) for e in extras), src.to(torch.int32)


def prune_topk(level: SparseLevel, scores: torch.Tensor,
               k: int) -> SparseLevel:
    """Keep the top-k voxels per sample by score in place: only the mask
    shrinks."""
    s = torch.where(level.mask, scores,
                    torch.full_like(scores, float('-inf')))
    keep = level.mask & (_stable_rank_desc(s) < k)
    feats = torch.where(keep[..., None], level.feats,
                        torch.zeros_like(level.feats))
    return level._replace(mask=keep, feats=feats)


def topk_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, in descending order,
    lowest index first on ties — `jax.lax.top_k`'s order (torch.topk
    does not promise it)."""
    return torch.sort(scores, dim=1, descending=True, stable=True
                      ).indices[:, :k]
