"""Sparse 3D voxel engine: levels, coordinate maps and sparse convs.

Counterpart of proxytransformation_tpu/ops/sparse.py (a MinkowskiEngine
replacement with static shapes). A level is a capacity-bounded set of
voxels per sample: int32 linearized keys sorted ascending (invalid slots
hold SENTINEL), integer coords, features and a validity mask. Neighbor
maps are lookups of shifted keys in the sorted keys, built once per
level pair and shared by every conv on that pair.

Kernels (`csrc/`), each with its plain PyTorch version here: the
q-1/q/q+1 key lookup (`lookup_pmz.cu`), its center-only form, the
gather-GEMM sparse convolution (`sparse_conv.cu`, also the input
gradient) and its weight gradient (`sparse_conv_dw.cu`). A CUDA tensor
launches the kernel, a CPU tensor takes the plain version.

Every sort is stable, like every `jnp.argsort` of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _cuda
from .common import recip32

SENTINEL = 2**31 - 1

Extent = Tuple[int, int, int]
DEFAULT_EXTENT: Extent = (1280, 1280, 512)

LOOKUP_PMZ = _cuda.CudaKernel(
    'lookup_pmz', 'lookup_pmz', 'ptt_lookup_pmz',
    [_cuda.ptr, _cuda.ptr, _cuda.i32, _cuda.i32, _cuda.i32, _cuda.ptr,
     _cuda.ptr, _cuda.ptr, _cuda.ptr],
    source='proxytransformation_torch/csrc/lookup_pmz.cu',
    replaces='proxytransformation_tpu/ops/merge_join_pallas.py:194')
LOOKUP_CENTER = _cuda.CudaKernel(
    'lookup_center', 'lookup_pmz', 'ptt_lookup_center',
    [_cuda.ptr, _cuda.ptr, _cuda.i32, _cuda.i32, _cuda.i32, _cuda.ptr,
     _cuda.ptr],
    source='proxytransformation_torch/csrc/lookup_pmz.cu',
    replaces='proxytransformation_tpu/ops/merge_join_pallas.py:287')
_CONV_ARGS = [_cuda.ptr, _cuda.ptr, _cuda.ptr, _cuda.ptr, _cuda.i32,
              _cuda.i32, _cuda.i32, _cuda.i32, _cuda.i32, _cuda.i32,
              _cuda.ptr, _cuda.ptr]
SPARSE_CONV = _cuda.CudaKernel(
    'sparse_conv', 'sparse_conv', 'ptt_sparse_conv', _CONV_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
# the same kernel launched by the conv's backward for the input gradient
# (reference ops/sparse.py:515, :534), counted and timed on its own
SPARSE_CONV_DFEATS = _cuda.CudaKernel(
    'sparse_conv_dfeats', 'sparse_conv', 'ptt_sparse_conv', _CONV_ARGS,
    source='proxytransformation_torch/csrc/sparse_conv.cu',
    replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:744')
SPARSE_CONV_DW = _cuda.CudaKernel(
    'sparse_conv_dw', 'sparse_conv_dw', 'ptt_sparse_conv_dw',
    [_cuda.ptr, _cuda.ptr, _cuda.ptr, _cuda.i32, _cuda.i32, _cuda.i32,
     _cuda.i32, _cuda.i32, _cuda.i32, _cuda.i32, _cuda.ptr, _cuda.ptr,
     _cuda.ptr],
    source='proxytransformation_torch/csrc/sparse_conv_dw.cu',
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


def lookup_pmz_cuda(keys: torch.Tensor, queries: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch `ptt_lookup_pmz`; returns three (B, Q) int32 tensors."""
    B, V = keys.shape
    Q = queries.shape[1]
    _cuda.check_cuda('keys', keys, torch.int32, (B, V))
    _cuda.check_cuda('queries', queries, torch.int32, (B, Q))
    outs = [torch.empty((B, Q), dtype=torch.int32, device=keys.device)
            for _ in range(3)]
    LOOKUP_PMZ(keys.data_ptr(), queries.data_ptr(), B, V, Q,
               *(o.data_ptr() for o in outs), _cuda.current_stream(keys))
    return tuple(outs)


def lookup_center_cuda(keys: torch.Tensor, queries: torch.Tensor
                       ) -> torch.Tensor:
    """Launch `ptt_lookup_center`; returns (B, Q) int32."""
    B, V = keys.shape
    Q = queries.shape[1]
    _cuda.check_cuda('keys', keys, torch.int32, (B, V))
    _cuda.check_cuda('queries', queries, torch.int32, (B, Q))
    out = torch.empty((B, Q), dtype=torch.int32, device=keys.device)
    LOOKUP_CENTER(keys.data_ptr(), queries.data_ptr(), B, V, Q,
                  out.data_ptr(), _cuda.current_stream(keys))
    return out


def lookup_pmz(keys: torch.Tensor, queries: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q-1, q, q+1) index lookup: kernel on CUDA, plain on CPU."""
    if keys.is_cuda:
        return lookup_pmz_cuda(keys.contiguous(),
                               queries.to(torch.int32).contiguous())
    return lookup_pmz_plain(keys, queries)


def lookup_center(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match index lookup: kernel on CUDA, plain on CPU."""
    if keys.is_cuda:
        return lookup_center_cuda(keys.contiguous(),
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


def _launch_conv(kernel: _cuda.CudaKernel, feats: torch.Tensor,
                 nbr: torch.Tensor, weights: torch.Tensor,
                 out_mask: torch.Tensor) -> torch.Tensor:
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = weights.shape[-1]
    _cuda.check_cuda('feats', feats, torch.float32, (B, V_in, C_in))
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    _cuda.check_cuda('weights', weights, torch.float32, (K3, C_in, C_out))
    _cuda.check_cuda('out_mask', out_mask, torch.bool, (B, V_out))
    out = torch.empty((B, V_out, C_out), dtype=torch.float32,
                      device=feats.device)
    kernel(feats.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
           out_mask.data_ptr(), B, V_in, V_out, K3, C_in, C_out,
           out.data_ptr(), _cuda.current_stream(feats))
    return out


def sparse_conv_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                     weights: torch.Tensor,
                     out_mask: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/sparse_conv.cu` (float32 gather-GEMM)."""
    return _launch_conv(SPARSE_CONV, feats, nbr, weights, out_mask)


def sparse_conv_dfeats_cuda(g: torch.Tensor, nbr: torch.Tensor,
                            weights: torch.Tensor,
                            out_mask: torch.Tensor) -> torch.Tensor:
    """The same kernel for the input gradient: a conv of the output
    gradient over the mirrored or reversed map (see `_SparseConvFn`)."""
    return _launch_conv(SPARSE_CONV_DFEATS, g, nbr, weights, out_mask)


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


def dw_splits(rows: int, K3: int, C_in: int, C_out: int) -> int:
    """Row splits of the dW kernel: enough blocks to fill the card
    (~1024) where one (offset, channel tile) grid is small, with at
    least 256 map rows per split."""
    tiles = K3 * -(-C_in // 64) * -(-C_out // 64)
    return max(1, min(-(-1024 // tiles), -(-rows // 256)))


def sparse_conv_dw_cuda(feats: torch.Tensor, nbr: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/sparse_conv_dw.cu`; returns (K3, C_in, C_out) f32."""
    B, V_in, C_in = feats.shape
    V_out, K3 = nbr.shape[1:]
    C_out = g.shape[-1]
    _cuda.check_cuda('feats', feats, torch.float32, (B, V_in, C_in))
    _cuda.check_cuda('nbr', nbr, torch.int32, (B, V_out, K3))
    _cuda.check_cuda('g', g, torch.float32, (B, V_out, C_out))
    S = dw_splits(B * V_out, K3, C_in, C_out)
    dw = torch.empty((K3, C_in, C_out), dtype=torch.float32,
                     device=feats.device)
    ws = (torch.empty((S, K3, C_in, C_out), dtype=torch.float32,
                      device=feats.device) if S > 1 else dw)
    SPARSE_CONV_DW(feats.data_ptr(), nbr.data_ptr(), g.data_ptr(), B, V_in,
                   V_out, K3, C_in, C_out, S, ws.data_ptr(), dw.data_ptr(),
                   _cuda.current_stream(feats))
    return dw


def sparse_conv_dw(feats: torch.Tensor, nbr: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Weight gradient: kernel on CUDA, plain on CPU."""
    if feats.is_cuda:
        return sparse_conv_dw_cuda(feats.float().contiguous(),
                                   nbr.contiguous(), g.contiguous())
    return sparse_conv_dw_plain(feats, nbr, g)


def sparse_conv_dfeats(g: torch.Tensor, nbr: torch.Tensor,
                       weights: torch.Tensor,
                       out_mask: torch.Tensor) -> torch.Tensor:
    """The backward's conv of `g`: kernel on CUDA, plain on CPU."""
    if g.is_cuda:
        return sparse_conv_dfeats_cuda(g.contiguous(), nbr.contiguous(),
                                       weights.contiguous(),
                                       out_mask.contiguous())
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
    map with mirrored-transposed weights for a self map (kernel_offsets
    is symmetric under index reversal), or over the reversed map with
    transposed weights and an all-true mask for a strided one."""

    @staticmethod
    def forward(ctx, feats, nbr, weights, out_mask, self_map):
        ctx.save_for_backward(feats, nbr, weights, out_mask)
        ctx.self_map = self_map
        if feats.is_cuda:
            return sparse_conv_cuda(feats.contiguous(), nbr.contiguous(),
                                    weights.contiguous(),
                                    out_mask.contiguous())
        return sparse_conv_apply(feats, nbr, weights, out_mask)

    @staticmethod
    def backward(ctx, g):
        feats, nbr, weights, out_mask = ctx.saved_tensors
        g = torch.where(out_mask[..., None], g, torch.zeros_like(g)).float()
        dfeats = dW = None
        if ctx.needs_input_grad[2]:
            dW = sparse_conv_dw(feats, nbr, g).to(weights.dtype)
        if ctx.needs_input_grad[0]:
            if ctx.self_map:
                dfeats = sparse_conv_dfeats(
                    g, nbr, weights.transpose(1, 2).flip(0), out_mask)
            else:
                B, V_in = feats.shape[:2]
                dfeats = sparse_conv_dfeats(
                    g, reverse_map(nbr, V_in), weights.transpose(1, 2),
                    torch.ones((B, V_in), dtype=torch.bool,
                               device=feats.device))
            dfeats = dfeats.to(feats.dtype)
        return dfeats, None, dW, None, None


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
                out_mask: torch.Tensor, self_map: bool = False
                ) -> torch.Tensor:
    """Sparse conv: every K³>1 conv goes through `_SparseConvFn` (its
    kernels on a CUDA tensor, their plain versions on a CPU one); K³ = 1
    convs take the plain version and autograd on both (as the JAX
    package leaves K³ = 1 to XLA). `self_map` marks a stride-1 map of a
    level onto itself, which picks the backward's dfeats formula."""
    if nbr.shape[-1] > 1:
        return _SparseConvFn.apply(feats, nbr, weights, out_mask, self_map)
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
    """out[v] = coarse[parent(v)] @ W[offset(v)], weights (8, C_in, C_out)."""
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
    out = torch.matmul(x, weights.reshape(8 * C_in, -1))
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
