#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero before the final line):
  1. device: the card's name and power limit, torch version, TF32 off;
  2. build: every CUDA kernel from `proxytransformation_torch/csrc`
     with nvcc for sm_90a, one nvcc per source, all started together;
     one `[ptxas]` line per bf16 forward / input-gradient and dW kernel
     (registers, spills, its block's dynamic shared memory) and any
     performance note ptxas gives on them;
  3. capture: one flagship predict request at full width (seeded random
     weights) records the inputs of every kernel call on the main path;
  4. kernels: each captured call runs through the kernel and its plain
     PyTorch version on the same inputs — ball query and lookups must be
     bit-exact, the sparse conv within |k - p| <= 1e-4 * (1 + max|p|)
     (float32 sums taken in another order); kernel, plain and library
     times are device times from CUDA events (see `time_ms`), bounds
     come from this run's inputs; one `[ball_query]` line a call (ms,
     `warm_ms`, centers with fewer than K hits, points a first-K scan
     visits, segments) and one `[lookup_pmz]` line a call (V, Q, ms,
     `warm_ms`, bound, `torch.searchsorted` of q-1 alone, tiles over
     the window capacity; the kernel's tile windows checked against
     `lookup_tile_windows`) and one `[lookup_center]` line a call (the
     same, with whether the whole key row fits in shared memory, and
     `torch.searchsorted` of q), after the floor of the
     timing method (`timing_floor_ms`); the request's conv plans (one
     per neighbor map, checked) are counted and timed (`[plan]`);
  5. main path: launch counts reset to 0, three predict requests
     (B=2, 100k surface-scene points, 20 views at 480x480, 32 tokens),
     finite outputs, per-request times and peak memory; every kernel
     must have launched, by the captured count per request; then the
     device time per stage of one more request;
  6. small input: the tiny grounder on the card against the port's CPU
     path (plain versions) on the same weights and batch;
  7. train capture (grad mode): one full-width B=2 loss and backward
     (flagship targets: 8 gt boxes a sample) records the inputs of every
     kernel call; each call is held against its plain version, as in
     phase 4 (ball query and lookups bit-exact with their windows, dW,
     dfeats and the forward conv within the sparse conv's tolerance;
     the train step's keys differ from a request's: train-mode dropout
     feeds the neck's pruning), and the whole conv
     autograd.Function against autograd of the plain conv at every
     captured conv, the neck's pruned levels included;
  8. train main path: launch counts reset to 0, three AdamW steps
     (batches and dropout seeds 0, 1, 2): finite losses and grad norm,
     frozen parameters unchanged bit for bit, every trainable group
     changed, every kernel launched its captured count x 3; step times
     and peak memory;
  9. probes off the main path: the conv kernel on sorted random maps
     without column structure (TPU kernel `sparse_conv_gather_gemm`),
     and the row-gather probe (bit-exact against `table[idx]`, timed
     cold and warm against `torch.index_select`: `[row_gather]`);
 10. bf16 predict (`compute_dtype='bfloat16', remat_painting=True`, the
     same seeded weights): one request captured and every bf16 conv call
     held against the plain bf16 conv (bf16 output within one bf16 ulp
     plus the float32 tolerance; float32 output within the float32
     tolerance; one call of each shape launched twice for the same bits;
     beside each call a dense yardstick: `torch.matmul` of as many bf16
     rows as the kernel multiplies by a C_in x C_out bf16 matrix, no
     computation of the conv), then launch counts reset to 0 and three
     B=2 requests through the bf16 kernels (`sparse_conv_bf16`; the stem's float32
     input keeps the float32 kernel), times and peak memory;
 11. bf16 train step: one loss and backward captured and every bf16
     forward, dfeats and dW call held against its plain bf16 version
     (dW within the float32 tolerance, the same bits twice; beside each
     dW call a dense yardstick: `torch.matmul` of a C_in x hits by a
     hits x C_out bf16 matrix, no gather), the bytes of dW split
     partials the step writes under `bf16_dw_launch` against those of
     the float32 rule `dw_launch_shape` on the same calls (under a
     quarter, `[bf16 dW]`), then three AdamW steps from counts of 0
     (B=2), and one B=6 step (the flagship's per-chip batch) for its
     peak memory;
 12. runtime: the flagship config through the port's train CLI
     (`tools/train.py main(argv)`) with `--amp` and the config's
     `remat=True`, its data swapped by --cfg-options for
     `SyntheticGroundingDataset` at full scale (100k points, 20 views at
     480x480; 4 train samples at B=2, 2 val samples): two train steps
     from launch counts of 0 (the loader's prefetch thread), a
     checkpoint, val with GroundingMetric; every kernel call of the
     runner's first step held against its plain version; the saved
     checkpoint against the runner's state; then `--resume auto` with
     max_epochs=2 (a spawn pool of two loader workers): the restored
     parameters, AdamW state and generator equal the saved ones, and one
     more epoch runs. `[runner]` lines: s/it, data wait and first wait
     from `train_timing`, a bare `train_step` on the runner's first
     batch, the losses, the val keys, peak memory beside phase 11's
     no-remat bf16 step.
Then one `[conv]` line per sparse-conv kernel (forward, dfeats, dW, and
their bf16 forms) and conv class (stem, stage i strided, stage i self,
neck): calls, summed ms, bound, rows multiplied per hit (the bf16
forward and dfeats count each warpgroup's 64 rows, the bf16 dW each
split's 64-hit stages), the TFLOP/s on the rows multiplied and, for the
bf16 kernels, the dense yardstick's summed ms, and the bf16 dW's split
partials a call.

The line before the last holds the card's name and power limit as
nvidia-smi gives them, the one before it the kernels' JSON (`launches`:
device kernels on the main path, the wrapper's calls times the kernels
a call launches — two for the ball query; the entries named
`<kernel>:runner` are phase 12's, their launches those of the runner's
first run and their times those of its first step's calls); the last
line is
{"ok": true, "device": {...}}. Per-call details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
CONV_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """A check that stays under `python -O` (unlike assert)."""
    if not ok:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# capture of the kernel calls on the main path
# --------------------------------------------------------------------------
def install_capture(calls):
    """Wrap the CUDA wrappers the dispatchers call, recording inputs;
    'conv_fn' records the sparse conv autograd.Function's inputs."""
    from proxytransformation_torch.ops import ball_query as bq
    from proxytransformation_torch.ops import sparse as sp
    originals = {(sp, '_SparseConvFn'): sp._SparseConvFn}

    def wrap(module, attr, kernel):
        fn = getattr(module, attr)
        originals[(module, attr)] = fn

        def recorded(*args):
            calls.setdefault(kernel, []).append(args)
            return fn(*args)

        setattr(module, attr, recorded)

    wrap(bq, 'ball_query_idx_cuda', 'ball_query')
    wrap(sp, 'lookup_pmz_cuda', 'lookup_pmz')
    wrap(sp, 'lookup_center_cuda', 'lookup_center')
    wrap(sp, 'sparse_conv_cuda', 'sparse_conv')
    wrap(sp, 'sparse_conv_dfeats_cuda', 'sparse_conv_dfeats')
    wrap(sp, 'sparse_conv_dw_cuda', 'sparse_conv_dw')
    wrap(sp, 'sparse_conv_bf16_cuda', 'sparse_conv_bf16')
    wrap(sp, 'sparse_conv_dfeats_bf16_cuda', 'sparse_conv_dfeats_bf16')
    wrap(sp, 'sparse_conv_dw_bf16_cuda', 'sparse_conv_dw_bf16')

    def recorded_apply(*args):
        calls.setdefault('conv_fn', []).append(args)
        return originals[(sp, '_SparseConvFn')].apply(*args)

    # a namespace, not a class: a class sits in a reference cycle and
    # would hold the captured tensors until the garbage collector runs
    sp._SparseConvFn = types.SimpleNamespace(apply=recorded_apply)

    def restore():
        for (module, attr), fn in originals.items():
            setattr(module, attr, fn)
    return restore


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
_FLUSH = None
_SPIN_CYCLES_PER_MS = None
# timings whose launches took longer to queue than the spin ahead of them
NOT_HIDDEN = []


def spin_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(label: str, fn, reps: int = 3) -> float:
    """Mean device time of `fn` from CUDA events, with a cold L2 (a 64 MB
    write before each sample), after one warm-up call.

    A spin kernel of twice the warm-up's host time (at least 1 ms) is
    queued ahead of the start event, so the card stays busy while the host
    queues `fn`'s launches and a sample holds no host time. A call of more
    launches than the stream's queue holds blocks the host until the spin
    ends; its label goes to NOT_HIDDEN, as does any call whose queueing
    outlasted 0.8 of the spin."""
    global _FLUSH, _SPIN_CYCLES_PER_MS
    if _FLUSH is None:
        _FLUSH = torch.empty(16 * 2**20, dtype=torch.float32, device='cuda')
        _SPIN_CYCLES_PER_MS = spin_cycles_per_ms()
    t0 = time.perf_counter()
    fn()
    spin_ms = max(1.0, 2e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    total, hidden = 0.0, True
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS))
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        hidden &= (time.perf_counter() - t0) * 1e3 < 0.8 * spin_ms
        end.synchronize()
        total += start.elapsed_time(end)
    if not hidden:
        NOT_HIDDEN.append(label)
    return total / reps


def warm_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn` among `reps` back-to-back calls
    with a warm L2, behind a spin that hides the host's queueing: what a
    call costs in a stream of them, without the cold start that
    `time_ms` keeps."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * _SPIN_CYCLES_PER_MS))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timing_floor_ms() -> float:
    """`time_ms` of one launch that writes 4 bytes: the cold-start floor
    under every kernel time of this script."""
    x = torch.empty(1, device='cuda')
    return time_ms('floor', lambda: x.fill_(1.0))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# per-kernel checks
# --------------------------------------------------------------------------
def check_ball_query(calls):
    """Each captured call through the kernels against the plain
    version; one line a call: ms, centers with fewer than K hits, points
    a first-K scan visits, segments."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import ball_query as bq
    rows = []
    for i, (centers, points, mask, r2, K) in enumerate(calls):
        got = bq.ball_query_idx_cuda(centers, points, mask, r2, K)
        want = bq.ball_query_idx_plain(centers, points, mask, r2, K)
        torch.cuda.synchronize()
        require(torch.equal(got, want), 'ball query differs from plain at '
                f'{(got != want).nonzero()[:1].tolist()}')
        B, M, _ = centers.shape
        N = points.shape[1]
        last = got[..., K - 1].long()
        scanned = torch.where(last >= 0, last + 1, torch.full_like(last, N))
        ops = 8.0 * float(scanned.sum())
        byts = nbytes(centers, points, mask, got)
        shape = bq.ball_query_launch_shape(B, M, N, K,
                                           _cuda.sm_count(centers.device))
        row = dict(
            shape=f'B={B} M={M} N={N} K={K}', max_abs_err=0,
            ms=time_ms(f'ball_query {i}', lambda: bq.ball_query_idx_cuda(
                centers, points, mask, r2, K)),
            warm_ms=warm_ms(lambda: bq.ball_query_idx_cuda(
                centers, points, mask, r2, K)),
            plain_ms=time_ms(f'ball_query plain {i}',
                             lambda: bq.ball_query_idx_plain(
                                 centers, points, mask, r2, K)),
            library_ms=None, bytes=byts, ops=ops,
            short_centers=int((last < 0).sum()),
            points_scanned=int(scanned.sum()), segments=shape.segments,
            seg_len=shape.seg_len)
        rows.append(row)
        log(f'[ball_query] call {i} ({row["shape"]}): {row["ms"]:.4f} ms '
            f'(warm {row["warm_ms"]:.4f} ms), bound '
            f'{bound(byts, ops)[0]:.4f} ms; '
            f'{row["short_centers"]} centers with fewer than {K} hits, '
            f'{row["points_scanned"]} points a first-K scan visits, head '
            f'{shape.head} points, {shape.segments} segments of '
            f'{shape.seg_len} points')
    return rows


def check_lookup_pmz(calls):
    """Each captured call against the plain version, the kernel's tile
    windows against `lookup_tile_windows`; one line a call: V, Q, ms,
    bound, tiles over the window capacity. The library yardstick is
    `torch.searchsorted` of q-1 alone, not the same function."""
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (keys, queries) in enumerate(calls):
        B, V = keys.shape
        Q = queries.shape[1]
        tiles, capacity, _, _ = sp.lookup_launch_shape(B, V, Q)
        window = torch.empty((B, tiles), dtype=torch.int32, device='cuda')
        got = sp.lookup_pmz_cuda(keys, queries, window)
        want = sp.lookup_pmz_plain(keys, queries)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ('q-1', 'q', 'q+1')):
            require(torch.equal(g, w), f'lookup {name} differs from plain')
        require(torch.equal(window.long(),
                            sp.lookup_tile_windows(keys, queries)[1]),
                'lookup tile windows differ from lookup_tile_windows')
        qm1 = queries - 1
        byts = nbytes(keys, queries, *got)
        row = dict(
            shape=f'B={B} V={V} Q={Q}', max_abs_err=0,
            ms=time_ms(f'lookup_pmz {i}',
                       lambda: sp.lookup_pmz_cuda(keys, queries)),
            plain_ms=time_ms(f'lookup_pmz plain {i}',
                             lambda: sp.lookup_pmz_plain(keys, queries)),
            library_ms=time_ms(f'lookup_pmz library {i}',
                               lambda: torch.searchsorted(keys, qm1)),
            warm_ms=warm_ms(lambda: sp.lookup_pmz_cuda(keys, queries)),
            library_warm_ms=warm_ms(lambda: torch.searchsorted(keys, qm1)),
            bytes=byts, ops=0.0, tiles=B * tiles,
            tiles_over_capacity=int((window > capacity).sum()),
            capacity=capacity)
        rows.append(row)
        log(f'[lookup_pmz] call {i}: V={V} Q={Q}: {row["ms"]:.4f} ms (warm '
            f'{row["warm_ms"]:.4f} ms), bound {bound(byts, 0.0)[0]:.4f} ms, '
            f'searchsorted of q-1 alone {row["library_ms"]:.4f} ms (warm '
            f'{row["library_warm_ms"]:.4f} ms); '
            f'{row["tiles_over_capacity"]} of {B * tiles} tiles over the '
            f'{capacity}-key window capacity')
    return rows


def check_lookup_center(calls):
    """Each captured call against the plain version, the kernel's tile
    windows against `lookup_tile_windows`; one line a call: V, Q,
    whether the whole key row fits shared memory or fences place the
    windows, ms, warm ms, bound, and `torch.searchsorted` of q (the
    search alone)."""
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (keys, queries) in enumerate(calls):
        B, V = keys.shape
        Q = queries.shape[1]
        tiles, capacity, step, _ = sp.lookup_launch_shape(B, V, Q)
        window = torch.empty((B, tiles), dtype=torch.int32, device='cuda')
        got = sp.lookup_center_cuda(keys, queries, window)
        want = sp.lookup_center_plain(keys, queries)
        torch.cuda.synchronize()
        require(torch.equal(got, want), 'center lookup differs from plain')
        require(torch.equal(window.long(),
                            sp.lookup_tile_windows(keys, queries)[1]),
                'center lookup tile windows differ from lookup_tile_windows')
        byts = nbytes(keys, queries, got)
        row = dict(
            shape=f'B={B} V={V} Q={Q}', max_abs_err=0,
            ms=time_ms(f'lookup_center {i}',
                       lambda: sp.lookup_center_cuda(keys, queries)),
            plain_ms=time_ms(f'lookup_center plain {i}',
                             lambda: sp.lookup_center_plain(keys, queries)),
            library_ms=time_ms(f'lookup_center library {i}',
                               lambda: torch.searchsorted(keys, queries)),
            warm_ms=warm_ms(lambda: sp.lookup_center_cuda(keys, queries)),
            library_warm_ms=warm_ms(
                lambda: torch.searchsorted(keys, queries)),
            bytes=byts, ops=0.0, tiles=B * tiles, whole_row=step == 0,
            tiles_over_capacity=int((window > capacity).sum()),
            capacity=capacity)
        rows.append(row)
        where = ('whole row in shared memory' if step == 0 else
                 f'windows placed by fences every {step} keys, '
                 f'{row["tiles_over_capacity"]} of {B * tiles} tiles over '
                 f'the {capacity}-key capacity')
        log(f'[lookup_center] call {i}: V={V} Q={Q}, {where}: '
            f'{row["ms"]:.4f} ms (warm {row["warm_ms"]:.4f} ms), bound '
            f'{bound(byts, 0.0)[0]:.5f} ms, searchsorted '
            f'{row["library_ms"]:.4f} ms (warm '
            f'{row["library_warm_ms"]:.4f} ms)')
    return rows


def ptxas_lines(log_text):
    """One `[ptxas]` line per bf16 forward / input-gradient kernel<BN, KC>
    and dW kernel<BM, BN> from nvcc's `-Xptxas -v` output: registers,
    spills and the block's dynamic shared memory (`bf16_stage_shape`,
    `bf16_dw_stage_shape`), and ptxas's performance notes."""
    import re
    from proxytransformation_torch.ops import sparse as sp
    # a mangled kernel<a, b> name: its symbol, a, b
    kernel = r'(sparse_conv_(?:fwd|dfeats|dw)_bf16_tile)ILi(\d+)ELi(\d+)E'

    def label(kern, a, b):
        if '_dw_' in kern:
            return (f'{kern}<BM={a}, BN={b}>',
                    sp.bf16_dw_stage_shape(int(a), int(b))[1])
        return f'{kern}<BN={a}, KC={b}>', sp.bf16_stage_shape(int(b),
                                                              int(a))[1]

    lines, name, spill = [], None, ''
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '.*?" + kernel, line)
        if m:
            name = m.groups()
        elif 'Compiling entry function' in line:
            name = None
        elif name and 'spill' in line:
            spill = line.strip()
        elif name and 'Used' in line and 'registers' in line:
            text, smem = label(*name)
            used = line.split(':', 1)[1].strip()
            lines.append(f'[ptxas] {text}: {used}; {spill}; {smem} bytes '
                         f'dynamic shared memory')
            name = None
        m = re.search(r'\((C\d+)\) Potential Performance Loss: (.*?) in the '
                      r"function '.*?" + kernel, line)
        if m:
            lines.append(f'[ptxas] {label(*m.groups()[2:])[0]}: '
                         f'{m.group(1)} {m.group(2)}')
    return lines


def _plan(nbr, plan):
    from proxytransformation_torch.ops import sparse as sp
    return sp.conv_plan(nbr) if plan is None else plan


def rows_multiplied(nbr, out_mask, plan, C_in, C_out, rows=None):
    """Rows a forward kernel multiplies for this call: each group of
    `rows` sorted rows (the float32 tile path's 128-row tile by default,
    a bf16 warpgroup's 64) times the offsets in the OR of its kept rows'
    masks; on the float32 narrow paths only the hit rows."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    B, V, K3 = nbr.shape
    if rows is None:
        path, _, _ = sp.conv_launch_shape(B, V, K3, C_in, C_out,
                                          _cuda.sm_count(nbr.device))
        if path != 'tile':
            return float(((nbr >= 0) & out_mask[..., None]).sum())
        rows = sp.CONV_TILE_ROWS
    m = torch.where(out_mask, plan.row_mask, 0).gather(1, plan.order.long())
    m = torch.nn.functional.pad(m, (0, (-V) % rows)).reshape(B, -1, rows)
    bits = (m[..., None] >> torch.arange(K3, device=m.device)) & 1
    return float(bits.amax(2).sum()) * rows


def dw_rows_multiplied(nbr, plan, C_in, C_out):
    """Hit rows the float32 dW kernel multiplies: each split's hits,
    padded to its 16-hit steps on the tile path."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    B, V, K3 = nbr.shape
    tm, _, target, _ = sp.dw_launch_shape(B * V, K3, C_in, C_out,
                                          _cuda.sm_count(nbr.device))
    counts = plan.hit_counts.tolist()
    chunk, S = sp.dw_split_table(counts, target)
    if tm == 0:
        return float(sum(counts))
    return float(sum(-(-min(chunk, c - s * chunk) // 16) * 16
                     for c, n in zip(counts, S) for s in range(n)))


def dw_bf16_cut(nbr, plan, C_in, C_out):
    """(launch, rows multiplied, bytes of split partials, the same under
    the float32 kernel's `dw_launch_shape`, the rule the bf16 dW kernel
    took before `bf16_dw_launch`) of a bf16 dW call: each split's hits
    padded to its 64-hit stages, from `bf16_dw_launch`'s table; the
    partials of the offsets with more than one split, against every
    split's."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    B, V, K3 = nbr.shape
    Ci, Co = sp._round_step(C_in), sp._round_step(C_out)
    n_sm = _cuda.sm_count(nbr.device)
    cut = sp.bf16_dw_launch(K3, Ci, Co, n_sm)
    counts = plan.hit_counts.tolist()
    chunk, S = sp.bf16_dw_split_table(counts, cut.max_splits)
    step = sp.BF16_DW_HITS
    rows = sum(-(-max(0, min(chunk, c - s * chunk)) // step) * step
               for c, n in zip(counts, S) for s in range(n))
    _, _, target, _ = sp.dw_launch_shape(B * V, K3, Ci, Co, n_sm)
    _, old = sp.dw_split_table(counts, target)
    return (cut, float(rows), 4 * Ci * Co * sum(n for n in S if n > 1),
            4 * Ci * Co * sum(old))


def check_sparse_conv(calls):
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (feats, nbr, w, mask, plan) in enumerate(calls):
        plan = _plan(nbr, plan)
        got = sp.sparse_conv_cuda(feats, nbr, w, mask, plan)
        want = sp.sparse_conv_apply(feats, nbr, w, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'sparse conv {tuple(feats.shape)} -> '
                f'{tuple(got.shape)}: max err {err} > {tol}')
        B, V_in, C_in = feats.shape
        V_out, K3 = nbr.shape[1:]
        C_out = w.shape[-1]
        hits = float((nbr >= 0).sum())
        shape = (f'B={B} V_in={V_in} V_out={V_out} K3={K3} C_in={C_in} '
                 f'C_out={C_out} launch='
                 f'{sp.conv_launch_shape(B, V_out, K3, C_in, C_out, _cuda.sm_count(feats.device))}')
        rm = rows_multiplied(nbr, mask, plan, C_in, C_out)
        rows.append(dict(
            shape=shape, max_abs_err=err, key=(V_in, V_out, C_in, C_out),
            hits=float(((nbr >= 0) & mask[..., None]).sum()),
            rows_multiplied=rm, mult_ops=2.0 * rm * C_in * C_out,
            ms=time_ms(f'sparse_conv {i}',
                       lambda: sp.sparse_conv_cuda(feats, nbr, w, mask, plan)),
            plain_ms=time_ms(f'sparse_conv plain {i}',
                             lambda: sp.sparse_conv_apply(feats, nbr, w,
                                                          mask)),
            library_ms=None, bytes=nbytes(feats, nbr, w, mask, got),
            ops=2.0 * hits * C_in * C_out))
    return rows


def check_sparse_conv_dfeats(calls):
    """The forward kernel launched by the backward: a conv of the output
    gradient over the mirrored (self) or reversed (strided) map."""
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (g, nbr, w, mask, plan) in enumerate(calls):
        plan = _plan(nbr, plan)
        got = sp.sparse_conv_dfeats_cuda(g, nbr, w, mask, plan)
        want = sp.sparse_conv_apply(g, nbr, w, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'dfeats {tuple(g.shape)} -> {tuple(got.shape)}'
                f': max err {err} > {tol}')
        B, V_g, C_out = g.shape
        V_in, K3 = nbr.shape[1:]
        hits = float((nbr >= 0).sum())
        C_in = w.shape[-1]
        rm = rows_multiplied(nbr, mask, plan, C_out, C_in)
        rows.append(dict(
            shape=f'B={B} V_g={V_g} V_in={V_in} K3={K3} C_out={C_out} '
                  f'C_in={C_in}', max_abs_err=err,
            # the forward conv's shapes: its V_in, V_out, C_in, C_out
            key=(V_in, V_g, C_in, C_out),
            hits=float(((nbr >= 0) & mask[..., None]).sum()),
            rows_multiplied=rm, mult_ops=2.0 * rm * C_in * C_out,
            ms=time_ms(f'sparse_conv_dfeats {i}',
                       lambda: sp.sparse_conv_dfeats_cuda(g, nbr, w, mask,
                                                          plan)),
            plain_ms=time_ms(f'sparse_conv_dfeats plain {i}',
                             lambda: sp.sparse_conv_apply(g, nbr, w, mask)),
            library_ms=None, bytes=nbytes(g, nbr, w, mask, got),
            ops=2.0 * hits * C_out * C_in))
    return rows


def check_sparse_conv_dw(calls):
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (feats, nbr, g, plan) in enumerate(calls):
        plan = _plan(nbr, plan)
        got = sp.sparse_conv_dw_cuda(feats, nbr, g, plan)
        want = sp.sparse_conv_dw_plain(feats, nbr, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'dW {tuple(feats.shape)} x {tuple(g.shape)}: '
                f'max err {err} > {tol}')
        require(torch.equal(sp.sparse_conv_dw_cuda(feats, nbr, g, plan), got),
                'dW differs between two runs')
        B, V_in, C_in = feats.shape
        V_out, K3 = nbr.shape[1:]
        C_out = g.shape[-1]
        hits = float((nbr >= 0).sum())
        rm = dw_rows_multiplied(nbr, plan, C_in, C_out)
        rows.append(dict(
            shape=f'B={B} V_in={V_in} V_out={V_out} K3={K3} C_in={C_in} '
                  f'C_out={C_out} launch='
                  f'{sp.dw_launch_shape(B * V_out, K3, C_in, C_out, _cuda.sm_count(feats.device))}',
            max_abs_err=err, key=(V_in, V_out, C_in, C_out), hits=hits,
            rows_multiplied=rm, mult_ops=2.0 * rm * C_in * C_out,
            ms=time_ms(f'sparse_conv_dw {i}',
                       lambda: sp.sparse_conv_dw_cuda(feats, nbr, g, plan)),
            plain_ms=time_ms(f'sparse_conv_dw plain {i}',
                             lambda: sp.sparse_conv_dw_plain(feats, nbr, g)),
            library_ms=None, bytes=nbytes(feats, nbr, g, got),
            ops=2.0 * hits * C_in * C_out))
    return rows


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |x| (8 significant bits), float32."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_close(got, want):
    """(max abs error, ok): two roundings to bf16 of float32 sums taken in
    another order are at most one bf16 ulp of the larger apart, plus the
    float32 tolerance (where a sum cancels to near zero)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = (bf16_ulp(torch.maximum(g.abs(), w.abs()))
           + CONV_RTOL * (1.0 + float(w.abs().max())))
    return float(err.max()), bool((err <= tol).all())


def check_conv_bf16(calls, role):
    """The bf16 forward (`role` 'forward') or input-gradient ('dfeats')
    kernel at each captured call against the plain bf16 conv: its bf16
    output (what the model path writes) within one bf16 ulp plus the
    float32 tolerance, its float32 output within the float32 tolerance.
    Bound: bf16 operations over the tensor-core rate, or the bytes."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.ops import sparse as sp
    launch = (sp.sparse_conv_bf16_cuda if role == 'forward' else
              sp.sparse_conv_dfeats_bf16_cuda)
    rows, twice = [], set()
    for i, (x, nbr, w, mask, plan) in enumerate(calls):
        plan = _plan(nbr, plan)
        got = launch(x, nbr, w, mask, plan)
        want = sp.sparse_conv_apply_bf16(x, nbr, w, mask)
        got32 = launch(x, nbr, w, mask, plan, torch.float32)
        want32 = sp.sparse_conv_apply_bf16(x.float(), nbr, w, mask)
        torch.cuda.synchronize()
        err, ok = bf16_close(got, want)
        require(got.dtype == torch.bfloat16 and ok,
                f'bf16 {role} {tuple(x.shape)} -> {tuple(got.shape)}: max '
                f'err {err} over one bf16 ulp')
        err32 = float((got32 - want32).abs().max())
        tol32 = CONV_RTOL * (1.0 + float(want32.abs().max()))
        require(err32 <= tol32, f'bf16 {role} {tuple(x.shape)}, float32 '
                f'out: max err {err32} > {tol32}')
        B, V_in, C_in = x.shape
        V_out, K3 = nbr.shape[1:]
        C_out = w.shape[-1]
        hits = float((nbr >= 0).sum())
        # a dfeats row is keyed by its forward conv's (V_in, V_out, C_in,
        # C_out), as in check_sparse_conv_dfeats
        key = ((V_in, V_out, C_in, C_out) if role == 'forward' else
               (V_out, V_in, C_out, C_in))
        if key not in twice:  # one call of each shape: the same bits twice
            twice.add(key)
            require(torch.equal(launch(x, nbr, w, mask, plan), got) and
                    torch.equal(launch(x, nbr, w, mask, plan, torch.float32),
                                got32),
                    f'bf16 {role} {tuple(x.shape)} differs between two runs')
        # the rows the tensor cores multiply: each warpgroup's 64 rows
        # times the offsets it does not skip
        rm = rows_multiplied(nbr, mask, plan, C_in, C_out,
                             sp.BF16_TILE_ROWS // 2)
        cut = sp.bf16_tile_launch(B, V_out, sp._round_step(C_in),
                                  sp._round_step(C_out),
                                  _cuda.sm_count(x.device))
        rows.append(dict(
            shape=f'B={B} V_in={V_in} V_out={V_out} K3={K3} C_in={C_in} '
                  f'C_out={C_out} launch={tuple(cut)}', max_abs_err=err,
            dense_ms=dense_yardstick_ms(int(rm), C_in, C_out),
            f32_out_max_abs_err=err32, key=key,
            hits=float(((nbr >= 0) & mask[..., None]).sum()),
            rows_multiplied=rm, mult_ops=2.0 * rm * C_in * C_out,
            ms=time_ms(f'bf16 {role} {i}',
                       lambda: launch(x, nbr, w, mask, plan)),
            plain_ms=time_ms(f'bf16 {role} plain {i}',
                             lambda: sp.sparse_conv_apply_bf16(x, nbr, w,
                                                               mask)),
            library_ms=None, bytes=nbytes(x, nbr, w, mask, got),
            ops=2.0 * hits * C_in * C_out, ops_per_s=BF16_OPS_PER_S))
    return rows


def dense_yardstick_ms(rows, C_in, C_out):
    """`time_ms` of torch.matmul of a (rows x C_in) by a (C_in x C_out)
    bf16 matrix: a dense product of the rows a conv call multiplies. A
    yardstick for the bf16 conv kernels, not a computation of the conv."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    a = torch.randn(rows, C_in, device='cuda', generator=gen).bfloat16()
    b = torch.randn(C_in, C_out, device='cuda', generator=gen).bfloat16()
    return time_ms('dense yardstick', lambda: torch.matmul(a, b))


def dense_dw_yardstick_ms(rows, C_in, C_out):
    """`time_ms` of torch.matmul of a (C_in x rows) by a (rows x C_out)
    bf16 matrix: a dense product over the hit rows a dW call multiplies.
    A yardstick for the bf16 dW kernel, not a computation of dW (no
    gather)."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    a = torch.randn(C_in, rows, device='cuda', generator=gen).bfloat16()
    b = torch.randn(rows, C_out, device='cuda', generator=gen).bfloat16()
    return time_ms('dense dW yardstick', lambda: torch.matmul(a, b))


def check_sparse_conv_dw_bf16(calls):
    """The bf16 dW kernel at each captured call against the plain bf16
    dW (float32 out, the float32 tolerance), and the same bits twice;
    its launch shape, the bytes of split partials it writes (and those
    the float32 rule would write), and a dense yardstick."""
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (x, nbr, g, plan) in enumerate(calls):
        plan = _plan(nbr, plan)
        got = sp.sparse_conv_dw_bf16_cuda(x, nbr, g, plan)
        want = sp.sparse_conv_dw_plain_bf16(x, nbr, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'bf16 dW {tuple(x.shape)} x {tuple(g.shape)}: '
                f'max err {err} > {tol}')
        require(torch.equal(sp.sparse_conv_dw_bf16_cuda(x, nbr, g, plan),
                            got), 'bf16 dW differs between two runs')
        B, V_in, C_in = x.shape
        V_out, K3 = nbr.shape[1:]
        C_out = g.shape[-1]
        hits = float((nbr >= 0).sum())
        cut, rm, partial, partial_old = dw_bf16_cut(nbr, plan, C_in, C_out)
        rows.append(dict(
            shape=f'B={B} V_in={V_in} V_out={V_out} K3={K3} C_in={C_in} '
                  f'C_out={C_out} launch={tuple(cut)}', max_abs_err=err,
            partial_bytes=partial, partial_bytes_old=partial_old,
            dense_ms=dense_dw_yardstick_ms(int(rm), C_in, C_out),
            key=(V_in, V_out, C_in, C_out), hits=hits,
            rows_multiplied=rm, mult_ops=2.0 * rm * C_in * C_out,
            ms=time_ms(f'bf16 dW {i}',
                       lambda: sp.sparse_conv_dw_bf16_cuda(x, nbr, g, plan)),
            plain_ms=time_ms(f'bf16 dW plain {i}',
                             lambda: sp.sparse_conv_dw_plain_bf16(x, nbr, g)),
            library_ms=None, bytes=nbytes(x, nbr, g, got),
            ops=2.0 * hits * C_in * C_out, ops_per_s=BF16_OPS_PER_S))
    return rows


def plan_cost(forward_calls):
    """The conv plans one forward builds (one per map and owner, told
    apart by their tensors): how many, their device launches (profiler)
    and their summed device time, each alone with a cold L2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from proxytransformation_torch.ops import sparse as sp
    plans = {call[4].order.data_ptr(): call[1] for call in forward_calls}
    maps = {nbr.data_ptr() for nbr in plans.values()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for nbr in plans.values():
            sp.conv_plan(nbr)
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    ms = sum(time_ms(f'conv_plan {i}', lambda: sp.conv_plan(nbr))
             for i, nbr in enumerate(plans.values()))
    return dict(plans=len(plans), maps=len(maps), launches=launches, ms=ms)


def conv_classes(model, forward_calls):
    """{(V_in, V_out, C_in, C_out) of a forward conv: its class}, from the
    order in which one forward launches its 40 convs: the stem, then per
    stage its strided conv and its self-map convs, then the neck."""
    labels = ['stem']
    for i, n in enumerate(model.backbone_3d.stage_blocks):
        labels += [f'stage {i + 1} strided'] + [f'stage {i + 1} self'] * (
            2 * n - 1)
    labels += ['neck'] * (len(forward_calls) - len(labels))
    out = {}
    for label, (feats, nbr, w, _, _) in zip(labels, forward_calls):
        key = (feats.shape[1], nbr.shape[1], feats.shape[2], w.shape[2])
        require(out.get(key, label) == label,
                f'conv shapes {key} in two classes')
        out[key] = label
    return out


CLASS_ORDER = ('stem', *(f'stage {i} {kind}' for i in range(1, 5)
                         for kind in ('strided', 'self')), 'neck')


def conv_class_table(rows_by_kernel, classes):
    """One line per (kernel, class): calls, summed ms, the bound of the
    summed bytes and operations, and rows multiplied over hits."""
    table = []
    for name, rows in rows_by_kernel.items():
        groups = {}
        for r in rows:
            groups.setdefault(classes[tuple(r['key'])], []).append(r)
        for label in CLASS_ORDER:
            rs = groups.get(label)
            if not rs:
                continue
            bound_ms, bound_by = bound(sum(r['bytes'] for r in rs),
                                       sum(r['ops'] for r in rs),
                                       ops_rate(rs))
            hits = sum(r['hits'] for r in rs)
            mult = sum(r['rows_multiplied'] for r in rs)
            ms = sum(r['ms'] for r in rs)
            dense = [r['dense_ms'] for r in rs if 'dense_ms' in r]
            partial = [r['partial_bytes'] for r in rs
                       if 'partial_bytes' in r]
            table.append(dict(
                kernel=name, conv_class=label, calls=len(rs), ms=ms,
                bound_ms=bound_ms, bound_by=bound_by, rows_multiplied=mult,
                hits=hits,
                rows_multiplied_per_hit=mult / hits if hits else None,
                tflops_on_rows_multiplied=sum(r['mult_ops'] for r in rs)
                / ms / 1e9,
                dense_yardstick_ms=sum(dense) if dense else None,
                partial_bytes_a_call=(sum(partial) / len(partial)
                                      if partial else None)))
    return table


def check_conv_autograd(calls) -> list:
    """The conv autograd.Function (kernels) against autograd of the
    plain conv at every captured K3 > 1 conv of the train step: the stem,
    the stages' self and strided convs, and the neck's convs over levels
    pruned to their top voxels (whose out_mask is narrower than the
    map's key set), each on a seeded random output cotangent."""
    from proxytransformation_torch.ops import sparse as sp
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = []
    for i, (feats, nbr, w, mask, self_map, plan) in enumerate(calls):
        cot = torch.randn((feats.shape[0], nbr.shape[1], w.shape[-1]),
                          device='cuda', generator=gen)
        grads = []
        for conv in (lambda f, k: sp.sparse_conv(f, nbr, k, mask, self_map,
                                                 plan),
                     lambda f, k: sp.sparse_conv_apply(f, nbr, k, mask)):
            f = feats.detach().clone().requires_grad_()
            k = w.detach().clone().requires_grad_()
            (conv(f, k) * cot).sum().backward()
            grads.append((f.grad, k.grad))
        for what, got, want in zip(('dfeats', 'dW'), *grads):
            err = float((got - want).abs().max())
            tol = CONV_RTOL * (1.0 + float(want.abs().max()))
            out.append(dict(conv=i, grad=what, shape=tuple(feats.shape),
                            V_out=nbr.shape[1], K3=nbr.shape[2],
                            self_map=self_map,
                            masked_outputs=int((~mask).sum()),
                            max_abs_err=err, tol=tol))
    bad = [r for r in out if not r['max_abs_err'] <= r['tol']]
    require(not bad, f'conv backward differs from plain autograd: {bad}')
    return out


def check_any_map_conv():
    """TPU kernel `sparse_conv_gather_gemm` (one window over all
    offsets, any map): the conv kernel on the sorted random maps of
    tests/test_sparse_conv_pallas.py::_synthetic, at its K3 > 1 shapes."""
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for Ci, Co, K3 in ((3, 7, 27), (16, 150, 27), (64, 64, 8),
                       (300, 520, 27)):
        rng = np.random.RandomState(Ci + Co)
        B, Vi, Vo = 2, 700, 300
        feats = torch.tensor(rng.randn(B, Vi, Ci).astype(np.float32),
                             device='cuda')
        nbr = np.sort(rng.randint(0, Vi, (B, Vo, K3)), axis=1)
        nbr = np.where(rng.rand(B, Vo, K3) < 0.4, -1, nbr)
        nbr = torch.tensor(nbr.astype(np.int32), device='cuda')
        w = torch.tensor((rng.randn(K3, Ci, Co) * 0.1).astype(np.float32),
                         device='cuda')
        mask = torch.tensor(rng.rand(B, Vo) < 0.9, device='cuda')
        plan = sp.conv_plan(nbr)
        got = sp.sparse_conv_cuda(feats, nbr, w, mask, plan)
        want = sp.sparse_conv_apply(feats, nbr, w, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'any-map conv {Ci}->{Co} K3={K3}: max err '
                f'{err} > {tol}')
        hits = float((nbr >= 0).sum())
        rows.append(dict(
            shape=f'B={B} V_in={Vi} V_out={Vo} K3={K3} C_in={Ci} C_out={Co}',
            max_abs_err=err,
            ms=time_ms(f'any-map conv {Ci}',
                       lambda: sp.sparse_conv_cuda(feats, nbr, w, mask,
                                                   plan)),
            plain_ms=time_ms(f'any-map conv plain {Ci}',
                             lambda: sp.sparse_conv_apply(feats, nbr, w,
                                                          mask)),
            library_ms=None, bytes=nbytes(feats, nbr, w, mask, got),
            ops=2.0 * hits * Ci * Co))
    return rows


def check_row_gather():
    from proxytransformation_torch.tools import gather_probe as gp
    table, idx = gp.probe_inputs('cuda')
    got = gp.row_gather_cuda(table, idx)
    require(torch.equal(got, gp.row_gather_plain(table, idx)),
            'row gather differs from table[idx]')
    lidx = idx.long()
    row = dict(
        shape=f'table={tuple(table.shape)} idx={tuple(idx.shape)}',
        max_abs_err=0,
        ms=time_ms('row_gather', lambda: gp.row_gather_cuda(table, idx)),
        plain_ms=time_ms('row_gather plain',
                         lambda: gp.row_gather_plain(table, idx)),
        library_ms=time_ms('row_gather library',
                           lambda: torch.index_select(table, 0, lidx)),
        warm_ms=warm_ms(lambda: gp.row_gather_cuda(table, idx)),
        library_warm_ms=warm_ms(lambda: torch.index_select(table, 0, lidx)),
        # each gathered row read once, the indices, the output
        bytes=2 * nbytes(got) + nbytes(idx), ops=0.0)
    log(f'[row_gather] {row["shape"]}: {row["ms"]:.4f} ms (warm '
        f'{row["warm_ms"]:.4f} ms), bound {bound(row["bytes"], 0.0)[0]:.5f} '
        f'ms, index_select {row["library_ms"]:.4f} ms (warm '
        f'{row["library_warm_ms"]:.4f} ms), plain {row["plain_ms"]:.4f} ms')
    return [row]


def bound(byts: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(ms, what bounds it): the bytes over the memory rate or the
    operations over their peak rate (float32 outside the tensor cores
    unless `ops_per_s` says otherwise), whichever takes longer."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def ops_rate(rows) -> float:
    """The peak rate of a kernel's operations: its rows' `ops_per_s`
    (the bf16 kernels' tensor-core rate), else float32's."""
    return rows[0].get('ops_per_s', FP32_OPS_PER_S) if rows else \
        FP32_OPS_PER_S


def summarize(name, rows, calls, calls_per_train_step):
    """The kernel's entry of the kernels line: one request's (or train
    step's) calls summed; `launches` counts device kernels, the wrapper's
    calls times the kernels a call launches."""
    from proxytransformation_torch.ops import _cuda
    k = _cuda.KERNELS[name]
    rate = ops_rate(rows)
    for r in rows:
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['ops'], rate)
    bound_ms, bound_by = bound(sum(r['bytes'] for r in rows),
                               sum(r['ops'] for r in rows), rate)
    lib = [r['library_ms'] for r in rows]
    return {
        'name': name, 'route': 'cuda', 'source': k.source,
        'replaces': k.replaces, 'launches': calls * k.kernels_per_call,
        'wrapper_calls': calls,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': sum(r['ms'] for r in rows),
        'plain_ms': sum(r['plain_ms'] for r in rows),
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None if None in lib else sum(lib),
        'calls_checked': len(rows),
        'launches_per_train_step': calls_per_train_step * k.kernels_per_call,
    }


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    from proxytransformation_torch.device import full_float32
    with full_float32():
        return run()


def run() -> int:
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape)
    from proxytransformation_torch.ops import _cuda

    t_start = time.perf_counter()
    # 1. device
    smi = nvidia_smi_line()
    log(f'[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}'
        ' | TF32 off')
    dev = torch.device('cuda')

    # 2. build
    t0 = time.perf_counter()
    build_logs = _cuda.build()
    log(f'[build] {len(build_logs)} kernel libraries in '
        f'{time.perf_counter() - t0:.1f} s')
    for text in build_logs:
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or line.endswith('.cu'):
                log(f'[build]   {line.strip()}')
    for line in ptxas_lines(_cuda.build_log('sparse_conv_bf16')):
        log(line)

    # 3. capture one flagship request
    t0 = time.perf_counter()
    model = SparseFeatureFusion3DGrounderPreshape(device=dev).random_init_(0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f'[model] flagship grounder, {n_params} parameters, built in '
        f'{time.perf_counter() - t0:.1f} s')
    with torch.no_grad():
        predict = predict_phases(model, dev)

    # 7-8. the train path, in grad mode
    train = train_phases(model, dev)

    # 9. probes off the main path
    probe_rows = {'sparse_conv_anymap': check_any_map_conv(),
                  'row_gather': check_row_gather()}
    log('[probe] any-map conv and row gather match their plain versions')

    # 10-11. the bf16 path
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()
    bf16 = bf16_phases(dev)

    # 12. the runtime: the flagship through the port's train CLI
    runner = runner_phases(bf16['summary'])

    rows = {**predict['rows'], **train['rows'], **probe_rows, **bf16['rows']}
    table = conv_class_table(
        {k: rows[k] for k in ('sparse_conv', 'sparse_conv_dfeats',
                              'sparse_conv_dw', *BF16_KERNELS,
                              *BF16_TRAIN_ONLY)}, predict['classes'])
    for r in table:
        dense, partial = r['dense_yardstick_ms'], r['partial_bytes_a_call']
        log(f'[conv] {r["kernel"]:23s} {r["conv_class"]:16s} '
            f'{r["calls"]:2d} calls {r["ms"]:8.3f} ms, bound '
            f'{r["bound_ms"]:.3f} ms ({r["bound_by"]}), rows multiplied / '
            f'hits {r["rows_multiplied_per_hit"]:.3f}, '
            f'{r["tflops_on_rows_multiplied"]:.1f} TFLOP/s on them'
            + ('' if dense is None else
               f'; dense yardstick (torch.matmul of those rows, bf16) '
               f'{dense:.3f} ms')
            + ('' if partial is None else
               f'; split partials {partial / 1e6:.2f} MB a call'))
    counts = {**predict['counts'],
              **{k: train['counts'][k] for k in TRAIN_ONLY},
              **{k: bf16['counts'].get(k, 0)
                 for k in (*BF16_KERNELS, *BF16_TRAIN_ONLY)}}
    per_step = {**train['per_step'],
                **{k: bf16['per_step'].get(k, 0)
                   for k in (*BF16_KERNELS, *BF16_TRAIN_ONLY)}}
    kernels = [summarize(name, rows[name], counts[name],
                         per_step.get(name, 0))
               for name in (*PREDICT_KERNELS, *TRAIN_ONLY, *BF16_KERNELS,
                            *BF16_TRAIN_ONLY)]
    # the conv kernel on maps no model builds: off the main path, and the
    # probe's own calls are comparisons
    anymap = summarize('sparse_conv', probe_rows['sparse_conv_anymap'], 0, 0)
    anymap.update(
        name='sparse_conv_anymap',
        replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:177')
    kernels.append(anymap)
    kernels.append(summarize('row_gather', probe_rows['row_gather'], 0, 0))
    for name in RUNNER_KERNELS:
        entry = summarize(name, runner['rows'][name], runner['counts'][name],
                          runner['per_step'][name])
        entry['name'] = f'{name}:runner'
        kernels.append(entry)
    log(f'[kernel] timings the spin could not hide host time from: '
        f'{NOT_HIDDEN}')
    detail = {'device': smi, 'torch': torch.__version__,
              'request_ms': predict['req_ms'], 'peak_gib': predict['peak'],
              'stage_ms': predict['stages'], 'train': train['summary'],
              'bf16': bf16['summary'], 'runner': runner['summary'],
              'runner_step_calls': runner['rows'],
              'bf16_request_calls': bf16['request_rows'],
              'bf16_train_step_calls': bf16['path_rows'],
              'conv_autograd': train['conv_autograd'],
              'conv_classes': table, 'conv_plans': predict['plans'],
              'kernels': kernels, 'host_time_not_hidden': NOT_HIDDEN,
              'time_ms_floor': predict['floor'],
              'calls': rows, 'train_step_calls': train['path_rows'],
              'seconds': time.perf_counter() - t_start}
    out_dir = Path(__file__).resolve().parent / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'chip_smoke.json').write_text(json.dumps(detail, indent=1))
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


PREDICT_KERNELS = ('ball_query', 'lookup_pmz', 'lookup_center',
                   'sparse_conv')
TRAIN_ONLY = ('sparse_conv_dfeats', 'sparse_conv_dw')
BF16_KERNELS = ('sparse_conv_bf16', )
BF16_TRAIN_ONLY = ('sparse_conv_dfeats_bf16', 'sparse_conv_dw_bf16')
CHECKS = {'ball_query': check_ball_query, 'lookup_pmz': check_lookup_pmz,
          'lookup_center': check_lookup_center,
          'sparse_conv': check_sparse_conv,
          'sparse_conv_dfeats': check_sparse_conv_dfeats,
          'sparse_conv_dw': check_sparse_conv_dw,
          'sparse_conv_bf16': lambda c: check_conv_bf16(c, 'forward'),
          'sparse_conv_dfeats_bf16': lambda c: check_conv_bf16(c, 'dfeats'),
          'sparse_conv_dw_bf16': check_sparse_conv_dw_bf16}


def check_calls(calls, names, where='a request'):
    rows = {}
    for name in names:
        t0 = time.perf_counter()
        rows[name] = CHECKS[name](calls[name])
        log(f'[kernel] {name}: {len(rows[name])} calls of {where} match '
            f'their plain version ({time.perf_counter() - t0:.1f} s)')
    return rows


def predict_phases(model, dev):
    """Phases 3-6: capture, kernel checks, three requests, stages, the
    small input."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import batch_to_device
    batch = batch_to_device(flagship_batch(seed=0), dev)
    calls = capture_kernel_calls(lambda: model(batch))
    per_request = {k: len(calls.get(k, ())) for k in PREDICT_KERNELS}
    log(f'[capture] kernel calls per request: {per_request}')
    for name in PREDICT_KERNELS:
        require(per_request[name] > 0,
                f'kernel {name} is not on the predict path')

    # 4. kernels against their plain versions
    floor = timing_floor_ms()
    log(f'[kernel] time_ms floor (one 4-byte fill, cold L2): {floor:.4f} ms')
    rows = check_calls(calls, PREDICT_KERNELS)
    classes = conv_classes(model, calls['sparse_conv'])
    plans = plan_cost(calls['sparse_conv'])
    log(f'[plan] {plans["plans"]} conv plans a request over '
        f'{plans["maps"]} maps: {plans["launches"]} launches, '
        f'{plans["ms"]:.3f} ms (each alone, cold L2)')
    require(plans['plans'] == plans['maps'],
            'a map\'s conv plan was built more than once')
    del calls

    # 5. the main path: three requests, counts from 0
    n_req = 3
    req_ms, counts, peak = run_requests(model, dev, n_req, 'request')
    log(f'[main path] launches in {n_req} requests: {counts}; peak memory '
        f'{peak:.2f} GiB')
    for name, n in per_request.items():
        require(counts[name] == n * n_req,
                f'{name}: {counts[name]} launches, expected {n} x {n_req}')
    for name in TRAIN_ONLY:
        require(counts[name] == 0, f'{name} launched in predict')

    stages = stage_breakdown(
        model, batch_to_device(flagship_batch(seed=n_req - 1), dev))
    log('[stages] device ms of one request: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in stages.items()))

    # 6. small input: the card against the port's CPU path
    small_input_check()
    return dict(rows=rows, counts=counts, req_ms=req_ms, peak=peak,
                stages=stages, classes=classes, plans=plans, floor=floor)


def run_requests(model, dev, n_req, label):
    """`n_req` B=2 requests (batch seeds 0, 1, ...) from launch counts of
    0: finite boxes and scores of the right shape, a valid query; (CUDA
    event ms of each, the launch counts, the peak memory in GiB)."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.ops import _cuda
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    req_ms = []
    for r in range(n_req):
        batch = batch_to_device(flagship_batch(seed=r), dev)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = model(batch)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        req_ms.append(start.elapsed_time(end))
        B, Q = out['scores_3d'].shape
        require(out['bboxes_3d'].shape == (B, Q, 9),
                f'boxes of shape {tuple(out["bboxes_3d"].shape)}')
        for k in ('bboxes_3d', 'scores_3d'):
            require(bool(torch.isfinite(out[k]).all()), f'non-finite {k}')
        require(bool(out['query_mask'].any()), 'no valid query')
        log(f'[{label} {r}] {req_ms[-1]:.1f} ms on the card '
            f'({host_ms:.1f} ms host), {int(out["query_mask"].sum())} '
            f'valid queries, top score {float(out["scores_3d"].max()):.5f}')
    return (req_ms, _cuda.launch_counts(),
            torch.cuda.max_memory_allocated() / 2**30)


def train_phases(model, dev):
    """Phases 7-8: capture one train step's kernel calls and hold them
    against their plain versions, then three AdamW steps."""
    from proxytransformation_torch.engine.train import (
        BASE_LR, build_lr_schedule, build_optimizer, make_train_step,
        param_label)

    # 7. capture one loss and backward
    calls = capture_kernel_calls(lambda: loss_and_backward(model, dev))
    model.zero_grad(set_to_none=True)
    names = (*PREDICT_KERNELS, *TRAIN_ONLY)
    per_step = {k: len(calls.get(k, ())) for k in names}
    log(f'[train capture] kernel calls per train step: {per_step}')
    for name in names:
        require(per_step[name] > 0, f'kernel {name} is not on the train path')
    with torch.no_grad():
        rows = check_calls(calls, TRAIN_ONLY, 'the train step')
        # the forward kernels again, on the train step's own inputs
        # (train-mode dropout, then the neck's pruning, change the keys)
        path_rows = check_calls(calls, PREDICT_KERNELS, 'the train step')
    conv_autograd = check_conv_autograd(calls['conv_fn'])
    for what in ('dfeats', 'dW'):
        worst = max((r for r in conv_autograd if r['grad'] == what),
                    key=lambda r: r['max_abs_err'] / r['tol'])
        log(f'[train capture] conv autograd.Function vs plain autograd, '
            f'{what} at all {len(calls["conv_fn"])} convs: worst conv '
            f'{worst["conv"]} (self map {worst["self_map"]}, '
            f'{worst["masked_outputs"]} masked outputs), max err '
            f'{worst["max_abs_err"]:.3g} of tol {worst["tol"]:.3g}')
    del calls

    # 8. three AdamW steps, counts from 0
    opt = build_optimizer(model)
    # one step an epoch: the three steps stay before the first milestone
    step = make_train_step(model, opt,
                           build_lr_schedule(BASE_LR, steps_per_epoch=1))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if param_label(n) == 'frozen'}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if param_label(n) != 'frozen'}
    n_steps = 3
    step_ms, host_ms, step_losses, counts, peak = run_steps(
        step, dev, n_steps, 'train step')
    log(f'[train main path] launches in {n_steps} steps: {counts}; peak '
        f'memory {peak:.2f} GiB')
    for name, n in per_step.items():
        require(counts[name] == n * n_steps,
                f'{name}: {counts[name]} launches, expected {n} x {n_steps}')
    params = dict(model.named_parameters())
    require(all(torch.equal(params[n], p) for n, p in frozen.items()),
            'a frozen parameter changed')
    for group in ('default', 'decoder'):
        changed = [n for n, p in before.items() if param_label(n) == group
                   and not torch.equal(params[n], p)]
        require(changed, f'no parameter of group {group} changed')
    summary = dict(step_ms=step_ms, host_ms=host_ms, losses=step_losses,
                   peak_gib=peak, per_step=per_step,
                   frozen_tensors=len(frozen))
    return dict(rows=rows, path_rows=path_rows, counts=counts,
                per_step=per_step, conv_autograd=conv_autograd,
                summary=summary)


def capture_kernel_calls(fn):
    """{kernel: captured calls} of everything `fn()` launches."""
    calls = {}
    restore = install_capture(calls)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        restore()
    return calls


def loss_and_backward(model, dev):
    """One train-mode loss (batch and dropout seed 0) and its backward."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import batch_to_device
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = model.loss(batch_to_device(
        flagship_batch(seed=0, with_targets=True), dev), gen)
    sum(losses[k] for k in sorted(losses)).backward()


def bf16_phases(dev):
    """Phases 10-11: the bf16 (`--amp`) path of the flagship grounder, on
    the same seeded weights as the float32 phases."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.engine.train import (
        BASE_LR, build_lr_schedule, build_optimizer, make_train_step)
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape, batch_to_device)
    model = SparseFeatureFusion3DGrounderPreshape(
        device=dev, compute_dtype='bfloat16',
        remat_painting=True).random_init_(0)

    # 10. one bf16 request captured and checked, then three from 0
    batch = batch_to_device(flagship_batch(seed=0), dev)
    with torch.no_grad():
        calls = capture_kernel_calls(lambda: model(batch))
        per_request = {k: len(v) for k, v in calls.items()
                       if k != 'conv_fn'}
        log(f'[bf16 capture] kernel calls per bf16 request: {per_request}')
        # every kernel call of the request: the neck prunes by bf16
        # scores, so the keys and lookup shapes differ from float32's
        names = (*PREDICT_KERNELS, *BF16_KERNELS)
        for name in names:
            require(per_request.get(name, 0) > 0,
                    f'kernel {name} is not on the bf16 predict path')
        request_rows = check_calls(calls, names, 'a bf16 request')
        rows = {k: request_rows.pop(k) for k in BF16_KERNELS}
        del calls
        n_req = 3
        req_ms, counts, peak = run_requests(model, dev, n_req,
                                            'bf16 request')
    log(f'[bf16 main path] launches in {n_req} requests: {counts}; peak '
        f'memory {peak:.2f} GiB')
    for name, n in counts.items():
        require(n == per_request.get(name, 0) * n_req,
                f'{name}: {n} launches in bf16 predict, expected '
                f'{per_request.get(name, 0)} x {n_req}')

    # 11. one bf16 loss and backward captured and checked; three AdamW
    # steps from 0; one B=6 step for its peak memory
    calls = capture_kernel_calls(lambda: loss_and_backward(model, dev))
    model.zero_grad(set_to_none=True)
    per_step = {k: len(v) for k, v in calls.items() if k != 'conv_fn'}
    log(f'[bf16 train capture] kernel calls per bf16 train step: '
        f'{per_step}')
    # every kernel call of the step, the float32 stem's three included
    names = (*PREDICT_KERNELS, *TRAIN_ONLY, *BF16_KERNELS, *BF16_TRAIN_ONLY)
    for name in names:
        require(per_step.get(name, 0) > 0,
                f'kernel {name} is not on the bf16 train path')
    with torch.no_grad():
        path_rows = check_calls(calls, names, 'the bf16 train step')
    rows.update({k: path_rows.pop(k) for k in BF16_TRAIN_ONLY})
    del calls
    partials = {rule: sum(r[key] for r in rows['sparse_conv_dw_bf16'])
                for rule, key in (('bf16_dw_launch', 'partial_bytes'),
                                  ('dw_launch_shape', 'partial_bytes_old'))}
    log(f'[bf16 dW] split partials written a bf16 step: '
        f'{partials["bf16_dw_launch"] / 1e6:.1f} MB under bf16_dw_launch, '
        f'{partials["dw_launch_shape"] / 1e6:.1f} MB under dw_launch_shape '
        f'on the same calls')
    require(partials['bf16_dw_launch'] < partials['dw_launch_shape'] / 4,
            f'bf16 dW split partials not under a quarter: {partials}')
    step = make_train_step(model, build_optimizer(model),
                           build_lr_schedule(BASE_LR, steps_per_epoch=1))
    n_steps = 3
    step_ms, host_ms, losses, train_counts, train_peak = run_steps(
        step, dev, n_steps, 'bf16 train step')
    log(f'[bf16 train main path] launches in {n_steps} steps: '
        f'{train_counts}; peak memory {train_peak:.2f} GiB')
    for name, n in train_counts.items():
        require(n == per_step.get(name, 0) * n_steps,
                f'{name}: {n} launches in bf16 train, expected '
                f'{per_step.get(name, 0)} x {n_steps}')
    b6_ms, _, b6_losses, _, b6_peak = run_steps(step, dev, 1,
                                                'bf16 train step B=6', B=6)
    log(f'[bf16 B=6] one train step at the flagship\'s per-chip batch: '
        f'{b6_ms[0]:.1f} ms, peak memory {b6_peak:.2f} GiB of '
        f'{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}')
    summary = dict(request_ms=req_ms, request_peak_gib=peak,
                   step_ms=step_ms, step_host_ms=host_ms, losses=losses,
                   step_peak_gib=train_peak, per_request=per_request,
                   per_step=per_step, b6_step_ms=b6_ms[0],
                   b6_peak_gib=b6_peak, b6_losses=b6_losses[0],
                   dw_split_partial_bytes=partials)
    del model, step
    torch.cuda.empty_cache()
    return dict(rows=rows, request_rows=request_rows, path_rows=path_rows,
                summary=summary,
                counts={**counts, **{k: train_counts.get(k, 0)
                                     for k in BF16_TRAIN_ONLY}},
                per_step=per_step)


def run_steps(step, dev, n_steps, label, B=2):
    """`n_steps` train steps (batches and dropout seeds 0, 1, ...) from
    launch counts of 0, with finite losses and grad norm; (CUDA event ms
    and host ms of each, their metrics, the launch counts, the peak
    memory in GiB)."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.ops import _cuda
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, step_losses = [], [], []
    for s in range(n_steps):
        batch = batch_to_device(
            flagship_batch(B=B, seed=s, with_targets=True), dev)
        gen = torch.Generator(device=dev).manual_seed(s)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(batch, gen)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        m = {k: float(v) for k, v in metrics.items()}
        for k, v in m.items():
            require(np.isfinite(v), f'{label} {s}: non-finite {k}')
        step_losses.append(m)
        log(f'[{label} {s}] {step_ms[-1]:.1f} ms on the card '
            f'({host_ms[-1]:.1f} ms host), total_loss '
            f'{m["total_loss"]:.6f}, grad_norm {m["grad_norm"]:.6f}, '
            f'loss_cls {m["loss_cls"]:.6f}, loss_bbox {m["loss_bbox"]:.6f}')
    return (step_ms, host_ms, step_losses, _cuda.launch_counts(),
            torch.cuda.max_memory_allocated() / 2**30)


FLAGSHIP_CONFIG = 'configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py'
RUNNER_KERNELS = (*PREDICT_KERNELS, *TRAIN_ONLY, *BF16_KERNELS,
                  *BF16_TRAIN_ONLY)


def runner_argv(work: Path, max_epochs: int, workers: int,
                resume: bool = False):
    """The train CLI's arguments for phase 12: the flagship config with
    --amp, its datasets swapped for full-scale synthetic ones."""
    ds = dict(type='SyntheticGroundingDataset', n_points=100_000,
              n_views=20, img_size=480)
    root = Path(__file__).resolve().parent
    return ([str(root / FLAGSHIP_CONFIG), '--amp', '--work-dir', str(work)]
            + (['--resume', 'auto'] if resume else [])
            + ['--cfg-options',
               f'train_dataloader.dataset={dict(ds, length=4)!r}',
               'val_dataloader.dataset='
               f'{dict(ds, length=2, test_mode=True)!r}',
               'train_dataloader.batch_size=2',
               f'train_dataloader.num_workers={workers}',
               'val_dataloader.num_workers=0',
               f'train_cfg.max_epochs={max_epochs}', 'train_cfg.val_interval=1',
               'log_interval=1'])


def require_same(got, want, what):
    """Nested dicts / lists of tensors and values equal, bit for bit."""
    if isinstance(want, dict):
        require(isinstance(got, dict) and set(got) == set(want),
                f'{what}: keys differ')
        for k in want:
            require_same(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, (list, tuple)):
        require(len(got) == len(want), f'{what}: lengths differ')
        for i, (g, w) in enumerate(zip(got, want)):
            require_same(g, w, f'{what}[{i}]')
    elif isinstance(want, torch.Tensor):
        require(torch.equal(got.cpu(), want.cpu()), f'{what} differs')
    else:
        require(got == want, f'{what}: {got!r} != {want!r}')


def runner_state(runner):
    return {'model': runner.model.state_dict(),
            'optimizer': runner.optimizer.state_dict(),
            'generator': runner.generator.get_state(),
            'step': runner.global_step}


def runner_phases(bf16_summary):
    """Phase 12: the flagship through `tools/train.py main(argv)` with
    --amp and remat, two steps, a checkpoint and val; the first step's
    kernel calls checked; then --resume auto for one more epoch."""
    import shutil
    from proxytransformation_torch.engine import runner as runner_mod
    from proxytransformation_torch.engine.checkpoint import (
        latest_checkpoint, load_checkpoint)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import train as train_cli
    work = Path(__file__).resolve().parent / 'build' / 'chip_smoke_runner'
    shutil.rmtree(work, ignore_errors=True)
    first = {}
    make_train_step = runner_mod.make_train_step

    def capturing_make_train_step(model, optimizer, schedule=None):
        step = make_train_step(model, optimizer, schedule)

        def train_step(batch, generator=None):
            if first:
                return step(batch, generator)
            out = {}
            first['batch'] = batch
            first['calls'] = capture_kernel_calls(
                lambda: out.update(step(batch, generator)))
            return out
        return train_step

    runner_mod.make_train_step = capturing_make_train_step
    try:
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(runner_argv(work, 1, 0))
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        runner_mod.make_train_step = make_train_step
    model = runner.model
    require(model.remat and model.remat_painting
            and model.compute_dtype == 'bfloat16',
            'remat / --amp did not reach the runner\'s model')
    per_step = {k: len(first['calls'].get(k, ())) for k in RUNNER_KERNELS}
    log(f'[runner] flagship config, --amp, remat: 2 train steps, a '
        f'checkpoint and val in {wall:.1f} s; kernel calls of the first '
        f'step: {per_step}; launches in the run: '
        f'{ {k: counts[k] for k in RUNNER_KERNELS} }')
    for name in RUNNER_KERNELS:
        require(counts[name] > 0, f'{name}: not launched by the runner')
        require(per_step[name] > 0, f'{name}: not in the runner\'s step')
    losses = runner.train_log
    require(len(losses) == 2 and all(
        np.isfinite(v) for r in losses for v in r.values()),
        f'runner losses: {losses}')
    timing = dict(runner.train_timing)
    results = json.loads((work / 'val_results.json').read_text())
    require('Overall@0.25' in results and 'Overall@0.5' in results,
            f'val results: {sorted(results)}')

    # the checkpoint holds the runner's state
    path = latest_checkpoint(str(work))
    payload = load_checkpoint(path)
    require((payload['epoch'], payload['iteration'], payload['step'])
            == (1, 0, 2), f'checkpoint {path}: epoch {payload["epoch"]}')
    saved = {k: payload[k] for k in ('model', 'optimizer', 'generator',
                                     'step')}
    require_same(runner_state(runner), saved, 'saved checkpoint')

    # a bare train step on the runner's first batch, for comparison
    bare = make_train_step(model, runner.optimizer, runner.schedule)
    bare_ms, bare_host_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        bare(first['batch'], runner.generator)
        end.record()
        torch.cuda.synchronize()
        bare_host_ms.append((time.perf_counter() - t1) * 1e3)
        bare_ms.append(start.elapsed_time(end))
    log(f'[runner] s/it {timing["iter_s"]:.3f} (2 steps, the first '
        f'batch\'s wait included), data_wait_s '
        f'{timing["data_wait_s"]:.4f}, first_wait_s '
        f'{timing["first_wait_s"]:.3f} (loader: prefetch thread); bare '
        f'train_step on the runner\'s first batch: '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(bare_host_ms, bare_ms)))
    log('[runner] losses: ' + '; '.join(
        f'step {r["iter"]} total {r["total_loss"]:.5f} grad_norm '
        f'{r["grad_norm"]:.4f}' for r in losses)
        + f'; val_results.json keys: {sorted(results)}')
    log(f'[runner] peak memory {peak:.2f} GiB with remat=True (two B=2 '
        f'steps, val, checkpoint); phase 11\'s bf16 B=2 step without '
        f'remat: {bf16_summary["step_peak_gib"]:.2f} GiB')

    # every kernel call of the first step against its plain version
    with torch.no_grad():
        rows = check_calls(first['calls'], RUNNER_KERNELS,
                           'the runner\'s first step')
    del runner, model, bare, first
    torch.cuda.empty_cache()

    # --resume auto: one more epoch from the saved state
    restored = {}
    resume_from = runner_mod.Runner.resume_from

    def checked_resume_from(self, path):
        out = resume_from(self, path)
        require_same(runner_state(self), saved, 'restored state')
        restored['from'] = path
        return out

    runner_mod.Runner.resume_from = checked_resume_from
    try:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        runner = train_cli.main(runner_argv(work, 2, 2, resume=True))
        resume_wall = time.perf_counter() - t0
        resume_counts = _cuda.launch_counts()
    finally:
        runner_mod.Runner.resume_from = resume_from
    require(restored.get('from') == path, 'the runner did not resume')
    require([(r['epoch'], r['iter']) for r in runner.train_log]
            == [(1, 1), (1, 2)], f'resumed log: {runner.train_log}')
    require(runner.global_step == 4, f'step {runner.global_step}')
    for name in RUNNER_KERNELS:
        require(resume_counts[name] > 0, f'{name}: not launched on resume')
    resume_timing = dict(runner.train_timing)
    log(f'[runner] --resume auto from {Path(path).name}: restored '
        f'parameters, AdamW state and generator equal the saved ones; '
        f'epoch 2 (loader: spawn pool of 2 workers) in {resume_wall:.1f} s, '
        f's/it {resume_timing["iter_s"]:.3f}, data_wait_s '
        f'{resume_timing["data_wait_s"]:.4f}, first_wait_s '
        f'{resume_timing["first_wait_s"]:.3f}; losses '
        + ', '.join(f'{r["total_loss"]:.5f}' for r in runner.train_log))
    del runner
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    summary = dict(wall_s=wall, timing=timing, bare_step_ms=bare_ms,
                   bare_step_host_ms=bare_host_ms, losses=losses,
                   val_results=results, peak_gib=peak,
                   no_remat_bf16_step_peak_gib=bf16_summary['step_peak_gib'],
                   per_step=per_step, resume_wall_s=resume_wall,
                   resume_timing=resume_timing,
                   resume_counts={k: resume_counts[k]
                                  for k in RUNNER_KERNELS})
    return dict(rows=rows, counts=counts, per_step=per_step,
                summary=summary)


STAGES = ('text_encoder', 'backbone', 'preshape', 'backbone_3d', 'neck_3d',
          'decoder')


def stage_breakdown(model, batch):
    """Device time of each top-level stage of one request, from CUDA
    events at each submodule's entry and exit. The neck includes the
    2D→3D painting; 'other' is the rest of the request (voxelization,
    query selection, the head)."""
    spans = {name: [] for name in STAGES}
    handles = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    for name in STAGES:
        mod = getattr(model, name)
        handles.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: spans[name].append([event(), None])))
        handles.append(mod.register_forward_hook(
            lambda m, a, o, name=name: spans[name][-1].__setitem__(1, event())))
    start = event()
    model(batch)
    end = event()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    ms = {name: sum(a.elapsed_time(b) for a, b in spans[name])
          for name in STAGES}
    total = start.elapsed_time(end)
    ms['other'] = total - sum(ms.values())
    ms['request'] = total
    return ms


def small_input_check() -> None:
    """The tiny test grounder on the card vs the port's CPU path."""
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape, batch_to_device)
    cfg = dict(num_queries=16, voxel_size=0.05, n_points=1024,
               img_base_channels=4, text_width=64, text_layers=2,
               text_heads=4, grid_size=4, text_blocks=1, img_blocks=1,
               dynamic_drop_radio=0.5, num_sub=8, backbone3d_depth=14,
               sparse_capacities=(1024, 800, 512, 256, 128, 64),
               voxel_extent=(128, 128, 128), neck_out_channels=64,
               pts_prune_threshold=64, decoder_layers=2, embed_dims=64,
               num_heads=4, ffn_channels=128, img_spacial_dim=2,
               max_text_len=64)
    cpu = SparseFeatureFusion3DGrounderPreshape(**cfg, device='cpu')
    cpu.random_init_(1)
    gpu = SparseFeatureFusion3DGrounderPreshape(**cfg, device='cuda')
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    B, V, H, W, N, L = 2, 2, 64, 64, 1024, 8
    proj = np.tile(np.array([[50, 0, W / 2, 0], [0, 50, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    batch = {
        'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
        'points': rng.uniform(0, 3.0, (B, N, 3)).astype(np.float32),
        'points_mask': np.ones((B, N), bool),
        'input_ids': rng.randint(0, 49408, (B, L)).astype(np.int32),
        'text_mask': np.arange(L)[None].repeat(B, 0) < L - 2,
        'proj_mats': proj, 'views_mask': np.ones((B, V), bool)}
    want = cpu(batch_to_device(batch, 'cpu'))
    got = gpu(batch_to_device(batch, 'cuda'))
    require(torch.equal(got['query_mask'].cpu(), want['query_mask']),
            'query masks differ between the card and the CPU')
    for k in ('bboxes_3d', 'scores_3d'):
        err = float((got[k].cpu() - want[k]).abs().max())
        log(f'[small input] {k}: card vs CPU max abs err {err:.3g}')
        require(err <= 1e-4, f'{k}: card and CPU differ by {err}')


if __name__ == '__main__':
    sys.exit(main())
