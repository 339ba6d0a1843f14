#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero before the final line):
  1. device: the card's name and power limit, torch version, TF32 off;
  2. build: every CUDA kernel from `proxytransformation_torch/csrc`
     with nvcc for sm_90a, one nvcc per source, all started together;
  3. capture: one flagship predict request at full width (seeded random
     weights) records the inputs of every kernel call on the main path;
  4. kernels: each captured call runs through the kernel and its plain
     PyTorch version on the same inputs — ball query and lookups must be
     bit-exact, the sparse conv within |k - p| <= 1e-4 * (1 + max|p|)
     (float32 sums taken in another order); kernel, plain and library
     times are device times from CUDA events (see `time_ms`), bounds
     come from this run's inputs;
  5. main path: launch counts reset to 0, three predict requests
     (B=2, 100k surface-scene points, 20 views at 480x480, 32 tokens),
     finite outputs, per-request times and peak memory; every kernel
     must have launched, by the captured count per request; then the
     device time per stage of one more request;
  6. small input: the tiny grounder on the card against the port's CPU
     path (plain versions) on the same weights and batch;
  7. train capture (grad mode): one full-width B=2 loss and backward
     (flagship targets: 8 gt boxes a sample) records the inputs of every
     kernel call; each dW and dfeats call is held against its plain
     version within the sparse conv's tolerance, and the whole conv
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
     against `torch.index_select`).

The line before the last holds the card's name and power limit as
nvidia-smi gives them, the one before it the kernels' JSON; the last
line is {"ok": true, "device": {...}}. Per-call details go to
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# per-kernel checks
# --------------------------------------------------------------------------
def check_ball_query(calls):
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
        rows.append(dict(
            shape=f'B={B} M={M} N={N} K={K}', max_abs_err=0,
            ms=time_ms(f'ball_query {i}', lambda: bq.ball_query_idx_cuda(
                centers, points, mask, r2, K)),
            plain_ms=time_ms(f'ball_query plain {i}',
                             lambda: bq.ball_query_idx_plain(
                                 centers, points, mask, r2, K)),
            library_ms=None, bytes=byts, ops=ops))
    return rows


def check_lookup_pmz(calls):
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (keys, queries) in enumerate(calls):
        got = sp.lookup_pmz_cuda(keys, queries)
        want = sp.lookup_pmz_plain(keys, queries)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ('q-1', 'q', 'q+1')):
            require(torch.equal(g, w), f'lookup {name} differs from plain')
        B, V = keys.shape
        rows.append(dict(
            shape=f'B={B} V={V} Q={queries.shape[1]}', max_abs_err=0,
            ms=time_ms(f'lookup_pmz {i}',
                       lambda: sp.lookup_pmz_cuda(keys, queries)),
            plain_ms=time_ms(f'lookup_pmz plain {i}',
                             lambda: sp.lookup_pmz_plain(keys, queries)),
            library_ms=None, bytes=nbytes(keys, queries, *got), ops=0.0))
    return rows


def check_lookup_center(calls):
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (keys, queries) in enumerate(calls):
        got = sp.lookup_center_cuda(keys, queries)
        want = sp.lookup_center_plain(keys, queries)
        torch.cuda.synchronize()
        require(torch.equal(got, want), 'center lookup differs from plain')
        B, V = keys.shape
        rows.append(dict(
            shape=f'B={B} V={V} Q={queries.shape[1]}', max_abs_err=0,
            ms=time_ms(f'lookup_center {i}',
                       lambda: sp.lookup_center_cuda(keys, queries)),
            plain_ms=time_ms(f'lookup_center plain {i}',
                             lambda: sp.lookup_center_plain(keys, queries)),
            library_ms=time_ms(f'lookup_center library {i}',
                               lambda: torch.searchsorted(keys, queries)),
            bytes=nbytes(keys, queries, got), ops=0.0))
    return rows


def check_sparse_conv(calls):
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (feats, nbr, w, mask) in enumerate(calls):
        got = sp.sparse_conv_cuda(feats, nbr, w, mask)
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
                 f'C_out={C_out}')
        rows.append(dict(
            shape=shape, max_abs_err=err,
            ms=time_ms(f'sparse_conv {i}',
                       lambda: sp.sparse_conv_cuda(feats, nbr, w, mask)),
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
    for i, (g, nbr, w, mask) in enumerate(calls):
        got = sp.sparse_conv_dfeats_cuda(g, nbr, w, mask)
        want = sp.sparse_conv_apply(g, nbr, w, mask)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'dfeats {tuple(g.shape)} -> {tuple(got.shape)}'
                f': max err {err} > {tol}')
        B, V_g, C_out = g.shape
        V_in, K3 = nbr.shape[1:]
        hits = float((nbr >= 0).sum())
        rows.append(dict(
            shape=f'B={B} V_g={V_g} V_in={V_in} K3={K3} C_out={C_out} '
                  f'C_in={w.shape[-1]}', max_abs_err=err,
            ms=time_ms(f'sparse_conv_dfeats {i}',
                       lambda: sp.sparse_conv_dfeats_cuda(g, nbr, w, mask)),
            plain_ms=time_ms(f'sparse_conv_dfeats plain {i}',
                             lambda: sp.sparse_conv_apply(g, nbr, w, mask)),
            library_ms=None, bytes=nbytes(g, nbr, w, mask, got),
            ops=2.0 * hits * C_out * w.shape[-1]))
    return rows


def check_sparse_conv_dw(calls):
    from proxytransformation_torch.ops import sparse as sp
    rows = []
    for i, (feats, nbr, g) in enumerate(calls):
        got = sp.sparse_conv_dw_cuda(feats, nbr, g)
        want = sp.sparse_conv_dw_plain(feats, nbr, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = CONV_RTOL * (1.0 + float(want.abs().max()))
        require(err <= tol, f'dW {tuple(feats.shape)} x {tuple(g.shape)}: '
                f'max err {err} > {tol}')
        require(torch.equal(sp.sparse_conv_dw_cuda(feats, nbr, g), got),
                'dW differs between two runs')
        B, V_in, C_in = feats.shape
        V_out, K3 = nbr.shape[1:]
        C_out = g.shape[-1]
        hits = float((nbr >= 0).sum())
        rows.append(dict(
            shape=f'B={B} V_in={V_in} V_out={V_out} K3={K3} C_in={C_in} '
                  f'C_out={C_out} splits={sp.dw_splits(B * V_out, K3, C_in, C_out)}',
            max_abs_err=err,
            ms=time_ms(f'sparse_conv_dw {i}',
                       lambda: sp.sparse_conv_dw_cuda(feats, nbr, g)),
            plain_ms=time_ms(f'sparse_conv_dw plain {i}',
                             lambda: sp.sparse_conv_dw_plain(feats, nbr, g)),
            library_ms=None, bytes=nbytes(feats, nbr, g, got),
            ops=2.0 * hits * C_in * C_out))
    return rows


def check_conv_autograd(calls) -> list:
    """The conv autograd.Function (kernels) against autograd of the
    plain conv at every captured K3 > 1 conv of the train step: the stem,
    the stages' self and strided convs, and the neck's convs over levels
    pruned to their top voxels (whose out_mask is narrower than the
    map's key set), each on a seeded random output cotangent."""
    from proxytransformation_torch.ops import sparse as sp
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = []
    for i, (feats, nbr, w, mask, self_map) in enumerate(calls):
        cot = torch.randn((feats.shape[0], nbr.shape[1], w.shape[-1]),
                          device='cuda', generator=gen)
        grads = []
        for conv in (lambda f, k: sp.sparse_conv(f, nbr, k, mask, self_map),
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
        got = sp.sparse_conv_cuda(feats, nbr, w, mask)
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
                       lambda: sp.sparse_conv_cuda(feats, nbr, w, mask)),
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
    return [dict(
        shape=f'table={tuple(table.shape)} idx={tuple(idx.shape)}',
        max_abs_err=0,
        ms=time_ms('row_gather', lambda: gp.row_gather_cuda(table, idx)),
        plain_ms=time_ms('row_gather plain',
                         lambda: gp.row_gather_plain(table, idx)),
        library_ms=time_ms('row_gather library',
                           lambda: torch.index_select(table, 0, lidx)),
        # each gathered row read once, the indices, the output
        bytes=2 * nbytes(got) + nbytes(idx), ops=0.0)]


def bound(byts: float, ops: float):
    """(ms, what bounds it): the bytes over the memory rate or the float32
    operations over the peak rate, whichever takes longer."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def summarize(name, rows, launches, per_train_step):
    """The kernel's entry of the kernels line: one request's (or train
    step's) calls summed."""
    from proxytransformation_torch.ops import _cuda
    k = _cuda.KERNELS[name]
    for r in rows:
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['ops'])
    bound_ms, bound_by = bound(sum(r['bytes'] for r in rows),
                               sum(r['ops'] for r in rows))
    lib = [r['library_ms'] for r in rows]
    return {
        'name': name, 'route': 'cuda', 'source': k.source,
        'replaces': k.replaces, 'launches': launches,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': sum(r['ms'] for r in rows),
        'plain_ms': sum(r['plain_ms'] for r in rows),
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None if None in lib else sum(lib),
        'calls_checked': len(rows), 'launches_per_train_step': per_train_step,
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

    rows = {**predict['rows'], **train['rows'], **probe_rows}
    counts = {**predict['counts'],
              **{k: train['counts'][k] for k in TRAIN_ONLY}}
    kernels = [summarize(name, rows[name], counts[name],
                         train['per_step'].get(name, 0))
               for name in (*PREDICT_KERNELS, *TRAIN_ONLY)]
    # the conv kernel on maps no model builds: off the main path, and the
    # probe's own calls are comparisons
    anymap = summarize('sparse_conv', probe_rows['sparse_conv_anymap'], 0, 0)
    anymap.update(
        name='sparse_conv_anymap',
        replaces='proxytransformation_tpu/ops/sparse_conv_pallas.py:177')
    kernels.append(anymap)
    kernels.append(summarize('row_gather', probe_rows['row_gather'], 0, 0))
    log(f'[kernel] timings the spin could not hide host time from: '
        f'{NOT_HIDDEN}')
    detail = {'device': smi, 'torch': torch.__version__,
              'request_ms': predict['req_ms'], 'peak_gib': predict['peak'],
              'stage_ms': predict['stages'], 'train': train['summary'],
              'conv_autograd': train['conv_autograd'],
              'kernels': kernels, 'host_time_not_hidden': NOT_HIDDEN,
              'calls': rows, 'seconds': time.perf_counter() - t_start}
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
CHECKS = {'ball_query': check_ball_query, 'lookup_pmz': check_lookup_pmz,
          'lookup_center': check_lookup_center,
          'sparse_conv': check_sparse_conv,
          'sparse_conv_dfeats': check_sparse_conv_dfeats,
          'sparse_conv_dw': check_sparse_conv_dw}


def check_calls(calls, names):
    rows = {}
    for name in names:
        t0 = time.perf_counter()
        rows[name] = CHECKS[name](calls[name])
        log(f'[kernel] {name}: {len(rows[name])} calls match their plain '
            f'version ({time.perf_counter() - t0:.1f} s)')
    return rows


def predict_phases(model, dev):
    """Phases 3-6: capture, kernel checks, three requests, stages, the
    small input."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.ops import _cuda
    batch = batch_to_device(flagship_batch(seed=0), dev)
    calls = {}
    restore = install_capture(calls)
    model(batch)
    torch.cuda.synchronize()
    restore()
    per_request = {k: len(calls.get(k, ())) for k in PREDICT_KERNELS}
    log(f'[capture] kernel calls per request: {per_request}')
    for name in PREDICT_KERNELS:
        require(per_request[name] > 0,
                f'kernel {name} is not on the predict path')

    # 4. kernels against their plain versions
    rows = check_calls(calls, PREDICT_KERNELS)
    del calls

    # 5. the main path: three requests, counts from 0
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    req_ms = []
    n_req = 3
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
        log(f'[request {r}] {req_ms[-1]:.1f} ms on the card '
            f'({host_ms:.1f} ms host), {int(out["query_mask"].sum())} '
            f'valid queries, top score {float(out["scores_3d"].max()):.5f}')
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f'[main path] launches in {n_req} requests: {counts}; peak memory '
        f'{peak:.2f} GiB')
    for name, n in per_request.items():
        require(counts[name] == n * n_req,
                f'{name}: {counts[name]} launches, expected {n} x {n_req}')
    for name in TRAIN_ONLY:
        require(counts[name] == 0, f'{name} launched in predict')

    stages = stage_breakdown(model, batch)
    log('[stages] device ms of one request: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in stages.items()))

    # 6. small input: the card against the port's CPU path
    small_input_check()
    return dict(rows=rows, counts=counts, req_ms=req_ms, peak=peak,
                stages=stages)


def train_phases(model, dev):
    """Phases 7-8: capture one train step's kernel calls and hold them
    against their plain versions, then three AdamW steps."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.engine.train import (
        build_lr_schedule, build_optimizer, make_train_step, param_label)
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.ops import _cuda

    def train_batch(seed):
        return batch_to_device(flagship_batch(seed=seed, with_targets=True),
                               dev)

    # 7. capture one loss and backward
    calls = {}
    restore = install_capture(calls)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = model.loss(train_batch(0), gen)
    sum(losses[k] for k in sorted(losses)).backward()
    torch.cuda.synchronize()
    restore()
    model.zero_grad(set_to_none=True)
    del losses
    names = (*PREDICT_KERNELS, *TRAIN_ONLY)
    per_step = {k: len(calls.get(k, ())) for k in names}
    log(f'[train capture] kernel calls per train step: {per_step}')
    for name in names:
        require(per_step[name] > 0, f'kernel {name} is not on the train path')
    with torch.no_grad():
        rows = check_calls(calls, TRAIN_ONLY)
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
    step = make_train_step(model, opt, build_lr_schedule(steps_per_epoch=1))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if param_label(n) == 'frozen'}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if param_label(n) != 'frozen'}
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    n_steps, step_ms, host_ms, step_losses = 3, [], [], []
    for s in range(n_steps):
        batch = train_batch(s)
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
            require(np.isfinite(v), f'train step {s}: non-finite {k}')
        step_losses.append(m)
        log(f'[train step {s}] {step_ms[-1]:.1f} ms on the card '
            f'({host_ms[-1]:.1f} ms host), total_loss '
            f'{m["total_loss"]:.6f}, grad_norm {m["grad_norm"]:.6f}, '
            f'loss_cls {m["loss_cls"]:.6f}, loss_bbox {m["loss_bbox"]:.6f}')
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
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
    return dict(rows=rows, counts=counts, per_step=per_step,
                conv_autograd=conv_autograd, summary=summary)


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
