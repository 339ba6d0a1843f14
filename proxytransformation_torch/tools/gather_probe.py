"""Row-gather probe on the card: `table[idx]` through `csrc/row_gather.cu`.

    python -m proxytransformation_torch.tools.gather_probe

Counterpart of tools/exp_pallas_gather.py, which probed whether Mosaic
lowers an in-VMEM row gather on the TPU. On the card a gather is a plain
indexed load; this tool runs the hand-written kernel at the probe's
shapes (a (14336, 64) float32 table, 256 int32 indices, numpy seed 0),
checks it bit for bit against `table[idx]`, and prints the kernel's
device duration under torch.profiler beside `torch.index_select`'s, cold
and warm.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..ops import _cuda

ROWS, C, T = 14336, 64, 256   # table rows, channels, indices

ROW_GATHER = _cuda.CudaKernel(
    'row_gather', 'row_gather', 'ptt_row_gather',
    [_cuda.ptr, _cuda.ptr, _cuda.i32, _cuda.i32, _cuda.ptr, _cuda.ptr],
    source='proxytransformation_torch/csrc/row_gather.cu',
    replaces='tools/exp_pallas_gather.py:44')


def probe_inputs(device) -> tuple:
    """The probe's table (ROWS, C) float32 and indices (T,) int32."""
    rng = np.random.RandomState(0)
    table = torch.tensor(rng.randn(ROWS, C).astype(np.float32), device=device)
    idx = torch.tensor(rng.randint(0, ROWS, (T, )).astype(np.int32),
                       device=device)
    return table, idx


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return table[idx.long()]


def row_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/row_gather.cu`; returns (len(idx), C) float32. The
    kernel copies rows 16 bytes at a time and refuses (RuntimeError) a C
    that is not a multiple of 4 or a table not 16-byte aligned."""
    rows, c = table.shape
    n = idx.shape[0]
    _cuda.check_cuda('table', table, torch.float32, (rows, c))
    _cuda.check_cuda('idx', idx, torch.int32, (n, ))
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    ROW_GATHER(table.data_ptr(), idx.data_ptr(), n, c, out.data_ptr(),
               _cuda.current_stream(table))
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]`: kernel on CUDA, plain on CPU."""
    if table.is_cuda:
        return row_gather_cuda(table.contiguous(),
                               idx.to(torch.int32).contiguous())
    return row_gather_plain(table, idx)


def kernel_us(fn, reps: int, flush=None) -> dict:
    """{kernel symbol: (mean device µs, launches)} of the kernels `fn`
    launches over `reps` calls, from torch.profiler's device events: the
    kernels' own durations, without the launch and event latency that a
    CUDA-event time of one small call holds. With `flush` (a tensor of
    64 MB or more), each call follows a write of it, so the L2 is cold;
    the write's own kernels are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_events(body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    skip = set()
    if flush is not None:
        skip = {e.name for e in device_events(flush.zero_)}

    def body():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()

    sums = {}
    for e in device_events(body):
        if e.name not in skip:
            us, n = sums.get(e.name, (0.0, 0))
            sums[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not sums:
        raise RuntimeError('torch.profiler recorded no device activity')
    return {name: (us / n, n) for name, (us, n) in sums.items()}


def main() -> None:
    """Check the kernel at the probe's shapes, then print the device
    durations of its kernel and of `torch.index_select` on the same
    inputs, cold (L2 written over before each call) and warm (calls back
    to back); both go to chiprun_out/gather_probe.json."""
    table, idx = probe_inputs('cuda')
    got = row_gather(table, idx)
    ok = torch.equal(got, row_gather_plain(table, idx))
    print(f'row_gather {tuple(table.shape)} x {T} indices: lowered, '
          f'bit-exact={ok}')
    if not ok:
        raise SystemExit(1)
    flush = torch.empty(16 * 2**20, dtype=torch.float32, device='cuda')
    lidx = idx.long()
    fns = {'row_gather': lambda: row_gather_cuda(table, idx),
           'index_select': lambda: torch.index_select(table, 0, lidx)}
    result = {}
    for label, fn in fns.items():
        for mode, f in (('cold', flush), ('warm', None)):
            result[f'{label} {mode}'] = kernel_us(fn, 50, f)
    for key, kernels in result.items():
        for name, (us, n) in kernels.items():
            print(f'[gather_probe] {key}: {us:.3f} us a launch over {n} '
                  f'launches of {name[:80]}')
    out = Path(__file__).resolve().parents[2] / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'gather_probe.json').write_text(json.dumps({
        'device': torch.cuda.get_device_name(0),
        'kernel_us': {k: {name: {'us': us, 'launches': n}
                          for name, (us, n) in v.items()}
                      for k, v in result.items()}}, indent=1))


if __name__ == '__main__':
    main()
