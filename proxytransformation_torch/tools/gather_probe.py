"""Row-gather probe on the card: `table[idx]` through `csrc/row_gather.cu`.

    python -m proxytransformation_torch.tools.gather_probe

Counterpart of tools/exp_pallas_gather.py, which probed whether Mosaic
lowers an in-VMEM row gather on the TPU. On the card a gather is a plain
indexed load; this tool runs the hand-written kernel at the probe's
shapes (a (14336, 64) float32 table, 256 int32 indices, numpy seed 0) and
checks it bit for bit against `table[idx]`.
"""
from __future__ import annotations

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
    """Launch `csrc/row_gather.cu`; returns (len(idx), C) float32."""
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


def main() -> None:
    table, idx = probe_inputs('cuda')
    got = row_gather(table, idx)
    ok = torch.equal(got, row_gather_plain(table, idx))
    print(f'row_gather {tuple(table.shape)} x {T} indices: lowered, '
          f'bit-exact={ok}')
    if not ok:
        raise SystemExit(1)


if __name__ == '__main__':
    main()
