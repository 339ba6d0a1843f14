"""Profile flagship predict requests on the card with torch.profiler.

    python -m proxytransformation_torch.tools.profile_forward [--top 25]
        [--compute-dtype bfloat16]

Builds the flagship grounder at full width with random weights (seed 0),
warms up, then traces one request (B=2, 100k surface-scene points, 20
views at 480x480, 32 tokens). Prints the device time by kernel name and
the device's busy and idle share of the request's wall time (the union
of kernel intervals over the host-clock span of the request, which ends
in a synchronize), and writes both to chiprun_out/profile_forward.json.
The sparse conv's kernels are also summed by role (forward, input
gradient, weight gradient, each in float32 and in bf16: `csrc/sparse_conv.cu`,
`csrc/sparse_conv_dw.cu` and `csrc/sparse_conv_bf16.cu` give each its own
kernel symbols), and the ball query's (head and tail passes) and the
lookups' kernels by family. `--compute-dtype bfloat16` profiles the bf16
model (`remat_painting=True`) and writes profile_forward_bfloat16.json.
Fails when the profiler recorded no device activity.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..data.synthetic import flagship_batch
from ..models.detector import (SparseFeatureFusion3DGrounderPreshape,
                               batch_to_device)
from ..ops import _cuda


# patterns of the kernel symbols of each sparse-conv role
CONV_ROLES = (('forward', r'sparse_conv_fwd_(?!bf16)'),
              ('dfeats', r'sparse_conv_dfeats_(?!bf16)'),
              ('dW', r'sparse_conv_dw_(?!bf16)'),
              ('forward bf16', r'sparse_conv_fwd_bf16_'),
              ('dfeats bf16', r'sparse_conv_dfeats_bf16_'),
              ('dW bf16', r'sparse_conv_dw_bf16_'),
              # of which the split sums (offsets with more than one split)
              ('dW bf16 split sum', r'sparse_conv_dw_bf16_sum'))


# patterns of the kernel symbols of the ball query (its head and tail
# passes) and of the two lookups
KERNEL_FAMILIES = (('ball_query', 'ball_query_'),
                   ('lookup_pmz', 'lookup_pmz_'),
                   ('lookup_center', 'lookup_center_'))


def sum_by_tag(rows, tags):
    """{label: (device ms, launches)} of the kernels whose symbol matches
    each (label, pattern)'s pattern, from the (ms, count, name) rows of a
    profile."""
    return {label: (sum(ms for ms, _, name in rows if re.search(tag, name)),
                    sum(n for _, n, name in rows if re.search(tag, name)))
            for label, tag in tags}


def print_sums(title, sums) -> None:
    print(f'{title}: ' + ', '.join(f'{label} {ms:.3f} ms ({n} launches)'
                                   for label, (ms, n) in sums.items()))


def _union_us(intervals):
    total, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def model_kwargs(compute_dtype: str) -> dict:
    """The flagship's bf16 mode is `--amp`: bfloat16 with the painting
    rematerialized."""
    if compute_dtype == 'float32':
        return {}
    return dict(compute_dtype=compute_dtype, remat_painting=True)


def json_suffix(compute_dtype: str) -> str:
    return '' if compute_dtype == 'float32' else f'_{compute_dtype}'


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--compute-dtype', default='float32',
                    choices=('float32', 'bfloat16'))
    args = ap.parse_args()
    _cuda.build()
    model = SparseFeatureFusion3DGrounderPreshape(
        **model_kwargs(args.compute_dtype)).random_init_(0)
    batch = batch_to_device(flagship_batch(seed=0), 'cuda')
    for _ in range(2):
        model(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError('torch.profiler recorded no device activity')
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3
    rows = sorted(((ms, n, name) for name, (ms, n) in by_name.items()),
                  reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    print(f'request wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
          f'({100 * busy_ms / wall_ms:.1f} %), idle share '
          f'{1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernel launches')
    for ms, n, name in rows[:args.top]:
        print(f'{ms:9.3f} ms {100 * ms / kernel_ms:5.1f} % {n:6d}x  '
              f'{name[:110]}')
    roles = sum_by_tag(rows, CONV_ROLES)
    print_sums('sparse conv by role', roles)
    families = sum_by_tag(rows, KERNEL_FAMILIES)
    print_sums('point and key kernels', families)
    out = Path(__file__).resolve().parents[2] / 'chiprun_out'
    out.mkdir(exist_ok=True)
    path = out / f'profile_forward{json_suffix(args.compute_dtype)}.json'
    path.write_text(json.dumps({
        'device': torch.cuda.get_device_name(0), 'wall_ms': wall_ms,
        'compute_dtype': args.compute_dtype,
        'busy_ms': busy_ms, 'idle_share': 1 - busy_ms / wall_ms,
        'launches': len(kernels), 'sparse_conv_roles': roles,
        'kernel_families': families,
        'kernels': [{'name': name, 'ms': ms, 'count': n}
                    for ms, n, name in rows]}, indent=1))


if __name__ == '__main__':
    main()
