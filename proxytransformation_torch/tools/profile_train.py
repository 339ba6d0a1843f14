"""Profile one flagship train step on the card with torch.profiler.

    python -m proxytransformation_torch.tools.profile_train [--top 30]
        [--compute-dtype bfloat16]

The train-step counterpart of `profile_forward`: builds the flagship
grounder at full width with random weights (seed 0) and its AdamW
optimizer, takes one warm-up step, then traces one step (B=2, 100k
surface-scene points, 20 views at 480x480, 32 tokens, 8 gt boxes a
sample; batch and dropout seed 1). Prints the device time by kernel name,
the sparse conv's device time by role (forward, dfeats, dW) and the
ball query's and the lookups' by family, the
device's busy and idle share of the step's wall time (the union of
kernel intervals over the host-clock span of the step, which ends in a
synchronize), the launch count and the peak memory, and writes them to
chiprun_out/profile_train.json. Then one more step without the profiler
(seed 2), split by CUDA events into the loss forward, the backward and
the optimizer update, each with its host time. Fails when the profiler
recorded no device activity. `--compute-dtype bfloat16` profiles the
bf16 model (`remat_painting=True`) and writes profile_train_bfloat16.json.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..data.synthetic import flagship_batch
from ..device import full_float32
from ..engine.train import (BASE_LR, build_lr_schedule, build_optimizer,
                            make_train_step)
from ..models.detector import (SparseFeatureFusion3DGrounderPreshape,
                               batch_to_device)
from ..ops import _cuda
from .profile_forward import (CONV_ROLES, KERNEL_FAMILIES, _union_us,
                              json_suffix, model_kwargs, print_sums,
                              sum_by_tag)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--top', type=int, default=30)
    ap.add_argument('--compute-dtype', default='float32',
                    choices=('float32', 'bfloat16'))
    args = ap.parse_args()
    _cuda.build()
    model = SparseFeatureFusion3DGrounderPreshape(
        **model_kwargs(args.compute_dtype)).random_init_(0)
    opt = build_optimizer(model)
    schedule = build_lr_schedule(BASE_LR, steps_per_epoch=1)
    step = make_train_step(model, opt, schedule)

    def batch(seed):
        return batch_to_device(flagship_batch(seed=seed, with_targets=True),
                               'cuda')

    step(batch(0), torch.Generator(device='cuda').manual_seed(0))
    b1 = batch(1)
    gen = torch.Generator(device='cuda').manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step(b1, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    # device events, less the annotations the optimizer's `step` puts on
    # the device timeline: their span covers its kernels, it is not one
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)
               and not e.name.startswith('Optimizer.')]
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
    print(f'train step wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
          f'({100 * busy_ms / wall_ms:.1f} %), idle share '
          f'{1 - busy_ms / wall_ms:.3f}, {len(kernels)} kernel launches, '
          f'peak memory {peak:.2f} GiB, total_loss '
          f'{float(metrics["total_loss"]):.6f}')
    for ms, n, name in rows[:args.top]:
        print(f'{ms:9.3f} ms {100 * ms / kernel_ms:5.1f} % {n:6d}x  '
              f'{name[:110]}')
    roles = sum_by_tag(rows, CONV_ROLES)
    print_sums('sparse conv by role', roles)
    families = sum_by_tag(rows, KERNEL_FAMILIES)
    print_sums('point and key kernels', families)
    phases = phase_times(model, opt, schedule, batch(2),
                         torch.Generator(device='cuda').manual_seed(2))
    print('phases of one more step (device ms / host ms): ' + ', '.join(
        f'{k} {d:.1f} / {h:.1f}' for k, (d, h) in phases.items()))
    out = Path(__file__).resolve().parents[2] / 'chiprun_out'
    out.mkdir(exist_ok=True)
    path = out / f'profile_train{json_suffix(args.compute_dtype)}.json'
    path.write_text(json.dumps({
        'device': torch.cuda.get_device_name(0), 'wall_ms': wall_ms,
        'compute_dtype': args.compute_dtype,
        'busy_ms': busy_ms, 'idle_share': 1 - busy_ms / wall_ms,
        'launches': len(kernels), 'peak_gib': peak, 'phases_ms': phases,
        'sparse_conv_roles': roles, 'kernel_families': families,
        'kernels': [{'name': name, 'ms': ms, 'count': n}
                    for ms, n, name in rows]}, indent=1))


def phase_times(model, opt, schedule, batch, gen):
    """{phase: (device ms, host ms)} of one step: what
    `engine.train.make_train_step` does, with a CUDA event and a host
    clock reading between its three parts."""
    names = ('forward', 'backward', 'optimizer')
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    host = []
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with full_float32():
        host.append(time.perf_counter())
        events[0].record()
        losses = model.loss(batch, gen)
        total = sum(losses[k] for k in sorted(losses))
        events[1].record()
        host.append(time.perf_counter())
        total.backward()
        events[2].record()
        host.append(time.perf_counter())
        opt.step(schedule)
        events[3].record()
        host.append(time.perf_counter())
    torch.cuda.synchronize()
    return {n: (events[i].elapsed_time(events[i + 1]),
                (host[i + 1] - host[i]) * 1e3) for i, n in enumerate(names)}


if __name__ == '__main__':
    main()
