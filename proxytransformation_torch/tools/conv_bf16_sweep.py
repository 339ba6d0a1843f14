"""Time the bf16 sparse-conv kernel's launch shapes on a bf16 request's convs.

    python -m proxytransformation_torch.tools.conv_bf16_sweep   # one card

Captures the bf16 forward conv calls of one flagship request (B=2, full
width, seeded random weights, `compute_dtype='bfloat16'`), then times
each call's kernel (`csrc/sparse_conv_bf16.cu`, forward symbols) at every
launch shape it takes: output channels a block (64, 128, 256) and splits
of each tile's steps (1-16). Each call alone, a cold L2, the host's
launches hidden behind a spin. Prints, per conv class, the summed ms of
`ops/sparse.py::bf16_tile_launch`'s shapes, of each call at its fastest
shape, and of the fastest shapes every call of the class took, and
writes every time to chiprun_out/conv_bf16_sweep.json.

Then a dense probe: maps on which every row hits every offset, its rows
gathered in order or at random, 264 tiles (two waves of one block an
SM) of C = 64, 128, 256 with K3 = 27 and 8, beside torch.matmul of as
many rows: the kernel's rate with no offset skipped and no wave left
part-full, and (from the two K3) its cost a tile beside its cost a step.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import torch

from ..data.synthetic import flagship_batch
from ..device import full_float32
from ..models.detector import (SparseFeatureFusion3DGrounderPreshape,
                               batch_to_device)
from ..ops import _cuda
from ..ops import sparse as sp

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def capture_convs(model, batch):
    """The (x, nbr, w, mask, plan) of every bf16 forward conv call."""
    calls, launch = [], sp.sparse_conv_bf16_cuda

    def record(x, nbr, w, mask, plan=None, out_dtype=None):
        calls.append((x, nbr, w, mask, sp.conv_plan(nbr) if plan is None
                      else plan))
        return launch(x, nbr, w, mask, plan, out_dtype)

    sp.sparse_conv_bf16_cuda = record
    try:
        with torch.no_grad():
            model(batch)
    finally:
        sp.sparse_conv_bf16_cuda = launch
    return calls


def class_labels(model, n_calls):
    """Each bf16 call's conv class, in the order one request launches
    them: per stage its strided conv and its self convs, then the neck
    (the stem's float32 input keeps the float32 kernel)."""
    labels = []
    for i, n in enumerate(model.backbone_3d.stage_blocks):
        labels += [f'stage {i + 1} strided'] + [f'stage {i + 1} self'] * (
            2 * n - 1)
    return labels + ['neck'] * (n_calls - len(labels))


def cold_ms(fn, flush, reps=3):
    """Mean device ms of `fn` over `reps` samples, each after a 64 MB
    write (a cold L2) and behind a ~1 ms spin (the host's launches
    hidden), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def shapes(B, V, C_in, C_out, n_sm):
    """The rule's launch shape, then every other one the kernel takes."""
    rule = sp.bf16_tile_launch(B, V, C_in, C_out, n_sm)
    yield rule
    for bn in (64, 128, 256):
        if bn > max(64, C_out) or (rule.kc < 64 and bn > 64):
            continue
        stages, smem = sp.bf16_stage_shape(rule.kc, bn)
        for s in SPLITS:
            if (bn, s) != (rule.bn, rule.splits):
                yield sp.Bf16Launch(rule.kc, bn, stages, smem,
                                    -(-C_out // bn), s)


def dense_probe(flush, gen):
    """[dense] lines: ms and TFLOP/s of the kernel (bf16_tile_launch's
    shape) on all-hit maps, and of torch.matmul of the same rows."""
    dev = flush.device
    V = 2 * _cuda.sm_count(dev) * sp.BF16_TILE_ROWS
    v = torch.arange(V, device=dev)
    mask = torch.ones(1, V, dtype=torch.bool, device=dev)
    out = []
    for C, K3 in ((64, 27), (128, 27), (256, 27), (256, 8)):
        x = torch.randn(1, V, C, device=dev, generator=gen).bfloat16()
        w = (torch.randn(K3, C, C, device=dev, generator=gen) * 0.05
             ).bfloat16()
        flops = 2.0 * V * K3 * C * C
        for kind in ('in order', 'random'):
            nbr = (torch.stack([(v + k) % V for k in range(K3)], -1)
                   if kind == 'in order' else
                   torch.randint(0, V, (V, K3), device=dev, generator=gen))
            nbr = nbr[None].int().contiguous()
            plan = sp.conv_plan(nbr)
            ms = cold_ms(lambda: sp.sparse_conv_bf16_cuda(x, nbr, w, mask,
                                                          plan), flush)
            out.append(dict(C=C, K3=K3, rows=kind, ms=ms,
                            tflops=flops / ms / 1e9))
        a = torch.randn(V * K3, C, device=dev, generator=gen).bfloat16()
        ms = cold_ms(lambda: torch.matmul(a, w[0]), flush)
        out.append(dict(C=C, K3=K3, rows='torch.matmul', ms=ms,
                        tflops=flops / ms / 1e9))
    for r in out:
        print(f'[dense] V={V} C={r["C"]} K3={r["K3"]} {r["rows"]:12s} '
              f'{r["ms"]:.4f} ms, {r["tflops"]:.1f} TFLOP/s')
    return out


def main() -> None:
    dev = torch.device('cuda')
    n_sm = _cuda.sm_count(dev)
    with full_float32():
        model = SparseFeatureFusion3DGrounderPreshape(
            device=dev, compute_dtype='bfloat16',
            remat_painting=True).random_init_(0)
        calls = capture_convs(model, batch_to_device(flagship_batch(seed=0),
                                                     dev))
        labels = class_labels(model, len(calls))
        flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)
        rows = []
        for label, (x, nbr, w, mask, plan) in zip(labels, calls):
            B, _, C_in = x.shape
            V, C_out = nbr.shape[1], w.shape[-1]
            rule = sp.bf16_tile_launch(B, V, C_in, C_out, n_sm)
            times = {}
            for cut in shapes(B, V, C_in, C_out, n_sm):
                times[f'{cut.bn}/{cut.splits}'] = cold_ms(
                    lambda: sp._launch_conv_bf16(
                        sp.SPARSE_CONV_BF16, 0, x, nbr, w, mask, plan, None,
                        cut), flush)
            rows.append(dict(conv_class=label, V=V, C_in=C_in, C_out=C_out,
                             rule=f'{rule.bn}/{rule.splits}', ms=times))
    by_class = defaultdict(lambda: defaultdict(float))
    rule_ms, best_ms = defaultdict(float), defaultdict(float)
    shared = {}  # the shapes every call of a class was timed at
    for r in rows:
        label = r['conv_class']
        rule_ms[label] += r['ms'][r['rule']]
        best_ms[label] += min(r['ms'].values())
        shared[label] = shared.get(label, set(r['ms'])) & set(r['ms'])
        for k, v in r['ms'].items():
            by_class[label][k] += v
    print(f'[sweep] {torch.cuda.get_device_name(0)}; shapes as bn/splits')
    for label, ms in by_class.items():
        best = sorted(((k, ms[k]) for k in shared[label]),
                      key=lambda kv: kv[1])[:4]
        print(f'[sweep] {label:16s} rule {rule_ms[label]:.4f} ms, each '
              f'call at its fastest {best_ms[label]:.4f}; fastest shared '
              + ', '.join(f'{k} {v:.4f}' for k, v in best))
    print(f'[sweep] all classes: rule {sum(rule_ms.values()):.4f} ms, each '
          f'call at its fastest shape {sum(best_ms.values()):.4f} ms')
    with full_float32():
        dense = dense_probe(flush, torch.Generator(device=dev).manual_seed(0))
    out = Path(__file__).resolve().parents[2] / 'chiprun_out'
    out.mkdir(exist_ok=True)
    (out / 'conv_bf16_sweep.json').write_text(json.dumps(
        dict(calls=rows, dense=dense), indent=1))


if __name__ == '__main__':
    main()
