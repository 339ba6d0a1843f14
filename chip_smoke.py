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
     no-remat bf16 step;
 13. the EmbodiedScan data path: every fixture of
     `tests/torch_port_images/` (JPEG baseline and progressive, Adobe RGB,
     CMYK, YCCK, the EXIF orientations, PNG of every form, PGM and PPM)
     decoded by the port's host decoder to the sha256 cv2 recorded in its
     manifest (and the decode of one 640x480 JPEG and one 640x480 16-bit
     PNG timed); a temporary EmbodiedScan tree of three sources written
     from the fixture views (a ScanNet scan, a Matterport scan with depth
     in quarter millimetres for its shift of 4000, and a 3RScan scan of
     960x540 JPEG color and 224x172 16-bit PGM depth frames with a
     `depth_cam2img` of its own; 50 view entries each with distinct
     poses, 4 boxes each, a vg json with unique, hard and multi-target
     utterances); the flagship config, as it is but for --amp, the data
     root and file names, the EMA hook (`custom_hooks`) and the batch and
     epoch counts, through `tools/train.py main(argv)`: two B=2 steps at
     20 views from the files (every scan in them), a checkpoint, val at
     50 ordered views (the Matterport and the 3RScan scan); every kernel
     call of both steps held against its plain version; the checkpoint's
     EMA weights equal the runner's and restore bit for bit; val and then
     `tools/test.py` on the checkpoint ran on the EMA weights.
     `[realdata]` lines: s/it, data wait, first wait, peak memory, and
     one train sample's host pipeline by stage, for a 3RScan sample too
     with the PGM frame's decode ms;
 14. detection pretraining on phase 13's tree: the detection config
     (`configs/detection/embodied-det3d-resnet50.py`: 284 classes, 100k
     points, MinkResNet-34, ResNet-50 at base 16, head 128, prune 1000,
     its train pipeline at 20 views of 480x480, float32, B=4) as it is
     but for the data root, the ann files (the train scans listed four
     times: two steps) and a val loader, which the config lacks (the val
     split through the train pipeline without its two random
     augmentations), through `tools/train.py main(argv)`: two steps, a
     checkpoint (held against the runner's state), val with the batched
     3D NMS and IndoorDetMetric; every kernel call of the first step held
     against its plain version (no ball query and no bf16 kernel may
     run); a bare step on the first batch timed; then `tools/test.py` on
     the checkpoint. `[detection]` lines: s/it, data wait, first wait,
     peak memory, the bare step's device time, the losses, val's NMS ms
     and metric keys, and each kernel's calls, ms and launches;
 15. occupancy: `configs/occupancy/embodied-occ.py` as it is (40x40x16
     voxels over 6.4 x 6.4 x 2.56 m, 81 classes, ResNet-50 at base 16,
     neck 128, AdamW lr 1e-4, weight decay 1e-2, clip 35, float32) with
     loaders by --cfg-options (the config has none):
     `SyntheticOccupancyDataset` at 100k points, 20 views of 480x480 and
     2048 occupied voxels of 25,600, B=2, the prefetch thread; through
     `tools/train.py main(argv)`: two steps, val with OccupancyMetric, a
     checkpoint (held against the runner's state), then `tools/test.py`
     on it; no kernel of `csrc/` may launch (occupancy runs no TPU
     kernel); the tiny predictors on the card against the CPU; then
     `DenseFusionOccPredictor` (by `model.type`) for one step and one
     request. `[occupancy]` lines: s/it, data wait, a bare step's and a
     request's CUDA-event ms, peak memory, the losses, the metric's keys;
 16. grounding TTA: `tools/test.py --tta` on phase 13's checkpoint and
     tree (50 ordered views, the default tta_cfg: scale 1 with and
     without a horizontal flip, two copies stacked into one forward);
     every kernel call of its first batch held against its plain version;
     its time beside phase 13's test without TTA, the merged
     predictions' keys;
 17. the baseline grounder: the flagship's model config with
     `type='SparseFeatureFusion3DGrounder'` and no preshape block at full
     width, flax's fresh weights: from launch counts of 0 three float32
     requests on `flagship_batch` (B=2, 100k points, 20 views) and one
     AdamW step; every kernel call of the first request and of the step
     held against its plain version; no ball query (that is the
     preshape's); request ms beside phase 5's flagship requests;
 18. the text towers, MinkResNet-50 and the brick stages (float32, TF32
     off): (a) the flagship's model config with t_type='roberta-base'
     (768 x 12 layers, vocabulary 50265, 514 positions), flax's fresh
     weights, from launch counts of 0 three requests on `flagship_batch`
     (two timed with their peak memory, the third's kernel calls
     checked), its text stage's device ms beside phase 5's CLIP tower
     (`[roberta]`); (b) every tower family at its published size alone
     on B=2, L=32 ids within its vocabulary: shape, finiteness, CUDA-
     event ms, the base sizes against the same weights on the CPU within
     1e-4 · (1 + max) (`[towers]`); (c) MinkResNet-50 with the instance-
     norm and the batch-norm stem beside MinkResNet-34 on the flagship's
     voxelized points (`[mink50]`) and (d) MinkResNet-34 with brick
     stages (0,) and (0, 1) beside the cell format (the stage outputs
     within tests/test_brick.py's 1e-3; `[brick]`), each forward timed
     twice and captured once, every kernel call of the depth-50 and the
     brick forwards checked (the 8C-wide brick convs: 512 and 1024);
 19. data parallelism (`[dp]`), every rank a process of
     `python -m torch.distributed.run`: (a) the float32 flagship step at
     global B=4 on one process twice (the card's run-to-run distance),
     then on two gloo ranks sharing the card, B=2 each, from the same
     weights and global dropout draws (`python3 chip_smoke.py --dp-step
     DIR` is the rank): losses, grad_norm and the largest parameter
     difference to the one-process step, both ranks' parameters equal,
     every kernel call of rank 0's step checked; (b) the flagship config
     through `tools/train.py --launcher pytorch --amp` on the two ranks
     at host batch 4 (an epoch of 2 steps, val, a checkpoint, `--resume
     auto` for a second), then `tools/test.py --launcher pytorch` with
     val_results.json equal to one process's; (c) one NCCL rank through
     the train CLI, then again through `--launcher slurm` as the one task
     of a one-node SLURM step (the variables srun sets, MASTER_PORT): its
     context equal to torchrun's, its first step to the `--launcher
     pytorch` run's; (d) s/it beside one process, the gradient
     all-reduce's bytes and ms, the norm collectives' count and ms, each
     rank's peak memory. Gloo stages through the host and the ranks share
     one card: not NCCL across cards; (e) occupancy: the full occupancy
     config through `tools/train.py` at host batch 4 (2 steps, val one
     scene a batch) on one process, then inside the same two ranks as
     (a) (`--launcher pytorch` in the group they hold): the first step's
     losses' relative gap, the largest parameter and running-statistic
     difference to the one-process step, both ranks' parameters equal,
     s/it on 2 ranks beside 1, each rank's peak memory, val_results
     beside one process's; no kernel of csrc/ may launch;
 20. the library (`[library]`): the structures and models/misc.py
     modules on the card at realistic sizes against the same call on the
     CPU: `points_in_boxes` of 100k points in 64 boxes (a mask that
     differs only at points within 1e-5 m of a face), `EulerBoxes.
     overlaps` of 256 x 256 boxes (within 1e-4), `TransformerEncoder` at
     its defaults on (2, 4096, 256) tokens with a padding mask and
     `ChannelMapper` on the flagship's four MinkResNet-34 levels (within
     1e-4 · (1 + max)), each with its CUDA-event ms; and
     `utils/timing.py::chained_ms_per_iter` of a flagship request beside
     phase 5's request ms;
 21. the visualizer and the explorer (`[viz]`, run inside phase 13's
     block, on its tree): whether matplotlib and open3d are installed
     (their versions); the visualizer's NMS (`_nms_filter`, IoU 0.15) of
     one flagship request's 256 boxes on the card against the CPU (equal
     keeps but for boxes with an IoU within 1e-5 of 0.15, counted; CUDA-
     event ms), the kept boxes' corners within 1e-5 · (1 + max);
     `ContinuousDrawer.step` x 50 on 640x480 RGB-D views made from the
     two fixture views under 50 poses, on the card against the CPU (each
     step's new points within one float32 step; boxes, labels and view
     index equal; ms a step; the back-projection's CUDA-event ms; the
     final cloud's points); the explorer on phase 13's tree (an infos pkl
     with absolute paths, 4 views a scan): listings equal,
     `show_image(render_box=True)`'s sha256 equal on the card and the
     CPU, and `render_continuous_scene`'s headless frames, PNG where
     matplotlib is installed, else each frame's cloud through
     `export_ply` and its boxes through `LineMesh.save_ply` (the card's
     files against the CPU's: PNGs of the same size, PLY lines equal but
     for a coordinate's last printed digit);
 22. the 2D ResNet past depth 50 and below it (`[resnet101]`,
     `[resnet occ]`): (a) the flagship config with
     `model.backbone.depth=101` at full width, flax's fresh weights: from
     launch counts of 0 three float32 requests on `flagship_batch` (the
     first captured, 2 and 3 timed, then the stages of one more), then
     from 0 one bf16 remat AdamW step (`--amp` on the config's remat)
     captured; every kernel call of the first request and of the step
     held against its plain version; request ms, the 2D stage's device
     ms and peak memory beside phase 5's ResNet-50; (b) the occupancy
     config with `model.backbone.depth` 18, then 34, through
     `tools/train.py` on phase 15's synthetic sets (one B=2 step, no
     val), then one request on the step's batch on the card and, from
     the same weights, on the CPU: logits within 1e-4 · (1 + max), the
     labels equal wherever the top two logits are over twice the largest
     logit difference apart; no kernel of csrc/ may launch.
Every phase's lines also go to chiprun_out/chip_smoke.log. Then one
`[conv]` line per sparse-conv kernel (forward, dfeats, dW, and
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
first run and their times those of its first step's calls, and
`<kernel>:realdata` phase 13's, `<kernel>:detection` phase 14's,
`<kernel>:tta` phase 16's (its first batch's calls) and
`<kernel>:baseline` phase 17's (launches: three requests and the step;
times: the first request's and the step's calls), `<kernel>:roberta`
phase 18a's (launches: three requests; times: the third's calls),
`<kernel>:mink50` and `<kernel>:brick` phase 18c's and 18d's (launches:
the two depth-50 or the two brick models' three forwards each; times:
one forward of each), `<kernel>:dp` phase 19a's (launches and times:
rank 0's first data-parallel step), `<kernel>:resnet101` phase 22a's
(launches: three requests and the step; times: the first request's and
the step's calls) in the same way); the last line is
{"ok": true, "device": {...}}. Per-call details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
import types
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
CONV_RTOL = 1e-4


LOG_PATH = Path(__file__).resolve().parent / 'chiprun_out' / 'chip_smoke.log'


def log(msg: str) -> None:
    """Print a line, and keep it in chiprun_out/chip_smoke.log (the whole
    run's lines, where the end of the output holds only the last ones)."""
    print(msg, flush=True)
    LOG_PATH.parent.mkdir(exist_ok=True)
    with open(LOG_PATH, 'a') as f:
        f.write(msg + '\n')


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
    LOG_PATH.unlink(missing_ok=True)
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

    # 13. the EmbodiedScan data path: the flagship from JPEG / PNG files;
    # 14. detection pretraining on the same files
    data_root = Path(tempfile.mkdtemp(prefix='chip_smoke_embodiedscan_'))
    try:
        realdata = data_path_phases(smi, data_root)
        detection = detection_phases(smi, data_root, realdata['names'])
        # 15. occupancy through the CLIs
        occupancy = occupancy_phases(smi)
        # 16. grounding TTA on phase 13's checkpoint and tree
        tta = tta_phases(smi, data_root, realdata)
        # 21. the visualizer and the explorer, the latter on the same tree
        viz = viz_phase(smi, data_root)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
        shutil.rmtree(REALDATA_WORK, ignore_errors=True)

    # 17. the baseline grounder
    baseline = baseline_phases(smi, predict['req_ms'])

    # 18. the text towers, MinkResNet-50 and the brick stages
    slice13 = slice13_phases(smi, predict['req_ms'],
                             predict['stages']['text_encoder'])

    # 19. data parallelism: ranks in processes of their own
    dp = dp_phases(smi)

    # 20. the structures and models/misc.py modules
    library = library_phase(smi, predict['req_ms'])

    # 22. the 2D ResNet at depth 101 through the grounder, 18 and 34
    # through the occupancy predictor
    resnet = resnet_depth_phases(smi, predict)

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
    for phase, out, names in (('runner', runner, RUNNER_KERNELS),
                              ('realdata', realdata, RUNNER_KERNELS),
                              ('detection', detection, DETECTION_KERNELS),
                              ('tta', tta, PREDICT_KERNELS),
                              ('baseline', baseline, BASELINE_KERNELS),
                              ('roberta', slice13['roberta'],
                               PREDICT_KERNELS),
                              ('mink50', slice13['mink50'], MINK_KERNELS),
                              ('brick', slice13['brick'], MINK_KERNELS),
                              ('dp', dp, DP_KERNELS),
                              ('resnet101', resnet, RUNNER_KERNELS)):
        for name in names:
            entry = summarize(name, out['rows'][name], out['counts'][name],
                              out['per_step'].get(name, 0))
            entry['name'] = f'{name}:{phase}'
            kernels.append(entry)
    for e in kernels:
        phase = e['name'].partition(':')[2]
        if phase in ('detection', 'tta', 'baseline', 'roberta', 'mink50',
                     'brick', 'dp', 'resnet101'):
            log(f'[{phase}] kernels line: {e["name"]} {e["wrapper_calls"]} '
                f'calls in the run ({e["launches"]} launches), '
                f'{e["calls_checked"]} checked summing {e["ms"]:.3f} ms '
                f'(plain {e["plain_ms"]:.3f} ms, bound {e["bound_ms"]:.4f} '
                f'ms), max abs err {e["max_abs_err"]:.3g}')
    log(f'[kernel] timings the spin could not hide host time from: '
        f'{NOT_HIDDEN}')
    detail = {'device': smi, 'torch': torch.__version__,
              'request_ms': predict['req_ms'], 'peak_gib': predict['peak'],
              'stage_ms': predict['stages'], 'train': train['summary'],
              'bf16': bf16['summary'], 'runner': runner['summary'],
              'runner_step_calls': runner['rows'],
              'realdata': realdata['summary'],
              'realdata_step_calls': realdata['rows'],
              'detection': detection['summary'],
              'detection_step_calls': detection['rows'],
              'occupancy': occupancy, 'tta': tta['summary'],
              'tta_batch_calls': tta['rows'],
              'baseline': baseline['summary'],
              'baseline_calls': baseline['rows'],
              'roberta': slice13['roberta']['summary'],
              'roberta_calls': slice13['roberta']['rows'],
              'towers': slice13['towers'],
              'mink50': slice13['mink50']['summary'],
              'mink50_calls': slice13['mink50']['rows'],
              'brick': slice13['brick']['summary'],
              'brick_calls': slice13['brick']['rows'],
              'dp': dp['summary'], 'dp_step_calls': dp['rows'],
              'library': library, 'viz': viz,
              'resnet101': resnet['summary'],
              'resnet101_calls': resnet['rows'],
              'resnet_occupancy': resnet['occupancy'],
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
                resume: bool = False, batch_size: int = 2,
                flags=(), options=()):
    """The train CLI's arguments for phase 12: the flagship config with
    --amp, its datasets swapped for full-scale synthetic ones (two steps
    an epoch at `batch_size`); phase 19 adds its `flags` and `options`."""
    ds = dict(type='SyntheticGroundingDataset', n_points=100_000,
              n_views=20, img_size=480)
    root = Path(__file__).resolve().parent
    return ([str(root / FLAGSHIP_CONFIG), '--amp', '--work-dir', str(work)]
            + (['--resume', 'auto'] if resume else []) + list(flags)
            + ['--cfg-options',
               f'train_dataloader.dataset={dict(ds, length=2 * batch_size)!r}',
               'val_dataloader.dataset='
               f'{dict(ds, length=2, test_mode=True)!r}',
               f'train_dataloader.batch_size={batch_size}',
               f'train_dataloader.num_workers={workers}',
               'val_dataloader.num_workers=0',
               f'train_cfg.max_epochs={max_epochs}', 'train_cfg.val_interval=1',
               'log_interval=1', *options])


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


@contextmanager
def capturing_first_step(first, steps: int = 1):
    """While open, the Runner's train step records the kernel calls of its
    first call into `first['calls']` (and its batch into
    `first['batch']`), and those of its next `steps - 1` calls into the
    list `first['more']`."""
    from proxytransformation_torch.engine import runner as runner_mod
    make_train_step = runner_mod.make_train_step
    first['more'] = []

    def capturing_make_train_step(model, optimizer, schedule=None):
        step = make_train_step(model, optimizer, schedule)

        def train_step(batch, generator=None):
            if 'calls' in first and len(first['more']) >= steps - 1:
                return step(batch, generator)
            out = {}
            calls = capture_kernel_calls(
                lambda: out.update(step(batch, generator)))
            if 'calls' in first:
                first['more'].append(calls)
            else:
                first['batch'], first['calls'] = batch, calls
            return out
        return train_step

    runner_mod.make_train_step = capturing_make_train_step
    try:
        yield
    finally:
        runner_mod.make_train_step = make_train_step


def runner_state(runner):
    return {'model': runner.model.state_dict(),
            'optimizer': runner.optimizer.state_dict(),
            'generator': runner.generator.get_state(),
            'step': runner.global_step}


def runner_phases(bf16_summary):
    """Phase 12: the flagship through `tools/train.py main(argv)` with
    --amp and remat, two steps, a checkpoint and val; the first step's
    kernel calls checked; then --resume auto for one more epoch."""
    from proxytransformation_torch.engine import runner as runner_mod
    from proxytransformation_torch.engine.checkpoint import (
        latest_checkpoint, load_checkpoint)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import train as train_cli
    work = Path(__file__).resolve().parent / 'build' / 'chip_smoke_runner'
    shutil.rmtree(work, ignore_errors=True)
    first = {}
    with capturing_first_step(first):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(runner_argv(work, 1, 0))
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
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
    bare = runner_mod.make_train_step(model, runner.optimizer,
                                      runner.schedule)
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


FIXTURES = 'tests/torch_port_images'
# phase 13's work dir: its checkpoint is phase 16's
REALDATA_WORK = Path(__file__).resolve().parent / 'build' / \
    'chip_smoke_realdata'
MATTERPORT_SCAN = 'matterport3d/1mp3d_0000/region0'
RSCAN_SCAN = '3rscan/0cac7578-8d6f-2d13-8c2d-bfa7a04f8af3'
REALDATA_CLASSES = ('cabinet', 'bed', 'chair', 'table')
N_SCAN_VIEWS = 50


def write_embodiedscan_tree(root: Path, fixtures: Path) -> dict:
    """A three-source EmbodiedScan tree from the fixture views: infos pkls,
    vg jsons and, per scan, 50 view entries cycling through its views
    with distinct poses (2 mm apart along x). The ScanNet scan keeps the
    depth in millimetres (shift 1000); the Matterport scan holds it in
    quarter millimetres, its shift being 4000, and its axis alignment is a
    translation (its boxes are moved by it); the 3RScan scan reads
    `sequence/frame-000000.color.jpg` (960x540) and `.depth.pgm` (224x172,
    16-bit, shift 1000) through a `depth_cam2img` of its own. Train: the
    ScanNet and Matterport scans one utterance each, the 3RScan scan two
    (two steps at B=2); val and test: the Matterport and the 3RScan scan.
    Returns the file names."""
    import pickle
    from proxytransformation_torch.data.image_io import imread, write_png
    manifest = json.loads((fixtures / 'manifest.json').read_text())
    cam2img = np.asarray(manifest['cam2img'], np.float64)
    boxes = [list(b) for b in manifest['boxes']]
    boxes.append([0.6, 0.9, 0.4, 1.2, 0.7, 0.8, 0.0, 0.0, 0.0])  # a table
    align = {'scannet/scene0000_00': np.eye(4), MATTERPORT_SCAN: np.eye(4),
             RSCAN_SCAN: np.eye(4)}
    align[MATTERPORT_SCAN][:3, 3] = [0.5, -0.3, 0.0]
    scans = {}
    for scan_id, m in align.items():
        if scan_id == RSCAN_SCAN:
            rscan = manifest['rscan']
            scan_dir = root / scan_id / 'sequence'
            scan_dir.mkdir(parents=True)
            shutil.copy(fixtures / rscan['image'],
                        scan_dir / 'frame-000000.color.jpg')
            shutil.copy(fixtures / rscan['depth'],
                        scan_dir / 'frame-000000.depth.pgm')
            views = [('frame-000000.color.jpg', 'frame-000000.depth.pgm',
                      rscan['cam2global'])]
            cams = (np.asarray(rscan['cam2img'], np.float64),
                    np.asarray(rscan['depth_cam2img'], np.float64))
        else:
            scan_dir = root / 'posed_images' / scan_id.replace('/', '_')
            scan_dir.mkdir(parents=True)
            views = []
            for k, view in enumerate(manifest['views']):
                shutil.copy(fixtures / view['image'],
                            scan_dir / f'view{k}.jpg')
                if scan_id == MATTERPORT_SCAN:
                    write_png(scan_dir / f'depth{k}.png',
                              imread(str(fixtures / view['depth']), -1) * 4)
                else:
                    shutil.copy(fixtures / view['depth'],
                                scan_dir / f'depth{k}.png')
                views.append((f'view{k}.jpg', f'depth{k}.png',
                              view['cam2global']))
            cams = (cam2img, cam2img)
        images = []
        rel = scan_dir.relative_to(root)
        for i in range(N_SCAN_VIEWS):
            image, depth, pose = views[i % len(views)]
            pose = np.asarray(pose, np.float64)
            pose[0, 3] += 0.002 * i
            images.append({'img_path': str(rel / image),
                           'depth_path': str(rel / depth),
                           'cam2global': pose})
        aligned = [list(np.add(b[:3], m[:3, 3])) + b[3:] for b in boxes]
        scans[scan_id] = {
            'sample_idx': scan_id, 'axis_align_matrix': m,
            'cam2img': cams[0], 'depth_cam2img': cams[1], 'images': images,
            'instances': [{'bbox_3d': b, 'bbox_label_3d': j + 1,
                           'bbox_id': j} for j, b in enumerate(aligned)]}
    categories = {c: j + 1 for j, c in enumerate(REALDATA_CLASSES)}

    def utterances(scan_id, n):
        both = [
            {'scan_id': scan_id, 'text': 'the chair next to the bed',
             'target_id': 2, 'distractor_ids': [],
             'tokens_positive': [[4, 9]]},                     # unique
            {'scan_id': scan_id, 'text': 'the cabinet and the table',
             'target_id': [0, 3], 'distractor_ids': [1, 2, 5, 6],
             'tokens_positive': [[4, 11], [20, 25]]},          # multi, hard
            {'scan_id': scan_id, 'text': 'the bed facing the chair',
             'target_id': 1, 'distractor_ids': [4],
             'tokens_positive': [[4, 7]]}]
        return both[:n]

    per_split = {'train': {'scannet/scene0000_00': 1, MATTERPORT_SCAN: 1,
                           RSCAN_SCAN: 2},
                 'val': {MATTERPORT_SCAN: 1, RSCAN_SCAN: 1}}
    names = {}
    for split, counts in per_split.items():
        infos = {'metainfo': {'categories': categories},
                 'data_list': list(scans.values())}
        names[split] = (f'embodiedscan_infos_{split}.pkl',
                        f'embodiedscan_{split}_vg.json')
        with open(root / names[split][0], 'wb') as f:
            pickle.dump(infos, f)
        vg = [u for scan_id, n in counts.items()
              for u in utterances(scan_id, n)]
        (root / names[split][1]).write_text(json.dumps(vg))
    return names


def realdata_argv(config: Path, work: Path, root: Path, names: dict,
                  checkpoint: str = None):
    """The train CLI's arguments for phase 13 (with --amp), or the test
    CLI's for `checkpoint`: the flagship config with the data root and
    file names of the tree, the EMA hook, B=2 and one epoch."""
    ema = [dict(type='EMAHook', ema_type='ExpMomentumEMA', momentum=0.0002,
                gamma=2000)]
    opts = [f'custom_hooks={ema!r}']
    loaders = ((('test_dataloader.dataset', 'val'), ) if checkpoint else
               (('train_dataloader.dataset.dataset', 'train'),
                ('val_dataloader.dataset', 'val')))
    for key, split in loaders:
        opts += [f'{key}.data_root={str(root) + "/"!r}',
                 f'{key}.ann_file={names[split][0]!r}',
                 f'{key}.vg_file={names[split][1]!r}']
    if not checkpoint:
        opts += ['train_dataloader.batch_size=2', 'train_cfg.max_epochs=1',
                 'train_cfg.val_interval=1', 'log_interval=1']
    return ([str(config), checkpoint or '--amp', '--work-dir', str(work),
             '--cfg-options', *opts])


def decode_check(fixtures: Path):
    """Each fixture decoded to the digest cv2 recorded; decode ms of one
    640x480 JPEG and one 640x480 16-bit PNG (median of 10)."""
    import hashlib
    from proxytransformation_torch.data import image_io
    t0 = time.perf_counter()
    image_io.build()
    build_s = time.perf_counter() - t0
    manifest = json.loads((fixtures / 'manifest.json').read_text())
    for f in manifest['files']:
        flag = (image_io.IMREAD_COLOR if f['flags'] == 'IMREAD_COLOR'
                else image_io.IMREAD_UNCHANGED)
        img = image_io.imread(str(fixtures / f['name']), flag)
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        require(got == f['sha256'] and list(img.shape) == f['shape']
                and str(img.dtype) == f['dtype'],
                f'{f["name"]}: decoded array differs from cv2\'s')
    ms = {kind: decode_ms(fixtures / name, image_io.IMREAD_UNCHANGED)
          for kind, name in (('jpeg', 'view0_640x480.jpg'),
                             ('png', 'depth0_640x480.png'))}
    return len(manifest['files']), build_s, ms


def decode_ms(path: Path, flag: int) -> float:
    """ms of the host decode of one image file (median of 10)."""
    from proxytransformation_torch.data import image_io
    data = path.read_bytes()
    t = []
    for _ in range(10):
        t0 = time.perf_counter()
        image_io.decode(data, flag)
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def host_pipeline_breakdown(root: Path, names: dict, pipeline, n: int = 3,
                            scan: str = None):
    """ms of one train sample's host pipeline by stage (the median of `n`
    samples after a warm one) and the last sample: of `scan`'s samples,
    or without it of the 640x480 scans' (ScanNet, Matterport)."""
    from proxytransformation_torch.data import image_io
    from proxytransformation_torch.data import transforms as tf
    from proxytransformation_torch.data.dataset import (
        MultiView3DGroundingDataset)
    spent = {}
    patches = [
        (image_io, 'decode_jpeg', 'jpeg decode'),
        (image_io, 'decode_png', 'png decode'),
        (image_io, 'decode_pnm', 'pgm decode'),
        (tf, 'depth_to_points', 'depth to points'),
        (tf, 'resize_bilinear_u8', 'resize'),
        (tf.PointSample, '__call__', 'point sampling'),
        (tf.AggregateMultiViewPoints, '__call__', 'aggregation'),
        (tf.GlobalRotScaleTrans, '__call__', 'augmentation'),
        (tf.Pack3DDetInputs, '__call__', 'packing')]
    originals = [getattr(obj, attr) for obj, attr, _ in patches]

    def timed(fn, label):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
        return wrapper

    for (obj, attr, label), fn in zip(patches, originals):
        setattr(obj, attr, timed(fn, label))
    try:
        ds = MultiView3DGroundingDataset(
            data_root=str(root) + '/', ann_file=names['train'][0],
            vg_file=names['train'][1], pipeline=pipeline)
        picks = [i for i, d in enumerate(ds.data_list)
                 if d['scan_id'] == scan
                 or (scan is None and d['scan_id'] != RSCAN_SCAN)]
        require(bool(picks), f'no sample of {scan}')
        rows = []
        for i in range(n + 1):
            spent.clear()
            t0 = time.perf_counter()
            sample = ds[picks[i % len(picks)]]
            total = time.perf_counter() - t0
            row = {k: v * 1e3 for k, v in spent.items()}
            row['other'] = total * 1e3 - sum(row.values())
            row['total'] = total * 1e3
            rows.append(row)
    finally:
        for (obj, attr, _), fn in zip(patches, originals):
            setattr(obj, attr, fn)
    stages = {k: float(np.median([r.get(k, 0.0) for r in rows[1:]]))
              for k in rows[1]}
    return stages, sample


def rscan_decode_ms(fixtures: Path) -> dict:
    """ms of the host decode of the 3RScan fixture frame: its 224x172
    16-bit PGM depth and its 960x540 JPEG color (median of 10 each)."""
    from proxytransformation_torch.data import image_io
    rscan = json.loads((fixtures / 'manifest.json').read_text())['rscan']
    return {'pgm': decode_ms(fixtures / rscan['depth'],
                             image_io.IMREAD_UNCHANGED),
            'jpeg': decode_ms(fixtures / rscan['image'],
                              image_io.IMREAD_COLOR)}


def data_path_phases(smi, data_root: Path):
    """Phase 13: the flagship config from a tree of JPEG / PNG views
    written into `data_root` (and left there for phase 14), with the EMA
    hook: decode check, train, val and test through the CLIs, the first
    step's kernel calls checked, the EMA checkpoint checked."""
    from proxytransformation_torch.data.preprocessor import (
        Det3DDataPreprocessor)
    from proxytransformation_torch.engine import runner as runner_mod
    from proxytransformation_torch.engine.checkpoint import (
        latest_checkpoint, load_checkpoint)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import test as test_cli
    from proxytransformation_torch.tools import train as train_cli
    from proxytransformation_torch.utils.config import Config
    repo = Path(__file__).resolve().parent
    fixtures = repo / FIXTURES
    t_phase = time.perf_counter()
    n_files, build_s, decode_ms = decode_check(fixtures)
    log(f'[realdata] {n_files} fixtures decode to the sha256 cv2 recorded '
        f'(decoder library built in {build_s:.1f} s); host decode of one '
        f'640x480 JPEG {decode_ms["jpeg"]:.2f} ms, one 640x480 16-bit PNG '
        f'{decode_ms["png"]:.2f} ms ({smi})')
    work = REALDATA_WORK
    shutil.rmtree(work, ignore_errors=True)
    ema_checks = []
    ema_weights = runner_mod.Runner._ema_weights

    @contextmanager
    def checked_ema_weights(self):
        with ema_weights(self):
            params = dict(self.model.named_parameters())
            ema_checks.append(self.ema_state is not None and all(
                torch.equal(p, self.ema_state[n]) for n, p in params.items()))
            yield

    try:
        t0 = time.perf_counter()
        names = write_embodiedscan_tree(data_root, fixtures)
        log(f'[realdata] wrote a 3-scan EmbodiedScan tree (ScanNet, '
            f'Matterport, 3RScan; {N_SCAN_VIEWS} views a scan) in '
            f'{time.perf_counter() - t0:.1f} s')
        cfg = Config.fromfile(str(repo / FLAGSHIP_CONFIG))
        stages, sample = host_pipeline_breakdown(data_root, names,
                                                 cfg['train_pipeline'])
        rscan = rscan_decode_ms(fixtures)
        rstages, rsample = host_pipeline_breakdown(
            data_root, names, cfg['train_pipeline'], scan=RSCAN_SCAN)
        require(rsample['imgs'].shape[0] == 20
                and rsample['points'].shape == (100_000, 3)
                and np.isfinite(rsample['points']).all(),
                f'3RScan sample: imgs {rsample["imgs"].shape}, points '
                f'{rsample["points"].shape}')
        log(f'[realdata] 3rscan {RSCAN_SCAN}: host decode of one 224x172 '
            f'16-bit PGM depth frame {rscan["pgm"]:.3f} ms, one 960x540 '
            f'JPEG color frame {rscan["jpeg"]:.2f} ms; host pipeline of one '
            'train sample (20 views, ms): '
            + ', '.join(f'{k} {v:.1f}' for k, v in rstages.items())
            + f' ({smi})')
        pp = Det3DDataPreprocessor(**{
            k: v for k, v in cfg['model']['data_preprocessor'].items()
            if k != 'type'})
        t0 = time.perf_counter()
        pp([sample, sample])
        collate_ms = (time.perf_counter() - t0) * 1e3
        log('[realdata] host pipeline of one train sample (20 views, ms): '
            + ', '.join(f'{k} {v:.1f}' for k, v in stages.items())
            + f'; collate of a B=2 batch {collate_ms:.1f} ({smi})')

        first = {}
        runner_mod.Runner._ema_weights = checked_ema_weights
        # both steps captured: the epoch's four samples, the 3RScan ones
        # wherever the shuffle puts them
        with capturing_first_step(first, steps=2):
            _cuda.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            runner = train_cli.main(realdata_argv(
                repo / FLAGSHIP_CONFIG, work, data_root, names))
            wall = time.perf_counter() - t0
            counts = _cuda.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
        per_step = {k: len(first['calls'].get(k, ())) for k in RUNNER_KERNELS}
        for name in RUNNER_KERNELS:
            require(counts[name] > 0, f'{name}: not launched from the files')
            require(per_step[name] > 0, f'{name}: not in the first step')
        model = runner.model
        require(model.remat and model.compute_dtype == 'bfloat16'
                and runner.ema is not None,
                '--amp, remat or the EMA hook did not reach the runner')
        batch = first['batch']
        require(tuple(batch['imgs'].shape[:2]) == (2, 20)
                and tuple(batch['points'].shape[:2]) == (2, model.n_points),
                f'first batch: imgs {tuple(batch["imgs"].shape)}')
        losses = runner.train_log
        require(len(losses) == 2 and all(
            np.isfinite(v) for r in losses for v in r.values()),
            f'losses: {losses}')
        results = json.loads((work / 'val_results.json').read_text())
        require('Overall@0.25' in results, f'val results: {sorted(results)}')
        require(ema_checks == [True], f'val on the EMA weights: {ema_checks}')
        timing = dict(runner.train_timing)
        log(f'[realdata] flagship config, --amp, EMA hook, from files: 2 '
            f'steps (B=2, 20 views), a checkpoint and val (50 ordered '
            f'views) in {wall:.1f} s; s/it {timing["iter_s"]:.3f}, '
            f'data_wait_s {timing["data_wait_s"]:.4f}, first_wait_s '
            f'{timing["first_wait_s"]:.3f} (loader: the config\'s '
            f'{cfg["train_dataloader"]["num_workers"]} spawn workers), peak '
            f'memory {peak:.2f} GiB ({smi})')
        log('[realdata] losses: ' + '; '.join(
            f'step {r["iter"]} total {r["total_loss"]:.5f} grad_norm '
            f'{r["grad_norm"]:.4f}' for r in losses)
            + f'; val (on the EMA weights) {sorted(results)}')

        # the checkpoint carries the EMA weights, and a restore gives them
        path = latest_checkpoint(str(work))
        saved = load_checkpoint(path)['ema']
        require(saved is not None and set(saved) == set(runner.ema_state),
                'the checkpoint holds no EMA weights')
        require_same(runner.ema_state, saved, 'checkpoint EMA')
        for e in runner.ema_state.values():
            e.zero_()
        runner.resume_from(path)
        require_same(runner.ema_state, saved, 'restored EMA')
        moved = sum(not torch.equal(p.detach().cpu(), saved[n])
                    for n, p in model.named_parameters())
        require(moved > 0, 'the EMA weights equal the trained weights')
        log(f'[realdata] {Path(path).name}: {len(saved)} EMA tensors, '
            f'restored bit for bit; {moved} differ from the trained weights')
        require(len(first['more']) == 1, 'the second step was not captured')
        with torch.no_grad():
            rows = check_calls(first['calls'], RUNNER_KERNELS,
                               'the first step from files')
            second = check_calls(first['more'][0], RUNNER_KERNELS,
                                 'the second step from files')
        rows = {k: rows[k] + second[k] for k in rows}
        del runner, model, first
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        test_cli.main(realdata_argv(repo / FLAGSHIP_CONFIG, work, data_root,
                                    names, checkpoint=path))
        test_s = time.perf_counter() - t0
        dump = json.loads((work / 'test_results.json').read_text())
        require(ema_checks == [True, True] and len(dump) == 2,
                f'test: {len(dump)} results, EMA swaps {ema_checks}')
        log(f'[realdata] tools/test.py on {Path(path).name}: {len(dump)} '
            f'samples at 50 views on the EMA weights in {test_s:.1f} s; '
            f'phase 13 in {time.perf_counter() - t_phase:.1f} s')
    finally:
        runner_mod.Runner._ema_weights = ema_weights
    torch.cuda.empty_cache()
    summary = dict(decode_ms=decode_ms, host_stage_ms=stages,
                   rscan_decode_ms=rscan, rscan_host_stage_ms=rstages,
                   collate_ms=collate_ms, wall_s=wall, timing=timing,
                   peak_gib=peak, losses=losses, val_results=results,
                   per_step=per_step, test_s=test_s)
    return dict(rows=rows, counts=counts, per_step=per_step,
                summary=summary, names=names, checkpoint=path)


DETECTION_CONFIG = 'configs/detection/embodied-det3d-resnet50.py'
DETECTION_KERNELS = ('lookup_pmz', 'lookup_center', 'sparse_conv',
                     'sparse_conv_dfeats', 'sparse_conv_dw')
# the train split's scans, each listed this many times: two B=4 steps
DET_REPEATS = 4


def detection_argv(config: Path, work: Path, root: Path, names: dict,
                   checkpoint: str = None):
    """tools/train.py's arguments for phase 14 (tools/test.py's with
    `checkpoint`): the detection config as it is but for the data root,
    the ann files and a val loader, which the config lacks: the val split
    through the train pipeline without its two random augmentations."""
    from proxytransformation_torch.utils.config import Config
    cfg = Config.fromfile(str(config))
    pipeline = [t for t in cfg['train_pipeline']
                if t['type'] not in ('GlobalRotScaleTrans', 'RandomFlip3D')]
    val = dict(batch_size=2, num_workers=0,
               sampler=dict(type='DefaultSampler', shuffle=False),
               dataset=dict(type='EmbodiedScanDataset',
                            data_root=str(root) + '/',
                            ann_file=names['det_val'],
                            metainfo=cfg['metainfo'], pipeline=pipeline,
                            test_mode=True))
    opts = [f'val_dataloader={val!r}']
    if not checkpoint:
        opts += [f'train_dataloader.dataset.data_root={str(root) + "/"!r}',
                 f'train_dataloader.dataset.ann_file='
                 f'{names["det_train"]!r}',
                 'train_cfg.max_epochs=1', 'train_cfg.val_interval=1',
                 'log_interval=1']
    return ([str(config)] + ([checkpoint] if checkpoint else [])
            + ['--work-dir', str(work), '--cfg-options', *opts])


def write_detection_ann(root: Path, names: dict) -> None:
    """The train split's ScanNet and Matterport scans, each listed
    DET_REPEATS times (eight samples: two steps at the config's B=4), and
    the two alone for val, beside the others (phase 13's 3RScan scan is
    not phase 14's)."""
    import pickle
    with open(root / names['train'][0], 'rb') as f:
        infos = pickle.load(f)
    scans = [d for d in infos['data_list'] if d['sample_idx'] != RSCAN_SCAN]
    for key, repeats in (('det_train', DET_REPEATS), ('det_val', 1)):
        infos['data_list'] = scans * repeats
        names[key] = f'embodiedscan_infos_{key}.pkl'
        with open(root / names[key], 'wb') as f:
            pickle.dump(infos, f)


@contextmanager
def timed_nms(record):
    """While open, the Runner's batched NMS appends its device ms a call
    (CUDA events) to `record`."""
    from proxytransformation_torch.engine import runner as runner_mod
    nms = runner_mod.multiclass_nms

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = nms(*a, **kw)
        end.record()
        end.synchronize()
        record.append(start.elapsed_time(end))
        return out

    runner_mod.multiclass_nms = timed
    try:
        yield
    finally:
        runner_mod.multiclass_nms = nms


def detection_phases(smi, data_root: Path, names: dict):
    """Phase 14: the detection config at full width (284 classes, 100k
    points, MinkResNet-34, ResNet-50 at base 16, head 128, prune 1000, 20
    views at 480x480, float32, B=4) through the train CLI from phase 13's
    tree: two steps, val with the batched NMS and IndoorDetMetric, a
    checkpoint; the first step's kernel calls checked; a bare step timed;
    then the test CLI on the checkpoint."""
    from proxytransformation_torch.engine import runner as runner_mod
    from proxytransformation_torch.engine.checkpoint import (
        latest_checkpoint, load_checkpoint)
    from proxytransformation_torch.models.embodied_det3d import (
        Embodied3DDetector)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import test as test_cli
    from proxytransformation_torch.tools import train as train_cli
    repo = Path(__file__).resolve().parent
    config = repo / DETECTION_CONFIG
    work = repo / 'build' / 'chip_smoke_detection'
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    write_detection_ann(data_root, names)
    first, nms_ms = {}, []
    with capturing_first_step(first), timed_nms(nms_ms):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(detection_argv(config, work, data_root,
                                               names))
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    model = runner.model
    require(isinstance(model, Embodied3DDetector)
            and model.bbox_head.num_classes == 284
            and model.n_points == 100_000
            and model.bbox_head.pts_prune_threshold == 1000,
            'phase 14 did not build the full detection config')
    batch = first['batch']
    require(tuple(batch['imgs'].shape[:4]) == (4, 20, 480, 480)
            and tuple(batch['points'].shape) == (4, 100_000, 3),
            f'first batch: imgs {tuple(batch["imgs"].shape)}')
    per_step = {k: len(first['calls'].get(k, ()))
                for k in DETECTION_KERNELS}
    for name in DETECTION_KERNELS:
        require(counts[name] > 0, f'{name}: not launched by the detector')
        require(per_step[name] > 0, f'{name}: not in the detector\'s step')
    for name in ('ball_query', *BF16_KERNELS, *BF16_TRAIN_ONLY):
        require(counts[name] == 0, f'{name}: launched by the detector')
    losses = runner.train_log
    require(len(losses) == 2 and all(
        np.isfinite(v) for r in losses for v in r.values()),
        f'detector losses: {losses}')
    require({'loss_center', 'loss_bbox', 'loss_cls'} <= set(losses[0]),
            f'detector losses: {sorted(losses[0])}')
    results = json.loads((work / 'val_results.json').read_text())
    require({'mAP_0.25', 'mAR_0.25', 'mAP_0.50', 'mAR_0.50'}
            <= set(results), f'val results: {sorted(results)}')
    require(len(nms_ms) == 1, f'NMS calls in val: {len(nms_ms)}')
    timing = dict(runner.train_timing)

    # the checkpoint holds the runner's state
    path = latest_checkpoint(str(work))
    payload = load_checkpoint(path)
    require((payload['epoch'], payload['step']) == (1, 2),
            f'checkpoint {path}: epoch {payload["epoch"]}')
    require_same(runner_state(runner),
                 {k: payload[k] for k in ('model', 'optimizer', 'generator',
                                          'step')}, 'detector checkpoint')

    # every kernel call of the first step against its plain version
    with torch.no_grad():
        rows = check_calls(first['calls'], DETECTION_KERNELS,
                           'the detector\'s first step')

    # a bare train step on the runner's first batch: device time
    bare = runner_mod.make_train_step(model, runner.optimizer,
                                      runner.schedule)
    step_ms, step_host_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        bare(batch, runner.generator)
        end.record()
        torch.cuda.synchronize()
        step_host_ms.append((time.perf_counter() - t1) * 1e3)
        step_ms.append(start.elapsed_time(end))
    log(f'[detection] {DETECTION_CONFIG} (284 classes, 100k points, '
        f'MinkResNet-34, ResNet-50 base 16, head 128, prune 1000, float32, '
        f'B=4, 20 views at 480x480) from files: 2 steps, a checkpoint and '
        f'val in {wall:.1f} s; s/it {timing["iter_s"]:.3f}, data_wait_s '
        f'{timing["data_wait_s"]:.4f}, first_wait_s '
        f'{timing["first_wait_s"]:.3f}; peak memory {peak:.2f} GiB ({smi})')
    log('[detection] bare train step on the first batch: '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(step_host_ms, step_ms))
        + '; losses: ' + '; '.join(
            f'step {r["iter"]} center {r["loss_center"]:.5f} bbox '
            f'{r["loss_bbox"]:.5f} cls {r["loss_cls"]:.5f} grad_norm '
            f'{r["grad_norm"]:.4f}' for r in losses))
    log(f'[detection] val: batched NMS (nms_pre 1000, max_out 256, 284 '
        f'classes) {nms_ms[0]:.1f} ms of CUDA events for a B=2 batch; '
        f'IndoorDetMetric keys {len(results)}, the means '
        + ', '.join(f'{k} {results[k]:.4f}' for k in sorted(results)
                    if k.startswith('mA')))
    del runner, model, bare, first, batch
    torch.cuda.empty_cache()

    test_nms = []
    t0 = time.perf_counter()
    with timed_nms(test_nms):
        tested = test_cli.main(detection_argv(config, work, data_root, names,
                                              checkpoint=path))
    test_s = time.perf_counter() - t0
    require('mAP_0.25' in tested and len(test_nms) == 1,
            f'test: {sorted(tested)}, NMS calls {len(test_nms)}')
    log(f'[detection] tools/test.py on {Path(path).name}: mAP_0.25 '
        f'{tested["mAP_0.25"]:.4f} in {test_s:.1f} s (NMS {test_nms[0]:.1f} '
        f'ms); phase 14 in {time.perf_counter() - t_phase:.1f} s')
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    summary = dict(wall_s=wall, timing=timing, peak_gib=peak,
                   bare_step_ms=step_ms, bare_step_host_ms=step_host_ms,
                   losses=losses, val_results=results, nms_ms=nms_ms,
                   test_nms_ms=test_nms, test_s=test_s, per_step=per_step,
                   counts={k: counts[k] for k in DETECTION_KERNELS})
    return dict(rows=rows, counts=counts, per_step=per_step,
                summary=summary)

OCC_CONFIG = 'configs/occupancy/embodied-occ.py'
OCC_DATASET = dict(type='SyntheticOccupancyDataset', n_points=100_000,
                   n_views=20, img_size=480, n_voxels=(40, 40, 16),
                   num_classes=81, n_occupied=2048)


def occupancy_argv(work: Path, length: int, mtype: str = None,
                   checkpoint: str = None, batch_size: int = 2,
                   val_batch: int = 2, flags=(), options=()):
    """tools/train.py's arguments for phase 15 (tools/test.py's with
    `checkpoint`): the occupancy config as it is, with loaders at full
    scale (the config has none): `batch_size` (2: phase 15's), `length`
    train samples, 2 val samples in batches of `val_batch`, the prefetch
    thread; `mtype` swaps the model's type; `flags` go before the
    options, `options` (phase 22's) after them, where a repeated key
    wins."""
    def loader(ds, shuffle, bs):
        return dict(batch_size=bs, num_workers=0, dataset=ds,
                    sampler=dict(type='DefaultSampler', shuffle=shuffle))
    val_ds = dict(OCC_DATASET, length=2, seed=7, test_mode=True)
    opts = [f'val_dataloader={loader(val_ds, False, val_batch)!r}']
    if not checkpoint:
        train_ds = dict(OCC_DATASET, length=length)
        opts += [f'train_dataloader={loader(train_ds, True, batch_size)!r}',
                 'train_cfg.max_epochs=1', 'train_cfg.val_interval=1',
                 'log_interval=1']
    if mtype:
        opts.append(f'model.type={mtype!r}')
    opts += list(options)
    root = Path(__file__).resolve().parent
    return ([str(root / OCC_CONFIG)] + ([checkpoint] if checkpoint else [])
            + ['--work-dir', str(work), *flags, '--cfg-options', *opts])


def cuda_ms(fn, reps: int):
    """(CUDA-event ms, host ms) of each of `reps` calls of `fn`."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return dev_ms, host_ms


def occ_small_input_check() -> None:
    """The tiny occupancy predictors (the smoke config's sizes) on the
    card against the CPU, from the same fresh weights and batch: logits at
    every scale within 1e-4 · (1 + max|x|)."""
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.occ import (
        DenseFusionOccPredictor, EmbodiedOccPredictor)
    kw = dict(n_voxels=(16, 16, 8), voxel_range=(0, 0, 0, 5.0, 5.0, 2.5),
              num_classes=6, img_base_channels=4, neck_channels=16)
    rng = np.random.RandomState(2)
    B, V, H, W, N = 2, 4, 96, 96, 1024
    proj = np.tile(np.array([[96, 0, W / 2, 0], [0, 96, H / 2, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]], np.float32),
                   (B, V, 1, 1))
    batch = {'imgs': rng.randn(B, V, H, W, 3).astype(np.float32),
             'points': rng.uniform(0, 5, (B, N, 3)).astype(np.float32),
             'points_mask': np.ones((B, N), bool), 'proj_mats': proj,
             'views_mask': np.ones((B, V), bool)}
    for cls in (EmbodiedOccPredictor, DenseFusionOccPredictor):
        cpu = flax_init_(cls(**kw, device='cpu'),
                         torch.Generator().manual_seed(0))
        card = cls(**kw, device='cuda')
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want = cpu.logits(batch_to_device(batch, 'cpu'))
            got = card.logits(batch_to_device(batch, 'cuda'))
        errs = []
        for g, w in zip(got, want):
            errs.append(float((g.cpu() - w).abs().max()))
            require(errs[-1] <= 1e-4 * (1 + float(w.abs().max())),
                    f'{cls.__name__}: card and CPU logits differ by '
                    f'{errs[-1]}')
        log(f'[occupancy] small input, {cls.__name__}: card vs CPU logits '
            f'max abs err by scale {[f"{e:.3g}" for e in errs]}')


def occupancy_phases(smi):
    """Phase 15: the occupancy config at full width through the train and
    test CLIs, then DenseFusion for one step and one request."""
    from proxytransformation_torch.engine import runner as runner_mod
    from proxytransformation_torch.engine.checkpoint import (
        latest_checkpoint, load_checkpoint)
    from proxytransformation_torch.models.occ import (
        DenseFusionOccPredictor, EmbodiedOccPredictor)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import test as test_cli
    from proxytransformation_torch.tools import train as train_cli
    repo = Path(__file__).resolve().parent
    work = repo / 'build' / 'chip_smoke_occupancy'
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    occ_small_input_check()
    first = {}
    with capturing_first_step(first):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(occupancy_argv(work, 4))
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    model = runner.model
    require(type(model) is EmbodiedOccPredictor
            and model.n_voxels == (40, 40, 16) and model.num_classes == 81
            and model.neck_3d.out_0.conv.weight.shape[0] == 128,
            'phase 15 did not build the full occupancy config')
    batch = first['batch']
    require(tuple(batch['imgs'].shape[:4]) == (2, 20, 480, 480)
            and tuple(batch['gt_occupancy'].shape[:2]) == (2, 20_000),
            f'first batch: imgs {tuple(batch["imgs"].shape)}')
    require(not any(counts.values()),
            f'a kernel of csrc/ launched on the occupancy path: {counts}')
    require(not any(first['calls'].values()),
            'a kernel wrapper was called on the occupancy path')
    losses = runner.train_log
    require(len(losses) == 2 and all(
        np.isfinite(v) for r in losses for v in r.values()),
        f'occupancy losses: {losses}')
    results = json.loads((work / 'val_results.json').read_text())
    require({'mIoU', 'IoU_geo'} <= set(results)
            and all(np.isfinite(v) for v in results.values()),
            f'val results: {sorted(results)}')
    timing = dict(runner.train_timing)
    path = latest_checkpoint(str(work))
    payload = load_checkpoint(path)
    require((payload['epoch'], payload['step']) == (1, 2),
            f'checkpoint {path}: epoch {payload["epoch"]}')
    require_same(runner_state(runner),
                 {k: payload[k] for k in ('model', 'optimizer', 'generator',
                                          'step')}, 'occupancy checkpoint')
    bare = runner_mod.make_train_step(model, runner.optimizer,
                                      runner.schedule)
    step_ms, step_host_ms = cuda_ms(lambda: bare(batch, runner.generator), 2)
    with torch.no_grad():
        req_ms, req_host_ms = cuda_ms(lambda: model(batch), 3)
        occ = model(batch)['occupancy']
    require(tuple(occ.shape) == (2, 40, 40, 16) and int(occ.min()) >= 0
            and int(occ.max()) < 81, f'occupancy {tuple(occ.shape)}')
    log(f'[occupancy] {OCC_CONFIG} (40x40x16 voxels, 81 classes, ResNet-50 '
        f'base 16, neck 128, float32, B=2, 20 views at 480x480, 100k '
        f'points, 2048 occupied voxels): 2 steps, a checkpoint and val in '
        f'{wall:.1f} s; s/it {timing["iter_s"]:.3f}, data_wait_s '
        f'{timing["data_wait_s"]:.4f}, first_wait_s '
        f'{timing["first_wait_s"]:.3f} (loader: prefetch thread); peak '
        f'memory {peak:.2f} GiB; no kernel of csrc/ launched ({smi})')
    log('[occupancy] bare train step on the first batch: '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(step_host_ms, step_ms))
        + '; request (B=2): '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(req_host_ms, req_ms)))
    log('[occupancy] losses: ' + '; '.join(
        f'step {r["iter"]} ' + ' '.join(
            f'{k} {r[k]:.5f}' for k in ('loss_occ_0', 'loss_occ_1',
                                        'loss_occ_2', 'grad_norm'))
        for r in losses) + f'; OccupancyMetric: {len(results)} keys, mIoU '
        f'{results["mIoU"]:.5f}, IoU_geo {results["IoU_geo"]:.5f} and '
        f'iou_cls_c for {len(results) - 2} classes present')
    del runner, model, bare, first, batch, occ
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tested = test_cli.main(occupancy_argv(work, 4, checkpoint=path))
    test_s = time.perf_counter() - t0
    require({'mIoU', 'IoU_geo'} <= set(tested), f'test: {sorted(tested)}')
    log(f'[occupancy] tools/test.py on {Path(path).name}: mIoU '
        f'{tested["mIoU"]:.5f} (val after training {results["mIoU"]:.5f}), '
        f'IoU_geo {tested["IoU_geo"]:.5f} in {test_s:.1f} s')
    shutil.rmtree(work, ignore_errors=True)

    # DenseFusion: one step and one request
    first = {}
    with capturing_first_step(first):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(occupancy_argv(
            work, 2, 'DenseFusionOccPredictor'))
        dense_wall = time.perf_counter() - t0
        dense_counts = _cuda.launch_counts()
        dense_peak = torch.cuda.max_memory_allocated() / 2**30
    require(type(runner.model) is DenseFusionOccPredictor
            and len(runner.train_log) == 1
            and all(np.isfinite(v) for v in runner.train_log[0].values()),
            f'DenseFusion: {runner.train_log}')
    require(not any(dense_counts.values()),
            f'a kernel of csrc/ launched by DenseFusion: {dense_counts}')
    dense_results = json.loads((work / 'val_results.json').read_text())
    with torch.no_grad():
        dense_req_ms, dense_req_host = cuda_ms(
            lambda: runner.model(first['batch']), 1)
    log(f'[occupancy] DenseFusionOccPredictor: one step, a checkpoint and '
        f'val in {dense_wall:.1f} s, loss '
        f'{runner.train_log[0]["total_loss"]:.5f}; a request (B=2) '
        f'{dense_req_host[0]:.1f} ms ({dense_req_ms[0]:.1f} ms of CUDA '
        f'events); peak memory {dense_peak:.2f} GiB; mIoU '
        f'{dense_results["mIoU"]:.5f}; phase 15 in '
        f'{time.perf_counter() - t_phase:.1f} s ({smi})')
    del runner, first
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return dict(wall_s=wall, timing=timing, peak_gib=peak, losses=losses,
                val_results=results, bare_step_ms=step_ms,
                bare_step_host_ms=step_host_ms, request_ms=req_ms,
                request_host_ms=req_host_ms, test_s=test_s,
                test_results=tested, dense_wall_s=dense_wall,
                dense_request_ms=dense_req_ms, dense_peak_gib=dense_peak,
                dense_results=dense_results)


@contextmanager
def capturing_first_predict(first):
    """While open, the Runner's first prediction records the kernel calls
    it launches into `first['calls']`, and every merge of augmented
    copies appends its copies' count and result keys to `first['merges']`."""
    from proxytransformation_torch.engine import runner as runner_mod
    predict = runner_mod.Runner._predict
    merge = runner_mod.merge_aug_bboxes_3d

    def capturing_predict(self, batch, bs, aug_metas):
        if 'calls' in first:
            return predict(self, batch, bs, aug_metas)
        out = []
        first['calls'] = capture_kernel_calls(
            lambda: out.append(predict(self, batch, bs, aug_metas)))
        return out[0]

    def recording_merge(results, metas, *a):
        merged = merge(results, metas, *a)
        first.setdefault('merges', []).append((len(results), sorted(merged)))
        return merged

    runner_mod.Runner._predict = capturing_predict
    runner_mod.merge_aug_bboxes_3d = recording_merge
    try:
        yield
    finally:
        runner_mod.Runner._predict = predict
        runner_mod.merge_aug_bboxes_3d = merge


def tta_phases(smi, data_root: Path, realdata):
    """Phase 16: tools/test.py --tta on phase 13's checkpoint and tree:
    two copies of each 50-view scene in one forward, merged; the first
    batch's kernel calls checked."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import test as test_cli
    repo = Path(__file__).resolve().parent
    argv = realdata_argv(repo / FLAGSHIP_CONFIG, REALDATA_WORK, data_root,
                         realdata['names'], checkpoint=realdata['checkpoint'])
    argv.insert(2, '--tta')
    first = {}
    with capturing_first_predict(first):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        test_cli.main(argv)
        test_s = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    dump = json.loads((REALDATA_WORK / 'test_results.json').read_text())
    merges = first.get('merges', [])
    require(len(dump) == 2 and len(merges) == 2
            and all(n == 2 for n, _ in merges),
            f'TTA: {len(dump)} results, merges {merges}')
    per_batch = {k: len(first['calls'].get(k, ())) for k in PREDICT_KERNELS}
    for name in PREDICT_KERNELS:
        require(counts[name] > 0, f'{name}: not launched by the TTA test')
        require(per_batch[name] > 0, f'{name}: not in TTA\'s first batch')
    for name in (*TRAIN_ONLY, *BF16_KERNELS, *BF16_TRAIN_ONLY):
        require(counts[name] == 0, f'{name}: launched by the TTA test')
    with torch.no_grad():
        rows = check_calls(first['calls'], PREDICT_KERNELS,
                           'TTA\'s first batch')
    plain_s = realdata['summary']['test_s']
    log(f'[tta] tools/test.py --tta on {Path(realdata["checkpoint"]).name}: '
        f'{len(dump)} scenes at 50 views, two copies each (scale 1, with '
        f'and without a horizontal flip) stacked into one B=2 forward, in '
        f'{test_s:.1f} s; phase 13\'s test without TTA {plain_s:.1f} s; '
        f'peak memory {peak:.2f} GiB; merged predictions\' keys '
        f'{merges[0][1]}; kernel calls of the first batch {per_batch} '
        f'({smi})')
    del first
    torch.cuda.empty_cache()
    summary = dict(test_s=test_s, plain_test_s=plain_s, peak_gib=peak,
                   merges=merges, per_batch=per_batch,
                   counts={k: counts[k] for k in PREDICT_KERNELS})
    return dict(rows=rows, counts=counts, per_step=per_batch,
                summary=summary)


BASELINE_KERNELS = ('lookup_pmz', 'lookup_center', 'sparse_conv',
                    'sparse_conv_dfeats', 'sparse_conv_dw')


def baseline_phases(smi, flagship_req_ms):
    """Phase 17: the baseline grounder at full width, flax's fresh
    weights: from launch counts of 0 three float32 requests and one AdamW
    step; the first request's and the step's kernel calls checked."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.engine.runner import build_model_from_cfg
    from proxytransformation_torch.engine.train import (
        build_lr_schedule, build_optimizer, make_train_step)
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounder, batch_to_device)
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.utils.config import Config
    repo = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    cfg = dict(Config.fromfile(str(repo / FLAGSHIP_CONFIG))['model'],
               type='SparseFeatureFusion3DGrounder')
    del cfg['preshape']
    model = build_model_from_cfg(cfg, device='cuda')
    require(type(model) is SparseFeatureFusion3DGrounder
            and not hasattr(model, 'preshape'), 'not the baseline')
    flax_init_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    dev = torch.device('cuda')
    batches = [batch_to_device(flagship_batch(seed=r), dev) for r in range(3)]
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    req_ms, req_host_ms, first = [], [], {}
    for r, batch in enumerate(batches):
        out = {}
        fn = lambda: out.update(model(batch))  # noqa: E731
        if r == 0:
            first['request'] = capture_kernel_calls(fn)
            req_ms.append(float('nan'))
            req_host_ms.append(float('nan'))
        else:
            d, h = cuda_ms(fn, 1)
            req_ms += d
            req_host_ms += h
        for k in ('bboxes_3d', 'scores_3d'):
            require(bool(torch.isfinite(out[k]).all()), f'non-finite {k}')
        require(bool(out['query_mask'].any()), 'no valid query')
    req_peak = torch.cuda.max_memory_allocated() / 2**30
    model.train()
    step = make_train_step(model, build_optimizer(model),
                           build_lr_schedule(5e-4, steps_per_epoch=1))
    step_batch = batch_to_device(flagship_batch(seed=0, with_targets=True),
                                 dev)
    metrics = {}
    t0 = time.perf_counter()
    first['step'] = capture_kernel_calls(
        lambda: metrics.update(step(
            step_batch, torch.Generator(device=dev).manual_seed(0))))
    step_s = time.perf_counter() - t0
    model.eval()
    counts = _cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(np.isfinite(float(v)) for v in metrics.values()),
            f'baseline step: {metrics}')
    require(counts['ball_query'] == 0, 'the baseline launched a ball query')
    per_request = {k: len(first['request'].get(k, ()))
                   for k in BASELINE_KERNELS}
    per_step = {k: len(first['step'].get(k, ())) for k in BASELINE_KERNELS}
    for name in BASELINE_KERNELS:
        require(counts[name] > 0, f'{name}: not launched by the baseline')
        require(per_step[name] > 0, f'{name}: not in the baseline\'s step')
    for name in ('lookup_pmz', 'lookup_center', 'sparse_conv'):
        require(per_request[name] > 0, f'{name}: not in a baseline request')
    calls = {k: first['request'].get(k, []) + first['step'].get(k, [])
             for k in BASELINE_KERNELS}
    del first
    with torch.no_grad():
        rows = check_calls(calls, BASELINE_KERNELS,
                           'the baseline\'s first request and step')
    log(f'[baseline] SparseFeatureFusion3DGrounder (the flagship config '
        f'without its preshape, {n_params} parameters, float32): requests '
        f'(B=2, 100k points, 20 views) 2 and 3: '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(req_host_ms[1:], req_ms[1:]))
        + f' (request 1 captured); phase 5\'s flagship requests: '
        + ', '.join(f'{d:.1f}' for d in flagship_req_ms)
        + f' ms of CUDA events; one AdamW step {step_s * 1e3:.1f} ms '
        f'(captured), total loss {float(metrics["total_loss"]):.5f}; peak '
        f'memory {req_peak:.2f} GiB in requests, {peak:.2f} GiB with the '
        f'step; kernel calls a request {per_request}, a step {per_step}; '
        f'phase 17 in {time.perf_counter() - t_phase:.1f} s ({smi})')
    del model, step, batches, step_batch, calls
    torch.cuda.empty_cache()
    summary = dict(request_ms=req_ms, request_host_ms=req_host_ms,
                   flagship_request_ms=flagship_req_ms, step_s=step_s,
                   request_peak_gib=req_peak, peak_gib=peak,
                   per_request=per_request, per_step=per_step,
                   losses={k: float(v) for k, v in metrics.items()},
                   counts={k: counts[k] for k in BASELINE_KERNELS})
    return dict(rows=rows, counts=counts, per_step=per_step,
                summary=summary)


# --------------------------------------------------------------------------
# 18. the text towers, MinkResNet-50 and the brick stages
# --------------------------------------------------------------------------
MINK_KERNELS = ('lookup_pmz', 'sparse_conv')
# base sizes held card against CPU; the large ones run on the card only
TOWERS_CPU = ('bert-base-uncased', 'roberta-base', 'facebook/flava-full',
              't5-base', 'deberta-base', 'clip-vit-base-patch32',
              'eva02-l-14-336')
TOWERS_CARD = ('t5-large', 'deberta-large', 'vit-h-14', 'vit-bigg-14')
BRICK_RTOL = BRICK_ATOL = 1e-3   # tests/test_brick.py's


def roberta_phase(flagship_req_ms, flagship_text_ms):
    """18a: the flagship model config with t_type='roberta-base' (768
    wide, 12 layers, vocabulary 50265, 514 positions), flax's fresh
    weights: from launch counts of 0 three float32 requests on
    `flagship_batch`, two timed (and their peak memory), the third
    captured and its kernel calls checked."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.engine.runner import build_model_from_cfg
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.text_variants import (
        RobertaTextEncoder)
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.utils.config import Config
    repo = Path(__file__).resolve().parent
    cfg = dict(Config.fromfile(str(repo / FLAGSHIP_CONFIG))['model'],
               t_type='roberta-base')
    model = build_model_from_cfg(cfg, device='cuda')
    enc = model.text_encoder
    require(isinstance(enc, RobertaTextEncoder) and enc.width == 768
            and len(enc.encoder.layer) == 12 and enc.vocab_size == 50265
            and enc.embeddings.position_embeddings.num_embeddings == 514,
            'not the roberta-base tower')
    flax_init_(model, torch.Generator().manual_seed(0))
    dev = torch.device('cuda')
    host = [flagship_batch(seed=r) for r in range(3)]
    for b in host:
        model.check_text_ids(b['input_ids'])
    batches = [batch_to_device(b, dev) for b in host]
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    first, req_ms, peak = {}, [], None
    for r, batch in enumerate(batches):
        out = {}
        fn = lambda: out.update(model(batch))  # noqa: E731
        if r < 2:
            req_ms += cuda_ms(fn, 1)[0]
        else:   # the last request captured, after the peak of the others
            peak = torch.cuda.max_memory_allocated() / 2**30
            first = capture_kernel_calls(fn)
        for k in ('bboxes_3d', 'scores_3d'):
            require(bool(torch.isfinite(out[k]).all()), f'non-finite {k}')
        require(out['bboxes_3d'].shape[-1] == 9 and
                bool(out['query_mask'].any()), 'roberta request output')
    counts = _cuda.launch_counts()
    per_request = {k: len(first.get(k, ())) for k in PREDICT_KERNELS}
    for name in PREDICT_KERNELS:
        require(per_request[name] > 0 and counts[name] == 3 * per_request[
            name], f'{name}: {counts[name]} launches in three roberta '
            f'requests, {per_request[name]} a request')
    with torch.no_grad():
        rows = check_calls(first, PREDICT_KERNELS,
                           'the roberta grounder\'s third request')
    stages = stage_breakdown(model, batches[-1])
    log(f'[roberta] flagship config with t_type=roberta-base (768 x 12 '
        f'layers, vocabulary 50265, 514 positions), flax fresh weights: '
        f'requests 1 and 2 ' + ', '.join(f'{d:.1f}' for d in req_ms)
        + ' ms of CUDA events (request 3 captured); phase 5\'s CLIP '
        'flagship requests ' + ', '.join(f'{d:.1f}' for d in flagship_req_ms)
        + f' ms; text tower {stages["text_encoder"]:.2f} ms of a '
        f'{stages["request"]:.1f} ms request (phase 5\'s CLIP tower '
        f'{flagship_text_ms:.2f} ms); peak memory {peak:.2f} GiB; kernel '
        f'calls a request {per_request}')
    del model, batches, first
    torch.cuda.empty_cache()
    summary = dict(request_ms=req_ms, flagship_request_ms=flagship_req_ms,
                   stage_ms=stages, flagship_text_ms=flagship_text_ms,
                   peak_gib=peak, per_request=per_request)
    return dict(rows=rows, counts=counts, per_step={}, summary=summary)


def tower_phase():
    """18b: every tower family at its published size alone, B=2, L=32 ids
    within its vocabulary (one padded row): shape, finiteness and CUDA-
    event ms; the base sizes also against the same weights on the CPU."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.layers import random_init_
    from proxytransformation_torch.models.text_variants import (
        build_text_encoder)
    rng = np.random.RandomState(0)
    mask = np.ones((2, 32), bool)
    mask[1, 24:] = False
    out = {}
    for t_type in (*TOWERS_CPU, *TOWERS_CARD):
        t0 = time.perf_counter()
        on_cpu = t_type in TOWERS_CPU
        if on_cpu:
            cpu, width = build_text_encoder(t_type)
            flax_init_(cpu, torch.Generator().manual_seed(0))
            card, _ = build_text_encoder(t_type)
            card.load_state_dict(cpu.state_dict())
            card.to('cuda')
        else:
            with torch.device('cuda'):
                card, width = build_text_encoder(t_type)
            random_init_(card, torch.Generator(device='cuda').manual_seed(0))
        ids = rng.randint(0, card.vocab_size, (2, 32)).astype(np.int32)
        card.check_ids(ids)
        ids_d = torch.from_numpy(ids).cuda()
        mask_d = torch.from_numpy(mask).cuda()
        with torch.no_grad():
            got = card(ids_d, mask_d)
            ms = cuda_ms(lambda: card(ids_d, mask_d), 3)[0]
            require(got.shape == (2, 32, width) and
                    bool(torch.isfinite(got).all()), f'{t_type} output')
            err = tol = None
            if on_cpu:
                want = cpu(torch.from_numpy(ids), torch.from_numpy(mask))
                err = float((got.cpu() - want).abs().max())
                tol = 1e-4 * (1 + float(want.abs().max()))
                require(err <= tol, f'{t_type}: card vs CPU {err} > {tol}')
        n_params = sum(p.numel() for p in card.parameters())
        out[t_type] = dict(width=width, params=n_params, ms=ms,
                           card_vs_cpu=err, tol=tol)
        log(f'[towers] {t_type}: {type(card).__name__} width {width}, '
            f'{n_params} parameters, (2, 32) -> {tuple(got.shape)} finite, '
            + ', '.join(f'{m:.2f}' for m in ms) + ' ms of CUDA events'
            + ('' if err is None else
               f'; card vs CPU max abs err {err:.3g} (tol {tol:.3g})')
            + f' ({time.perf_counter() - t0:.1f} s)')
        del card
        if on_cpu:
            del cpu
        torch.cuda.empty_cache()
    return out


def flagship_level0():
    """The flagship's points (B=2, 100k, surface scenes) voxelized as the
    grounder does, xyz features, on the card."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.ops.sparse import voxelize_points
    b = flagship_batch(seed=0)
    pts = torch.from_numpy(b['points'][..., :3]).cuda()
    mask = torch.from_numpy(b['points_mask']).cuda()
    return voxelize_points(pts, mask, pts, 0.01, 100_000, (1280, 1280, 512))


def backbone_runs(models, level0, label):
    """Each model's forward from launch counts of 0: timed twice, then
    captured once (every kernel call kept). {model: captured calls},
    {model: launch counts of its three forwards}, {model: CUDA-event ms},
    {model: peak GiB of the timed forwards above the memory held before
    them}, {model: stage levels}."""
    from proxytransformation_torch.ops import _cuda
    calls, counts, ms, peak, outs = {}, {}, {}, {}, {}
    for name, model in models.items():
        _cuda.reset_launch_counts()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms[name] = cuda_ms(lambda: model(level0), 2)[0]
            peak[name] = (torch.cuda.max_memory_allocated() - held) / 2**30
            got = {}
            calls[name] = capture_kernel_calls(
                lambda: got.update(out=model(level0)))
        counts[name] = _cuda.launch_counts()
        outs[name] = got['out'][0]
        require(counts[name]['ball_query'] == 0,
                f'{label} {name}: a ball query')
        for k in MINK_KERNELS:
            n = len(calls[name].get(k, ()))
            require(n > 0 and counts[name][k] == 3 * n,
                    f'{label} {name}: {counts[name][k]} {k} launches in '
                    f'three forwards, {n} a forward')
        for lvl in outs[name]:
            require(bool(torch.isfinite(lvl.feats).all()),
                    f'{label} {name}: non-finite features')
    return calls, counts, ms, peak, outs


def checked_path(names, calls, counts, where):
    """(rows, launches) of the named models' kernel calls."""
    joined = {k: [c for n in names for c in calls[n].get(k, [])]
              for k in MINK_KERNELS}
    with torch.no_grad():
        rows = check_calls(joined, MINK_KERNELS, where)
    return rows, {k: sum(counts[n][k] for n in names) for k in MINK_KERNELS}


def mink50_phase():
    """18c: MinkResNet-50 at full width with the instance-norm and the
    batch-norm stem, MinkResNet-34 beside them, on the flagship's points;
    every kernel call of the depth-50 forwards checked."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.sparse_resnet import MinkResNet
    level0 = flagship_level0()
    models = {}
    for name, depth, norm in (('MinkResNet-50 instance stem', 50,
                               'instance'),
                              ('MinkResNet-50 BN stem', 50, 'batch'),
                              ('MinkResNet-34', 34, 'instance')):
        m = MinkResNet(depth, 3, norm=norm)
        flax_init_(m, torch.Generator().manual_seed(0))
        models[name] = m.cuda().eval()
    calls, counts, ms, peak, outs = backbone_runs(models, level0, 'mink50')
    mink50 = [k for k in models if '50' in k]
    rows, launches = checked_path(mink50, calls, counts,
                                  'the two MinkResNet-50 forwards')
    widths = [int(o.feats.shape[-1]) for o in outs[mink50[0]]]
    require(widths == [256, 512, 1024, 2048], f'MinkResNet-50 widths '
            f'{widths}')
    per = {n: {k: len(calls[n].get(k, ())) for k in MINK_KERNELS}
           for n in models}
    log('[mink50] on the flagship\'s points (B=2, 100k, '
        f'{int(level0.mask.sum())} voxels at 1 cm), eval, flax fresh '
        'weights: ' + '; '.join(
            f'{n} ' + ', '.join(f'{m:.1f}' for m in ms[n])
            + f' ms of CUDA events, its peak {peak[n]:.2f} GiB' for n in models)
        + f'; stage widths {widths}; stage voxels '
        f'{[int(o.mask.sum()) for o in outs[mink50[0]]]}; kernel calls a '
        f'forward {per}')
    del models, calls, outs
    torch.cuda.empty_cache()
    summary = dict(ms=ms, peak_gib=peak, per_forward=per,
                   voxels=int(level0.mask.sum()))
    return dict(rows=rows, counts=launches, per_step={}, summary=summary)


def brick_phase():
    """18d: MinkResNet-34 with brick_stages=(0,) and (0, 1) beside the
    cell format on the flagship's points (the same weights): the stage
    outputs against the cell format's within tests/test_brick.py's
    tolerance, every kernel call of the brick forwards checked (the 8C
    convs: 512 and 1024 wide)."""
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.sparse_resnet import MinkResNet
    level0 = flagship_level0()
    cell = MinkResNet(34, 3)
    flax_init_(cell, torch.Generator().manual_seed(0))
    models = {'cell': cell.cuda().eval()}
    for stages in ((0, ), (0, 1)):
        m = MinkResNet(34, 3, brick_stages=stages).cuda().eval()
        m.load_state_dict(cell.state_dict())
        require(m.brick_stages == stages, f'brick stages {m.brick_stages}')
        models[f'brick {stages}'] = m
    calls, counts, ms, peak, outs = backbone_runs(models, level0, 'brick')
    bricks = [n for n in models if n != 'cell']
    errs = {}
    for name in bricks:
        errs[name] = []
        for i, (b, c) in enumerate(zip(outs[name], outs['cell'])):
            require(torch.equal(b.keys, c.keys), f'{name} stage {i} keys')
            err = float((b.feats - c.feats).abs().max())
            tol = BRICK_ATOL + BRICK_RTOL * float(c.feats.abs().max())
            require(err <= tol, f'{name} stage {i}: {err} > {tol}')
            errs[name].append(err)
    rows, launches = checked_path(bricks, calls, counts,
                                  'the two brick forwards')
    widths = sorted({r['key'][2] for r in rows['sparse_conv']})
    require(512 in widths and 1024 in widths,
            f'no 8C-wide brick conv among C_in {widths}')
    per = {n: {k: len(calls[n].get(k, ())) for k in MINK_KERNELS}
           for n in models}
    log('[brick] MinkResNet-34 on the flagship\'s points, eval, the same '
        'weights: ' + '; '.join(
            f'{n} ' + ', '.join(f'{m:.1f}' for m in ms[n])
            + f' ms of CUDA events, its peak {peak[n]:.2f} GiB' for n in models)
        + f'; stage max abs err against the cell format {errs} (tol '
        f'{BRICK_ATOL} + {BRICK_RTOL} * max); conv input widths '
        f'{widths}; kernel calls a forward {per}')
    del models, calls, outs
    torch.cuda.empty_cache()
    summary = dict(ms=ms, peak_gib=peak, errs=errs, per_forward=per)
    return dict(rows=rows, counts=launches, per_step={}, summary=summary)


def slice13_phases(smi, flagship_req_ms, flagship_text_ms):
    """Phase 18 (a-d)."""
    t_phase = time.perf_counter()
    roberta = roberta_phase(flagship_req_ms, flagship_text_ms)
    towers = tower_phase()
    mink50 = mink50_phase()
    brick = brick_phase()
    log(f'[phase 18] in {time.perf_counter() - t_phase:.1f} s ({smi})')
    return dict(roberta=roberta, towers=towers, mink50=mink50, brick=brick)


# --------------------------------------------------------------------------
# 19. data parallelism
# --------------------------------------------------------------------------
DP_KERNELS = (*PREDICT_KERNELS, *TRAIN_ONLY)
DP_WORK = Path(__file__).resolve().parent / 'build' / 'chip_smoke_dp'
DP_B = 4                  # the global batch: 2 a rank on 2 ranks
DP_TIMEOUT_S = 600        # the process groups' and each launch's bound
GLOO = ('env_cfg.dist_cfg.backend=gloo',
        f'env_cfg.dist_cfg.timeout={DP_TIMEOUT_S}')


def dp_model(dev):
    """The flagship grounder at full width, float32, seeded weights."""
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape)
    return SparseFeatureFusion3DGrounderPreshape(device=dev).random_init_(0)


def dp_batch(ctx=None):
    """The global B=4 flagship batch with targets, or a rank's rows."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    batch = flagship_batch(B=DP_B, seed=0, with_targets=True)
    if ctx is None:
        return batch
    b = DP_B // ctx.world
    return {k: v[ctx.rank * b:(ctx.rank + 1) * b] for k, v in batch.items()}


def dp_train_step(model):
    from proxytransformation_torch.engine.train import (
        BASE_LR, build_lr_schedule, build_optimizer, make_train_step)
    return make_train_step(model, build_optimizer(model),
                           build_lr_schedule(BASE_LR, steps_per_epoch=1))


def timed_step(step, batch, seed):
    """One step with dropout seed `seed`: (metrics, CUDA-event ms, host
    ms)."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = step(batch, gen)
    end.record()
    torch.cuda.synchronize()
    m = {k: float(v) for k, v in metrics.items()}
    require(all(np.isfinite(v) for v in m.values()), f'step metrics {m}')
    return m, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


@contextmanager
def stage_capture(model, store):
    """While open, `store` gets the first call's preshape offsets (before
    the tanh: the last stage before a discrete choice, the second ball
    query) and level-0 voxel keys."""
    from proxytransformation_torch.models import detector as det_mod
    voxelize = det_mod.voxelize_points

    def rec(*a, **kw):
        out = voxelize(*a, **kw)
        store.setdefault('keys', out.keys.detach().cpu())
        return out

    def keep(module, args, out):
        store.setdefault('offsets', out.detach().cpu())

    hook = model.preshape.get_offsets.register_forward_hook(keep)
    det_mod.voxelize_points = rec
    try:
        yield
    finally:
        det_mod.voxelize_points = voxelize
        hook.remove()


def trainable_flat(model):
    """Every trained parameter, flat, in parameter order."""
    from proxytransformation_torch.engine.train import param_label
    return torch.cat([p.detach().reshape(-1)
                      for n, p in model.named_parameters()
                      if param_label(n) != 'frozen'])


def dp_reference():
    """19a's one process: the float32 step at global B=4 twice from the
    same weights (the card's run-to-run distance), then a third step for
    its time; the first run's parameters go to the ranks."""
    from proxytransformation_torch.models.detector import batch_to_device
    dev = torch.device('cuda')
    torch.cuda.reset_peak_memory_stats()
    model = dp_model(dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batch_to_device(dp_batch(), dev)
    runs, stages = [], [{}, {}]
    for r in range(2):
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        step = dp_train_step(model)
        with stage_capture(model, stages[r]):
            m, ms, host = timed_step(step, batch, 0)
        runs.append(dict(metrics=m, ms=ms, host_ms=host,
                         params=trainable_flat(model).cpu()))
    m3, ms3, host3 = timed_step(step, batch, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    DP_WORK.mkdir(parents=True, exist_ok=True)
    torch.save(runs[0]['params'], DP_WORK / 'reference_params.pt')
    torch.save(stages[0], DP_WORK / 'reference_stages.pt')
    self_dist = float((runs[0]['params'] - runs[1]['params']).abs().max())
    self_stages = compare_stages(stages[1], stages[0])
    del model, init, batch, step
    torch.cuda.empty_cache()
    return dict(metrics=[r['metrics'] for r in runs], self_dist=self_dist,
                self_stages=self_stages,
                step_ms=[r['ms'] for r in runs] + [ms3],
                host_ms=[r['host_ms'] for r in runs] + [host3],
                peak_gib=peak, n_params=int(runs[0]['params'].numel()))


def compare_stages(got, want, rows=slice(None)):
    """The largest offset difference and the count of differing level-0
    voxel keys of `got` against `want`'s `rows`."""
    return dict(
        offsets_max_abs=float((got['offsets'] - want['offsets'][rows])
                              .abs().max()),
        offsets_max=float(want['offsets'][rows].abs().max()),
        keys_differing=int((got['keys'] != want['keys'][rows]).sum()),
        keys=int(got['keys'].numel()))


def dp_step_worker(work: Path) -> int:
    """19a's and 19e's rank (`python -m torch.distributed.run
    --nproc_per_node 2 chip_smoke.py --dp-step WORK`): gloo, both ranks on
    cuda:0; rank 0's state broadcast, one float32 step on the rank's half
    of the global batch (rank 0's kernel calls captured and checked), its
    parameters against the one-process run's and the other rank's, then a
    timed step and one with the collectives timed alone; then the
    occupancy run in the same group (`occ_dp_rank`)."""
    from proxytransformation_torch.device import full_float32
    from proxytransformation_torch.parallel import dist as pdist
    ctx = pdist.env_context()
    torch.cuda.set_device(0)
    pdist.init_process_group(ctx, 'gloo', 'env://', DP_TIMEOUT_S)
    try:
        with full_float32():
            out = dp_step_rank(ctx, work)
            out['occupancy'] = occ_dp_rank(ctx, work)
    finally:
        pdist.destroy_process_group()
    (work / f'rank{ctx.rank}.json').write_text(json.dumps(out))
    return 0


def dp_step_rank(ctx, work: Path) -> dict:
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.parallel import dist as pdist
    dev = torch.device('cuda')
    probe = torch.full((3, ), float(ctx.rank + 1), device=dev)
    torch.distributed.all_reduce(probe)
    require(torch.equal(probe.cpu(), torch.full((3, ), 3.0)),
            f'gloo all-reduce on the card: {probe}')
    model = dp_model(dev)
    pdist.broadcast_state(model)
    batch = batch_to_device(dp_batch(ctx), dev)
    step = dp_train_step(model)
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    pdist.reset_stats()
    first, stages = {}, {}
    with stage_capture(model, stages):
        if ctx.is_main:
            calls = capture_kernel_calls(
                lambda: first.update(out=timed_step(step, batch, 0)))
        else:
            first['out'] = timed_step(step, batch, 0)
    b = DP_B // ctx.world
    stage_diff = compare_stages(
        stages, torch.load(work / 'reference_stages.pt'),
        slice(ctx.rank * b, (ctx.rank + 1) * b))
    counts = _cuda.launch_counts()
    m1, ms1, host1 = first['out']
    collectives = dict(pdist.STATS)
    params = trainable_flat(model)
    ref = torch.load(work / 'reference_params.pt').to(dev)
    max_diff = float((params - ref).abs().max())
    del ref
    theirs = params.clone()
    pdist.broadcast_tensors([theirs])
    ranks_equal = bool(torch.equal(theirs, params))
    del theirs, params
    out = dict(rank=ctx.rank, metrics=m1, step_ms=[ms1], host_ms=[host1],
               max_param_diff=max_diff, ranks_equal=ranks_equal,
               stages=stage_diff,
               counts={k: counts[k] for k in DP_KERNELS},
               first_step_collectives=collectives)
    if ctx.is_main:
        out['per_step'] = {k: len(calls.get(k, ())) for k in DP_KERNELS}
        with torch.no_grad():
            out['rows'] = check_calls(calls, DP_KERNELS,
                                      'rank 0\'s data-parallel step')
        del calls
    torch.cuda.empty_cache()
    m2, ms2, host2 = timed_step(step, batch, 1)
    pdist.reset_stats()
    pdist.TIMING['sync'] = True
    m3, ms3, host3 = timed_step(step, batch, 2)
    pdist.TIMING['sync'] = False
    out.update(step_ms=[ms1, ms2, ms3], host_ms=[host1, host2, host3],
               later_metrics=[m2, m3], timed_collectives=dict(pdist.STATS),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return out


def torchrun(nproc: int, args, label: str, timeout: float = DP_TIMEOUT_S):
    """`python -m torch.distributed.run --standalone --nproc_per_node
    nproc args` from the repository root, in a session of its own (killed
    whole on timeout); its output goes to chiprun_out/dp_<label>.log.
    Returns (stderr, seconds)."""
    import os
    import signal
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           f'--nproc_per_node={nproc}', *map(str, args)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    LOG_PATH.parent.mkdir(exist_ok=True)
    (LOG_PATH.parent / f'dp_{label}.log').write_text(out + '\n' + err)
    require(proc.returncode == 0,
            f'{label}: exit {proc.returncode} after {seconds:.0f} s; '
            f'stderr tail: {err[-2000:]}')
    return err, seconds


def slurm_task(args, label: str, timeout: float = DP_TIMEOUT_S):
    """`python args` from the repository root as the one task of a
    one-node SLURM step (the variables srun sets, the coordinator
    localhost at a free MASTER_PORT), in a session of its own (killed
    whole on timeout); its output goes to chiprun_out/dp_<label>.log.
    Returns (the environment it had, seconds)."""
    import os
    import signal
    import socket
    root = Path(__file__).resolve().parent
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK',
                        'LOCAL_WORLD_SIZE', 'GROUP_RANK')}
    slurm = dict(SLURM_JOB_ID='4182391', SLURM_STEP_NODELIST='localhost',
                 SLURM_NTASKS='1', SLURM_PROCID='0', SLURM_LOCALID='0',
                 SLURM_STEP_NUM_NODES='1', SLURM_NODEID='0',
                 MASTER_PORT=str(port))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *map(str, args)], cwd=root,
                            env={**env, **slurm}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    LOG_PATH.parent.mkdir(exist_ok=True)
    (LOG_PATH.parent / f'dp_{label}.log').write_text(out + '\n' + err)
    require(proc.returncode == 0,
            f'{label}: exit {proc.returncode} after {seconds:.0f} s; '
            f'stderr tail: {err[-2000:]}')
    return slurm, seconds


def scalars(work: Path):
    return [json.loads(line) for line in
            (work / 'scalars.jsonl').read_text().splitlines()
            if 'sec_per_iter' in line]


def dp_test_argv(ckpt: Path, work: Path, flags=(), options=()):
    """tools/test.py's arguments on `ckpt`: the flagship config with phase
    12's synthetic val set as its test set."""
    ds = dict(type='SyntheticGroundingDataset', n_points=100_000,
              n_views=20, img_size=480, length=2, test_mode=True)
    root = Path(__file__).resolve().parent
    return [str(root / FLAGSHIP_CONFIG), str(ckpt), '--work-dir', str(work),
            *flags, '--cfg-options', f'test_dataloader.dataset={ds!r}',
            'test_dataloader.num_workers=0', *options]


OCC_DP_B = 4              # 19e's host batch: 2 a rank on 2 ranks
OCC_DP_STEPS = 2


@contextmanager
def recording_first_step(rec):
    """While open, the Runner's first train step records into `rec` its
    metrics, its batch's rows, every trained parameter after the update
    (flat, on the host) and every running statistic."""
    from proxytransformation_torch.engine import runner as runner_mod
    make_train_step = runner_mod.make_train_step

    def recording_make_train_step(model, optimizer, schedule=None):
        step = make_train_step(model, optimizer, schedule)

        def train_step(batch, generator=None):
            metrics = step(batch, generator)
            if not rec:
                rec.update(
                    metrics={k: float(v) for k, v in metrics.items()},
                    rows=int(batch['imgs'].shape[0]),
                    params=trainable_flat(model).cpu(),
                    stats=torch.cat([b.detach().reshape(-1) for n, b in
                                     model.named_buffers()
                                     if 'running' in n]).cpu())
            return metrics
        return train_step

    runner_mod.make_train_step = recording_make_train_step
    try:
        yield
    finally:
        runner_mod.make_train_step = make_train_step


def occ_dp_run(work: Path, flags) -> dict:
    """19e: the occupancy config through `tools/train.py main` at host
    batch OCC_DP_B (OCC_DP_STEPS steps, val one scene a batch) in this
    process: one process, or a rank of the group it holds (`flags`
    `--launcher pytorch`). The first step's record, the losses, s/it and
    the peak memory; no kernel of csrc/ may launch."""
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import train as train_cli
    rec = {}
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with recording_first_step(rec):
        runner = train_cli.main(occupancy_argv(
            work, OCC_DP_B * OCC_DP_STEPS, batch_size=OCC_DP_B, val_batch=1,
            flags=flags))
    counts = _cuda.launch_counts()
    require(not any(counts.values()),
            f'a kernel of csrc/ launched on the occupancy path: {counts}')
    log_ = runner.train_log
    require(len(log_) == OCC_DP_STEPS and all(
        np.isfinite(v) for r in log_ for v in r.values()),
        f'occupancy under DP: {log_}')
    out = dict(rec, losses=[r['total_loss'] for r in log_],
               s_per_it=runner.train_timing['iter_s'],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del runner
    torch.cuda.empty_cache()
    return out


def occ_dp_rank(ctx, work: Path) -> dict:
    """19e's rank: the occupancy run in the group this rank holds, its
    first step against the one-process run's parameters and running
    statistics and against rank 0's."""
    from proxytransformation_torch.parallel import dist as pdist
    got = occ_dp_run(work / 'occ_dp', ('--launcher', 'pytorch', '--device',
                                        'cuda:0'))
    params, stats = got.pop('params'), got.pop('stats')
    ref_params = torch.load(work / 'occ_reference_params.pt')
    ref_stats = torch.load(work / 'occ_reference_stats.pt')
    theirs = params.clone()
    pdist.broadcast_tensors([theirs])
    return dict(got, max_param_diff=float((params - ref_params).abs().max()),
                max_stats_diff=float((stats - ref_stats).abs().max()),
                stats_max=float(ref_stats.abs().max()),
                ranks_equal=bool(torch.equal(theirs, params)))


def occ_dp_reference() -> dict:
    """19e's one process at host batch OCC_DP_B; its first step's
    parameters and running statistics go to the ranks."""
    one = occ_dp_run(DP_WORK / 'occ_one', ('--device', 'cuda'))
    torch.save(one.pop('params'), DP_WORK / 'occ_reference_params.pt')
    torch.save(one.pop('stats'), DP_WORK / 'occ_reference_stats.pt')
    one['val_results'] = json.loads(
        (DP_WORK / 'occ_one' / 'val_results.json').read_text())
    return one


def occ_dp_report(smi, one: dict, ranks) -> dict:
    """19e's checks and lines from the ranks' records beside one
    process's."""
    from proxytransformation_torch.utils.config import Config
    occ = [r['occupancy'] for r in ranks]
    lr = Config.fromfile(str(Path(__file__).resolve().parent / OCC_CONFIG))[
        'optim_wrapper']['optimizer']['lr']
    val = json.loads((DP_WORK / 'occ_dp' / 'val_results.json').read_text())
    keys = sorted(k for k in one['metrics'] if k != 'grad_norm')
    gaps = {k: abs(occ[0]['metrics'][k] - one['metrics'][k])
            / abs(one['metrics'][k]) for k in (*keys, 'grad_norm')}
    for r in occ:
        require(r['ranks_equal'] and r['rows'] == OCC_DP_B // 2,
                f'occupancy rank: rows {r["rows"]}, parameters equal to '
                f'rank 0\'s {r["ranks_equal"]}')
        require(r['metrics'] == occ[0]['metrics'],
                'the ranks report different occupancy metrics')
    require(one['rows'] == OCC_DP_B, f'one process: {one["rows"]} rows')
    # the same float32 function in another summation order: no discrete
    # choice, so rounding; Adam's first step moves an entry whose gradient
    # is at rounding level by ±lr either way
    require(max(gaps.values()) <= 1e-4,
            f'occupancy losses on 2 ranks against one process: {gaps}')
    require(occ[0]['max_param_diff'] <= 2.2 * lr,
            'occupancy parameters after the step farther from one '
            f'process\'s than Adam\'s first move: {occ[0]["max_param_diff"]}')
    require(occ[0]['max_stats_diff'] <= 1e-4 * (1 + occ[0]['stats_max']),
            f'occupancy running statistics: {occ[0]["max_stats_diff"]}')
    require(set(val) == set(one['val_results']),
            f'occupancy val keys {sorted(val)}')
    log(f'[dp] occupancy ({OCC_CONFIG}, float32, host batch {OCC_DP_B}, '
        f'{OCC_DP_STEPS} steps, val one scene a batch) on the two gloo '
        'ranks of (a) (2 rows a rank) against one process: the first '
        'step\'s relative gaps ' + ', '.join(
            f'{k} {v:.3g}' for k, v in gaps.items())
        + f' (one process total_loss {one["metrics"]["total_loss"]:.6f}, '
        f'2 ranks {occ[0]["metrics"]["total_loss"]:.6f}); largest parameter '
        f'difference after it {occ[0]["max_param_diff"]:.3g} (lr {lr:g}), '
        f'running statistics {occ[0]["max_stats_diff"]:.3g} of max '
        f'{occ[0]["stats_max"]:.3g}; both ranks hold the same parameters; '
        f's/it {occ[0]["s_per_it"]:.3f} on 2 ranks beside '
        f'{one["s_per_it"]:.3f} on one process; peak '
        + ', '.join(f'rank {i} {r["peak_gib"]:.2f} GiB'
                    for i, r in enumerate(occ))
        + f' (one process {one["peak_gib"]:.2f} GiB); val mIoU '
        f'{val["mIoU"]:.5f} / IoU_geo {val["IoU_geo"]:.5f} on 2 ranks, '
        f'{one["val_results"]["mIoU"]:.5f} / '
        f'{one["val_results"]["IoU_geo"]:.5f} on one process; no kernel of '
        f'csrc/ launched ({smi})')
    return dict(one=one, ranks=occ, gaps=gaps, val_results=val, lr=lr)


def dp_phases(smi):
    """Phase 19: data parallelism. (a) the float32 step at global B=4 on
    one process twice, then on two gloo ranks sharing the card, every
    kernel call of rank 0's step checked; (b) the flagship config through
    `tools.train --launcher pytorch --amp` on the two ranks (an epoch of
    2 steps, val, a checkpoint, `--resume auto` for one more), then
    `tools.test --launcher pytorch` against one process's; (c) NCCL at
    world size 1 through the train CLI, by torchrun and by SLURM's
    variables; (d) their times; (e) occupancy
    on one process and in the ranks of (a)."""
    from proxytransformation_torch.tools import test as test_cli
    t_phase = time.perf_counter()
    shutil.rmtree(DP_WORK, ignore_errors=True)
    DP_WORK.mkdir(parents=True)
    torch.cuda.empty_cache()

    # (a) step parity
    ref = dp_reference()
    log(f'[dp] one process, float32, global B={DP_B}, the same weights '
        f'twice: total_loss {ref["metrics"][0]["total_loss"]:.6f} / '
        f'{ref["metrics"][1]["total_loss"]:.6f}, grad_norm '
        f'{ref["metrics"][0]["grad_norm"]:.6f} / '
        f'{ref["metrics"][1]["grad_norm"]:.6f}; largest parameter difference '
        f'after the step between the two runs {ref["self_dist"]:.3g} '
        f'({ref["n_params"]} trained parameters); step '
        + ', '.join(f'{ms:.1f}' for ms in ref['step_ms'])
        + f' ms of CUDA events; peak {ref["peak_gib"]:.2f} GiB ({smi})')
    occ_one = occ_dp_reference()
    _, step_s = torchrun(2, [Path(__file__).resolve(), '--dp-step', DP_WORK],
                         'step')
    ranks = [json.loads((DP_WORK / f'rank{r}.json').read_text())
             for r in range(2)]
    r0 = ranks[0]
    for r in ranks:
        require(r['ranks_equal'], f'rank {r["rank"]}: parameters differ '
                                  'from rank 0\'s after the step')
        require(r['metrics'] == r0['metrics'], 'the ranks report different '
                                               'metrics')
    for name in DP_KERNELS:
        require(r0['counts'][name] > 0 and r0['per_step'][name] > 0,
                f'{name}: not launched by rank 0\'s data-parallel step')
    one = ref['metrics'][0]
    sd = [r['stages'] for r in ranks]
    log(f'[dp] the first step\'s stages against one process\'s rows: '
        f'preshape offsets (before the second ball query, the first '
        f'discrete choice) max abs diff {max(d["offsets_max_abs"] for d in sd):.3g}'
        f' of max {max(d["offsets_max"] for d in sd):.3g}; level-0 voxel keys '
        f'differing {sum(d["keys_differing"] for d in sd)} of '
        f'{sum(d["keys"] for d in sd)}; one process against itself: offsets '
        f'{ref["self_stages"]["offsets_max_abs"]:.3g}, keys differing '
        f'{ref["self_stages"]["keys_differing"]}')
    log(f'[dp] two gloo ranks on cuda:0, B=2 each, the same weights and '
        f'global dropout draws: total_loss {r0["metrics"]["total_loss"]:.6f}'
        f' (one process {one["total_loss"]:.6f}), grad_norm '
        f'{r0["metrics"]["grad_norm"]:.6f} ({one["grad_norm"]:.6f}), '
        + ', '.join(f'{k} {v:.6f} ({one[k]:.6f})'
                    for k, v in r0['metrics'].items()
                    if k not in ('total_loss', 'grad_norm'))
        + f'; largest parameter difference to the one-process step '
        f'{r0["max_param_diff"]:.3g} (rank 1: {ranks[1]["max_param_diff"]:.3g})'
        f' beside the one-process run\'s distance to itself '
        f'{ref["self_dist"]:.3g}; both ranks hold the same parameters; '
        f'kernel calls of rank 0\'s step {r0["per_step"]} ({step_s:.1f} s '
        'with the launch)')
    # the same function in another summation order: Adam's first step
    # moves an entry whose gradient is at rounding level by ±lr either way
    from proxytransformation_torch.engine.train import BASE_LR
    require(r0['max_param_diff'] <= 2.2 * BASE_LR + 10 * ref['self_dist'],
            'the data-parallel step is farther from the one-process step '
            'than Adam\'s first move and the card\'s run-to-run distance '
            'allow')
    # up to the first discrete choice the ranks compute the one-process
    # values to float32 rounding (the global norms' sums in another order)
    for d in sd:
        require(d['offsets_max_abs'] <= 1e-4 * (1 + d['offsets_max']),
                f'preshape offsets on 2 ranks differ from one process: {d}')

    occupancy = occ_dp_report(smi, occ_one, ranks)

    # (b) the Runner on two ranks, then the test CLI on two and on one
    work = DP_WORK / 'runner'
    flags = ('--launcher', 'pytorch', '--device', 'cuda:0')
    err, train_s = torchrun(2, ['-m', 'proxytransformation_torch.tools.train',
                                *runner_argv(work, 1, 0, batch_size=DP_B,
                                             flags=flags, options=GLOO)],
                            'runner')
    epoch1 = scalars(work)
    require(len(epoch1) == 2 and (work / 'ckpt_00000002').is_dir()
            and (work / 'val_results.json').is_file(),
            f'the 2-rank runner: {epoch1}, {sorted(p.name for p in work.iterdir())}')
    require(err.count('saved checkpoint') == 1, 'rank 0 alone saves')
    err, resume_s = torchrun(2, ['-m', 'proxytransformation_torch.tools.train',
                                 *runner_argv(work, 2, 0, resume=True,
                                              batch_size=DP_B, flags=flags,
                                              options=GLOO)], 'resume')
    epoch2 = scalars(work)[len(epoch1):]
    require('resuming from' in err and len(epoch2) == 2
            and (work / 'ckpt_00000004').is_dir(),
            f'the 2-rank resume: {epoch2}')
    ckpt = work / 'ckpt_00000004'
    _, test_s = torchrun(2, ['-m', 'proxytransformation_torch.tools.test',
                             *dp_test_argv(ckpt, DP_WORK / 'test_dp', flags,
                                           GLOO)], 'test')
    t0 = time.perf_counter()
    test_cli.main(dp_test_argv(ckpt, DP_WORK / 'test_one', ('--device',
                                                             'cuda')))
    one_test_s = time.perf_counter() - t0
    dp_results, one_results = (
        {name: json.loads((DP_WORK / d / name).read_text())
         for name in ('val_results.json', 'test_results.json')}
        for d in ('test_dp', 'test_one'))
    # the config's test evaluator dumps each sample's top-20 boxes in the
    # loader's order (format_only): the gather's order and every box
    require(dp_results == one_results and len(
        dp_results['test_results.json']) == 2,
            f'the 2-rank test {dp_results} != one process {one_results}')
    log(f'[dp] tools.train --launcher pytorch --amp (remat) on 2 gloo ranks, '
        f'host batch {DP_B}: epoch 1 ({len(epoch1)} steps, val on both '
        f'ranks, a checkpoint from rank 0) in {train_s:.1f} s, --resume auto '
        f'epoch 2 in {resume_s:.1f} s, losses '
        + ', '.join(f'{r["total_loss"]:.5f}' for r in epoch1 + epoch2)
        + f'; tools.test --launcher pytorch on ckpt_00000004 in '
        f'{test_s:.1f} s: val_results.json '
        f'{dp_results["val_results.json"]} and test_results.json (the config\'s '
        f'format_only dump: 2 samples, their top-20 boxes and scores in loader '
        f'order) equal to one process\'s ({one_test_s:.1f} s)')

    # (c) NCCL at world size 1
    nccl = DP_WORK / 'nccl'
    _, nccl_s = torchrun(1, ['-m', 'proxytransformation_torch.tools.train',
                             *runner_argv(nccl, 1, 0, batch_size=DP_B,
                                          flags=('--launcher', 'pytorch'),
                                          options=(
                                              'train_cfg.val_interval=2',
                                              'env_cfg.dist_cfg.timeout='
                                              f'{DP_TIMEOUT_S}'))], 'nccl')
    nccl_log = scalars(nccl)
    require(len(nccl_log) == 2 and (nccl / 'ckpt_00000002').is_dir(),
            f'the NCCL run: {nccl_log}')
    log(f'[dp] tools.train --launcher pytorch, default backend nccl, world '
        f'size 1, --amp, host batch {DP_B}: 2 steps and a checkpoint in '
        f'{nccl_s:.1f} s, losses '
        + ', '.join(f'{r["total_loss"]:.5f}' for r in nccl_log))

    # (c) again through --launcher slurm: the context of one task of a
    # one-node step is torchrun's world-size-1 context, and its two steps
    # are the --launcher pytorch run's
    import os
    from proxytransformation_torch.parallel import dist as pdist
    from proxytransformation_torch.parallel.launch import (launcher_context,
                                                           rank_device)
    slurm_dir = DP_WORK / 'nccl_slurm'
    env, slurm_s = slurm_task(
        ['-m', 'proxytransformation_torch.tools.train',
         *runner_argv(slurm_dir, 1, 0, batch_size=DP_B,
                      flags=('--launcher', 'slurm'),
                      options=('train_cfg.val_interval=2',
                               f'env_cfg.dist_cfg.timeout={DP_TIMEOUT_S}'))],
        'nccl_slurm')
    saved = dict(os.environ)
    try:
        os.environ.update(env)
        slurm_ctx, rendezvous = launcher_context('slurm', {})
        for k in env:
            os.environ.pop(k)
        os.environ.update(WORLD_SIZE='1', RANK='0', LOCAL_RANK='0',
                          LOCAL_WORLD_SIZE='1', GROUP_RANK='0')
        torchrun_ctx = pdist.env_context()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    require(slurm_ctx == torchrun_ctx == pdist.DistContext(1, 0, 0, 1, 0)
            and rank_device(slurm_ctx, None, 'nccl') == 'cuda:0'
            and rendezvous == f'tcp://localhost:{env["MASTER_PORT"]}',
            f'--launcher slurm: {slurm_ctx}, {rendezvous}; torchrun: '
            f'{torchrun_ctx}')
    slurm_log = scalars(slurm_dir)
    require(len(slurm_log) == 2 and (slurm_dir / 'ckpt_00000002').is_dir(),
            f'the --launcher slurm run: {slurm_log}')
    loss_keys = [k for k in nccl_log[0] if 'loss' in k or k == 'grad_norm']

    def apart(step):
        return {k: abs(slurm_log[step][k] - nccl_log[step][k])
                / max(abs(nccl_log[step][k]), 1e-12) for k in loss_keys}

    # the second step is reported, not held: the steps part run to run
    # from the second on (ROADMAP §3), and at this random initialisation a
    # bf16 loss moves by tens of percent between two runs
    step1, step2 = apart(0), max(apart(1).values())
    require(max(v for k, v in step1.items() if k != 'grad_norm') <= 1e-6
            and step1['grad_norm'] <= 1e-4,
            'the first step through --launcher slurm differs from '
            f'--launcher pytorch\'s: {step1}')
    log(f'[dp] tools.train --launcher slurm (SLURM_NTASKS=1, '
        f'SLURM_STEP_NODELIST=localhost, MASTER_PORT={env["MASTER_PORT"]}), '
        f'nccl, --amp, host batch {DP_B}: context {slurm_ctx} = torchrun\'s, '
        f'rank device cuda:0, rendezvous {rendezvous}; 2 steps in '
        f'{slurm_s:.1f} s, losses '
        + ', '.join(f'{r["total_loss"]:.5f}' for r in slurm_log)
        + f'; step 1 against --launcher pytorch\'s: {len(loss_keys) - 1} '
        f'losses {max(v for k, v in step1.items() if k != "grad_norm"):.3g} '
        f'relative apart at most, grad_norm {step1["grad_norm"]:.3g}; '
        f'step 2 {step2:.3g} at most (not held: steps part run to run from '
        'step 2 on, ROADMAP §3)')

    # (d) times
    st = r0['timed_collectives']
    log(f'[dp] times ({smi}; gloo stages every collective through the host '
        'and both ranks share one card: this is not NCCL across cards): '
        f's/it of the 2-rank runner {epoch1[-1]["sec_per_iter"]:.3f} (epoch '
        f'1), {epoch2[-1]["sec_per_iter"]:.3f} (epoch 2) beside one process '
        f'(NCCL, world size 1) {nccl_log[-1]["sec_per_iter"]:.3f} at global '
        f'B={DP_B}; the float32 step on 2 ranks '
        + ', '.join(f'{ms:.1f}' for ms in r0['step_ms'])
        + ' ms of CUDA events (rank 0; steps 1-3, the first captured, the '
        'third with the collectives synchronized) beside one process '
        + ', '.join(f'{ms:.1f}' for ms in ref['step_ms'])
        + f' ms; gradient all-reduce {st["grad_bytes"] / 1e6:.1f} MB and '
        f'{st["grad_s"] * 1e3:.1f} ms a step; norm collectives '
        f'{st["norm_calls"]} a step in {st["norm_s"] * 1e3:.1f} ms; other '
        f'collectives {st["other_calls"]} in {st["other_s"] * 1e3:.1f} ms; '
        'peak ' + ', '.join(f'rank {r["rank"]} {r["peak_gib"]:.2f} GiB'
                            for r in ranks)
        + f' (one process at B={DP_B}: {ref["peak_gib"]:.2f} GiB)')
    shutil.rmtree(DP_WORK, ignore_errors=True)
    log(f'[phase 19] in {time.perf_counter() - t_phase:.1f} s ({smi})')
    summary = dict(reference=ref, ranks=[{k: v for k, v in r.items()
                                          if k not in ('rows', 'occupancy')}
                                         for r in ranks],
                   runner_epochs=[epoch1, epoch2], nccl=nccl_log,
                   nccl_slurm=slurm_log,
                   test_results=dp_results['val_results.json'],
                   occupancy=occupancy,
                   seconds=dict(step=step_s, train=train_s, resume=resume_s,
                                test=test_s, one_test=one_test_s,
                                nccl=nccl_s, nccl_slurm=slurm_s))
    return dict(rows=r0['rows'], counts=r0['counts'],
                per_step=r0['per_step'], summary=summary)


# --------------------------------------------------------------------------
# 20. the library
# --------------------------------------------------------------------------
LIB_RTOL = 1e-4           # the card against the CPU, · (1 + max|cpu|)
LIB_FACE_M = 1e-5         # a mask may differ only this close to a face


def to_cpu_level(lvl):
    """A SparseLevel with its tensors on the host."""
    return lvl._replace(keys=lvl.keys.cpu(), coords=lvl.coords.cpu(),
                        feats=lvl.feats.cpu(), mask=lvl.mask.cpu(),
                        origin=lvl.origin.cpu())


def library_boxes():
    """100k points in a 10 x 10 x 3 m room, 256 boxes of 0.2-2 m in it
    with random yaw, pitch and roll."""
    rng = np.random.RandomState(20)
    pts = rng.uniform([-5, -5, 0], [5, 5, 3], (100_000, 3)).astype(
        np.float32)
    boxes = np.zeros((256, 9), np.float32)
    boxes[:, :3] = rng.uniform([-4, -4, 0.2], [4, 4, 2.5], (256, 3))
    boxes[:, 3:6] = rng.uniform(0.2, 2.0, (256, 3))
    boxes[:, 6:9] = rng.uniform(-np.pi, np.pi, (256, 3)) * [1, 0.2, 0.2]
    return pts, boxes


def face_margin(pts: np.ndarray, boxes: np.ndarray, pairs) -> np.ndarray:
    """For each (point, box) pair, in float64: how far the point lies from
    the box's surface along its nearest face normal, max over axes of
    |local| - dims / 2 (> 0 outside)."""
    from proxytransformation_torch.structures.rotation import (
        euler_angles_to_matrix)
    p, b = pairs
    rot = euler_angles_to_matrix(torch.from_numpy(
        boxes[b, 6:9]).double()).numpy()
    rel = pts[p].astype(np.float64) - boxes[b, :3]
    local = np.einsum('ni,nij->nj', rel, rot)
    return np.max(np.abs(local) - boxes[b, 3:6] / 2, axis=-1)


def library_phase(smi, flagship_req_ms):
    """Phase 20: the structures and models/misc.py modules at realistic
    sizes on the card against the same call on the CPU, their CUDA-event
    ms, and `chained_ms_per_iter` of a flagship request."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape, batch_to_device)
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.models.layers import random_init_
    from proxytransformation_torch.models.misc import (ChannelMapper,
                                                       TransformerEncoder)
    from proxytransformation_torch.models.sparse_resnet import MinkResNet
    from proxytransformation_torch.structures.boxes import (EulerBoxes,
                                                            points_in_boxes)
    from proxytransformation_torch.utils.timing import chained_ms_per_iter
    t_phase = time.perf_counter()
    ms, errs = {}, {}

    def card_vs_cpu(name, card_fn, cpu_fn):
        with torch.no_grad():
            ms[name] = cuda_ms(card_fn, 3)[0]
            return card_fn(), cpu_fn()

    # points_in_boxes, EulerBoxes.overlaps
    pts, boxes = library_boxes()
    card_pts, cpu_pts = torch.from_numpy(pts).cuda(), torch.from_numpy(pts)
    card_boxes = EulerBoxes(boxes, device='cuda')
    cpu_boxes = EulerBoxes(boxes, device='cpu')
    got, want = card_vs_cpu(
        'points_in_boxes',
        lambda: points_in_boxes(card_pts, card_boxes.tensor[:64]),
        lambda: points_in_boxes(cpu_pts, cpu_boxes.tensor[:64]))
    differ = np.nonzero((got.cpu() != want).numpy())
    margin = face_margin(pts, boxes, differ)
    require(got.dtype == torch.bool and tuple(got.shape) == (100_000, 64)
            and bool(want.any()),
            f'points_in_boxes: {got.dtype} {tuple(got.shape)}')
    require(bool(np.all(np.abs(margin) <= LIB_FACE_M)),
            f'points_in_boxes: the card and the CPU differ away from a '
            f'face: {np.abs(margin).max() if margin.size else 0}')
    errs['points_in_boxes'] = (f'{len(differ[0])} of {got.numel()} pairs '
                               f'differ, all within {LIB_FACE_M:g} m of a '
                               f'face; {int(want.sum())} inside')
    got, want = card_vs_cpu('EulerBoxes.overlaps',
                            lambda: card_boxes.overlaps(card_boxes),
                            lambda: cpu_boxes.overlaps(cpu_boxes))
    err = float((got.cpu() - want).abs().max())
    require(tuple(got.shape) == (256, 256) and err <= LIB_RTOL,
            f'EulerBoxes.overlaps: card vs CPU {err}')
    errs['EulerBoxes.overlaps'] = (f'max abs err {err:.3g}; '
                                   f'{int((want > 0).sum())} pairs overlap')

    # TransformerEncoder at its defaults, a padded batch
    cpu_enc = random_init_(TransformerEncoder(device='cpu'),
                           torch.Generator().manual_seed(20))
    card_enc = TransformerEncoder(device='cuda')
    card_enc.load_state_dict(cpu_enc.state_dict())
    x = torch.randn(2, 4096, 256, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 4096, dtype=torch.bool)
    mask[1, 3000:] = False
    card_x, card_mask = x.cuda(), mask.cuda()
    got, want = card_vs_cpu('TransformerEncoder',
                            lambda: card_enc(card_x, card_mask),
                            lambda: cpu_enc(x, mask))
    err = float((got.cpu() - want).abs().max())
    require(bool(torch.isfinite(got).all())
            and err <= LIB_RTOL * (1 + float(want.abs().max())),
            f'TransformerEncoder: card vs CPU {err}')
    errs['TransformerEncoder'] = f'max abs err {err:.3g}'
    del cpu_enc, card_enc, x, card_x, got, want
    torch.cuda.empty_cache()

    # ChannelMapper on the flagship's four MinkResNet-34 levels
    backbone = MinkResNet(34, 3)
    flax_init_(backbone, torch.Generator().manual_seed(0))
    backbone = backbone.cuda().eval()
    with torch.no_grad():
        levels = backbone(flagship_level0())[0]
    widths = [int(lvl.feats.shape[-1]) for lvl in levels]
    cpu_map = random_init_(ChannelMapper(widths, 256, device='cpu'),
                           torch.Generator().manual_seed(21))
    card_map = ChannelMapper(widths, 256, device='cuda')
    card_map.load_state_dict(cpu_map.state_dict())
    cpu_levels = [to_cpu_level(lvl) for lvl in levels]
    got, want = card_vs_cpu('ChannelMapper', lambda: card_map(levels),
                            lambda: cpu_map(cpu_levels))
    err = max(float((g.feats.cpu() - w.feats).abs().max()
                    / (1 + float(w.feats.abs().max())))
              for g, w in zip(got, want))
    require(widths == [64, 128, 256, 512] and err <= LIB_RTOL,
            f'ChannelMapper on widths {widths}: card vs CPU {err}')
    errs['ChannelMapper'] = (f'widths {widths} to 256, voxels '
                             f'{[int(lvl.mask.sum()) for lvl in levels]}, '
                             f'max abs err / (1 + max) {err:.3g}')
    del backbone, levels, cpu_levels, cpu_map, card_map, got, want
    torch.cuda.empty_cache()

    # a flagship request timed by chained_ms_per_iter
    model = SparseFeatureFusion3DGrounderPreshape(
        device='cuda').random_init_(0)
    batch = batch_to_device(flagship_batch(seed=0), 'cuda')

    def request(i, state):
        with torch.no_grad():
            model(state)
        return state

    chained = chained_ms_per_iter(request, batch)
    require(np.isfinite(chained) and chained > 0,
            f'chained_ms_per_iter: {chained}')
    del model, batch
    torch.cuda.empty_cache()
    for name in ms:
        log(f'[library] {name}: ' + ', '.join(f'{m:.3f}' for m in ms[name])
            + f' ms of CUDA events on the card; card vs CPU: {errs[name]}')
    log(f'[library] chained_ms_per_iter of a flagship request (B=2, '
        f'float32; chains of 2 and 6, best of 2): {chained:.1f} ms a '
        'request beside phase 5\'s ' + ', '.join(
            f'{m:.1f}' for m in flagship_req_ms) + ' ms of CUDA events')
    log(f'[phase 20] in {time.perf_counter() - t_phase:.1f} s ({smi})')
    return dict(ms=ms, card_vs_cpu=errs, chained_request_ms=chained,
                flagship_request_ms=flagship_req_ms)


# phase 21: the visualizer and the explorer
VIZ_IOU = 0.15            # the visualizer's NMS threshold
VIZ_IOU_MARGIN = 1e-5     # an IoU this close to it may fall either side
VIZ_RTOL = 1e-5
BACKPROJECT_VIEWS = 50
EXPLORER_VIEWS = 4        # view entries a scan of the explorer's infos pkl


def renderer_versions():
    """{package: installed version or None} of the renderers the
    visualizer imports when present (read without importing them)."""
    import importlib.metadata
    out = {}
    for name in ('matplotlib', 'open3d'):
        try:
            out[name] = importlib.metadata.version(name)
        except importlib.metadata.PackageNotFoundError:
            out[name] = None
    return out


def float32_ulps_apart(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| in float32 steps of the larger value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not want.size:
        return 0.0
    step = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got.astype(np.float64) - want) / step).max())


def ply_lines_close(got: bytes, want: bytes):
    """Two ASCII PLY files: (equal bytes, lines that differ); the files
    must hold the same lines but for the last printed digit of a
    coordinate (values a float32 step apart may print either side of a
    rounding edge)."""
    if got == want:
        return True, 0
    g, w = got.decode().splitlines(), want.decode().splitlines()
    require(len(g) == len(w), f'PLY files of {len(g)} and {len(w)} lines')
    differ = 0
    for a, b in zip(g, w):
        if a == b:
            continue
        differ += 1
        fa, fb = a.split(), b.split()
        require(len(fa) == len(fb) and all(
            x == y or ('.' in y and abs(float(x) - float(y)) <= 1.5e-4)
            for x, y in zip(fa, fb)), f'PLY lines differ: {a!r} vs {b!r}')
    return False, differ


def flagship_predictions():
    """The 256 boxes and scores of sample 0 of one float32 flagship request
    (seeded weights, batch seed 0)."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.models.detector import (
        SparseFeatureFusion3DGrounderPreshape, batch_to_device)
    model = SparseFeatureFusion3DGrounderPreshape(
        device='cuda').random_init_(0)
    with torch.no_grad():
        out = model(batch_to_device(flagship_batch(seed=0), 'cuda'))
    boxes = out['bboxes_3d'][0].float().cpu().numpy()
    scores = out['scores_3d'][0].float().cpu().numpy()
    del model, out
    torch.cuda.empty_cache()
    return boxes, scores


def viz_nms_check(boxes, scores, work: Path):
    """The visualizer's NMS on the card against the CPU: (kept boxes,
    CUDA-event ms, boxes kept on one side only)."""
    from proxytransformation_torch.ops.box3d_overlap import box3d_iou
    from proxytransformation_torch.visualization import (
        EmbodiedScanBaseVisualizer)
    card = EmbodiedScanBaseVisualizer(REALDATA_CLASSES, str(work / 'card'))
    cpu = EmbodiedScanBaseVisualizer(REALDATA_CLASSES, str(work / 'cpu'),
                                     device='cpu')
    ms = cuda_ms(lambda: card._nms_filter(boxes, scores, VIZ_IOU), 3)[0]
    got = card._nms_filter(boxes, scores, VIZ_IOU)
    want = cpu._nms_filter(boxes, scores, VIZ_IOU)
    rows = {b.tobytes(): i for i, b in enumerate(boxes)}
    require(len(rows) == len(boxes), 'two predicted boxes are equal')
    kept = {s: np.zeros(len(boxes), bool) for s in ('card', 'cpu')}
    for side, out in (('card', got), ('cpu', want)):
        kept[side][[rows[b.tobytes()] for b in out]] = True
    differ = np.nonzero(kept['card'] != kept['cpu'])[0]
    if len(differ):
        iou = box3d_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))
        near = (iou - VIZ_IOU).abs().numpy() < VIZ_IOU_MARGIN
        np.fill_diagonal(near, False)
        require(bool(near[differ].any(1).all()),
                f'NMS keeps differ on boxes {differ.tolist()} with no IoU '
                f'within {VIZ_IOU_MARGIN} of {VIZ_IOU}')
    require(0 < len(want) < len(boxes), f'NMS kept {len(want)} boxes')
    return got, ms, len(differ)


def backprojection_views(fixtures: Path):
    """50 RGB-D views of 640x480 from the two fixture views, each under a
    pose of its own (turned about z and moved along x)."""
    from proxytransformation_torch.data.image_io import imread
    manifest = json.loads((fixtures / 'manifest.json').read_text())
    rgb = [imread(str(fixtures / v['image']))[..., ::-1]
           for v in manifest['views']]
    depth = [imread(str(fixtures / v['depth']), -1)
             for v in manifest['views']]
    views = []
    for i in range(BACKPROJECT_VIEWS):
        k = i % len(manifest['views'])
        pose = np.asarray(manifest['views'][k]['cam2global'], np.float64)
        c, s = np.cos(0.01 * i), np.sin(0.01 * i)
        pose = np.array([[c, -s, 0, 0.002 * i], [s, c, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]]) @ pose
        views.append({'img': rgb[k], 'depth': depth[k],
                      'intrinsic': np.asarray(manifest['cam2img']),
                      'cam2global': pose,
                      'depth_shift': float(manifest['depth_shift']),
                      'visible_instance_ids': [i % 3]})
    return views, np.asarray(manifest['boxes'], np.float32)


def viz_backprojection_check(fixtures: Path, work: Path):
    """`ContinuousDrawer.step` x 50 on the card against the CPU: every
    step's new points within one float32 step, the boxes, labels and view
    index equal. Returns (card step ms, CPU step ms, back-projection
    CUDA-event ms, final points, worst float32 steps apart)."""
    from proxytransformation_torch.visualization import ContinuousDrawer
    from proxytransformation_torch.visualization.continuous_drawer import (
        _backproject)
    views, boxes = backprojection_views(fixtures)
    kw = dict(boxes=boxes, labels=[0, 1, 2], classes=REALDATA_CLASSES)
    card = ContinuousDrawer(views, save_dir=str(work / 'card'), **kw)
    cpu = ContinuousDrawer(views, save_dir=str(work / 'cpu'), device='cpu',
                           **kw)
    card_ms, cpu_ms, worst, done = [], [], 0.0, 0
    for i in range(BACKPROJECT_VIEWS):
        t0 = time.perf_counter()
        got = card.step()
        t1 = time.perf_counter()
        want = cpu.step()
        card_ms.append((t1 - t0) * 1e3)
        cpu_ms.append((time.perf_counter() - t1) * 1e3)
        g, w = got['points'], want['points']
        require(g.dtype == w.dtype == np.float32 and g.shape == w.shape,
                f'step {i}: clouds {g.dtype} {g.shape} vs {w.dtype} '
                f'{w.shape}')
        worst = max(worst, float32_ulps_apart(g[done:], w[done:]))
        require(worst <= 1, f'step {i}: the card\'s cloud is {worst} '
                'float32 steps from the CPU\'s')
        require(got['view_index'] == want['view_index'] == i
                and np.array_equal(got['boxes'], want['boxes'])
                and np.array_equal(got['labels'], want['labels']),
                f'step {i}: boxes, labels or view index differ')
        done = len(w)
    require(card.step() is None and cpu.step() is None,
            'a drawer went past its views')
    v = views[0]
    bp_ms = cuda_ms(lambda: _backproject(
        v['img'], v['depth'], np.asarray(v['intrinsic'], np.float32),
        np.asarray(v['cam2global'], np.float32), v['depth_shift'],
        device='cuda'), 3)[0]
    return card_ms, cpu_ms, bp_ms, done, worst


def explorer_infos(data_root: Path) -> Path:
    """Phase 13's train infos with absolute paths (the explorer reads
    absolute paths), its ScanNet and Matterport scans, the first
    EXPLORER_VIEWS view entries of each, and the instances each view sees
    (two a view)."""
    import pickle
    with open(data_root / 'embodiedscan_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    infos['data_list'] = [d for d in infos['data_list']
                          if d['sample_idx'] != RSCAN_SCAN]
    for d in infos['data_list']:
        d['images'] = d['images'][:EXPLORER_VIEWS]
        n = len(d['instances'])
        for k, im in enumerate(d['images']):
            for key in ('img_path', 'depth_path'):
                im[key] = str(data_root / im[key])
            im['visible_instance_ids'] = [k % n, (k + 1) % n]
    path = data_root / 'explorer_infos.pkl'
    with open(path, 'wb') as f:
        pickle.dump(infos, f)
    return path


@contextmanager
def ply_frames():
    """Without matplotlib the headless render writes each frame as PLY
    instead: the cloud (as the PNG would sample it) through `export_ply`
    and the boxes' wireframes through `LineMesh.save_ply`."""
    from proxytransformation_torch.visualization import (
        EmbodiedScanBaseVisualizer, LineMesh, box_lines)

    def render(self, points, boxes, labels, name):
        out = self.export_ply(points[::max(len(points) // 20000, 1)], name)
        if boxes is not None and len(boxes):
            segs = box_lines(boxes, self.device).reshape(-1, 3)
            LineMesh(segs, lines=np.arange(len(segs)).reshape(-1, 2)
                     ).save_ply(str(Path(self.save_dir) / f'{name}_boxes.ply'))
        return out

    saved = EmbodiedScanBaseVisualizer._render_matplotlib
    EmbodiedScanBaseVisualizer._render_matplotlib = render
    try:
        yield
    finally:
        EmbodiedScanBaseVisualizer._render_matplotlib = saved


def viz_explorer_check(data_root: Path, work: Path, have_mpl: bool):
    """The explorer on phase 13's tree, on the card and on the CPU: equal
    listings, `show_image(render_box=True)` hashes, and the headless
    continuous render of the ScanNet scan (PNG, or PLY without
    matplotlib). Returns its summary."""
    import hashlib
    from proxytransformation_torch.data.image_io import decode_png
    from proxytransformation_torch.explorer import EmbodiedScanExplorer
    ann = str(explorer_infos(data_root))
    ex = {'card': EmbodiedScanExplorer(str(data_root), [ann],
                                       save_dir=str(work / 'ex_card')),
          'cpu': EmbodiedScanExplorer(str(data_root), [ann],
                                      save_dir=str(work / 'ex_cpu'),
                                      device='cpu')}
    scans = ex['cpu'].list_scenes()
    require(len(scans) == 2, f'explorer lists {scans}')

    def listing(e):
        return {'scenes': e.list_scenes(), 'count': e.count_scenes(),
                'stats': e.category_statistics(),
                'categories': e.list_categories(),
                'info': [e.scene_info(s) for s in scans],
                'cameras': [e.list_cameras(s) for s in scans],
                'instances': [[(i['name'], i['bbox_3d'].tolist())
                               for i in e.list_instances(s)] for s in scans]}

    lists = {side: listing(e) for side, e in ex.items()}
    require(lists['card'] == lists['cpu'], 'explorer listings differ')
    hashes = {}
    for scan in scans:
        imgs = {side: e.show_image(scan, 'view0', render_box=True)
                for side, e in ex.items()}
        hashes[scan] = {side: hashlib.sha256(img.tobytes()).hexdigest()
                        for side, img in imgs.items()}
        plain = ex['cpu'].show_image(scan, 'view0')
        require(hashes[scan]['card'] == hashes[scan]['cpu']
                and imgs['cpu'].shape == (480, 640, 3)
                and not np.array_equal(plain, imgs['cpu']),
                f'{scan}: show_image(render_box=True) differs on the card '
                'or draws nothing')
    scannet = scans[0]
    outs, t_render = {}, {}
    with nullcontext() if have_mpl else ply_frames():
        for side, e in ex.items():
            t0 = time.perf_counter()
            outs[side] = e.render_continuous_scene(scannet)
            t_render[side] = time.perf_counter() - t0
    rel = {side: [str(Path(p).relative_to(work / f'ex_{side}'))
                  for p in o] for side, o in outs.items()}
    require(rel['card'] == rel['cpu'] and len(rel['cpu']) == EXPLORER_VIEWS,
            f'render_continuous_scene: {rel}')
    files = sorted(p.name for p in (work / 'ex_cpu').iterdir())
    require(files == sorted(p.name for p in (work / 'ex_card').iterdir()),
            'the card and the CPU rendered other files')
    equal, differ_lines = 0, 0
    for name in files:
        got = (work / 'ex_card' / name).read_bytes()
        want = (work / 'ex_cpu' / name).read_bytes()
        if name.endswith('.png'):
            require(decode_png(got).shape == decode_png(want).shape,
                    f'{name}: PNGs of other sizes')
            equal += got == want
        else:
            same, n = ply_lines_close(got, want)
            equal += same
            differ_lines += n
    return dict(listing=lists['cpu'], show_image_sha256={
        scan: hashes[scan]['cpu'] for scan in scans}, files=files,
        byte_equal=equal, ply_lines_differ=differ_lines,
        render_s=t_render, format='png' if have_mpl else 'ply')


def viz_phase(smi, data_root: Path):
    """Phase 21: the visualizer's NMS, box corners and back-projection,
    and the explorer on phase 13's tree, on the card against the CPU."""
    from proxytransformation_torch.visualization import nine_dof_to_corners
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix='chip_smoke_viz_'))
    try:
        versions = renderer_versions()
        log('[viz] renderers: ' + ', '.join(
            f'{k} {v or "absent"}' for k, v in versions.items())
            + ('' if versions['matplotlib'] else
               ' (no headless PNG: the continuous render below writes PLY '
               'frames through export_ply and LineMesh.save_ply)'))
        boxes, scores = flagship_predictions()
        require(boxes.shape == (256, 9) and scores.shape == (256, ),
                f'flagship predictions {boxes.shape} {scores.shape}')
        kept, nms_ms, near = viz_nms_check(boxes, scores, work)
        log(f'[viz] NMS of one flagship request\'s 256 boxes at IoU '
            f'{VIZ_IOU}: {len(kept)} kept, equal on the card and the CPU '
            f'but for {near} boxes with an IoU within {VIZ_IOU_MARGIN:g} of '
            f'it; ' + ', '.join(f'{m:.2f}' for m in nms_ms)
            + f' ms of CUDA events on the card ({smi})')
        got = nine_dof_to_corners(kept)
        want = nine_dof_to_corners(kept, 'cpu')
        err = float(np.abs(got - want).max())
        require(got.shape == (len(kept), 8, 3)
                and err <= VIZ_RTOL * (1 + float(np.abs(want).max())),
                f'corners: card vs CPU {err}')
        log(f'[viz] corners of the {len(kept)} kept boxes: card vs CPU '
            f'max abs err {err:.3g}')
        fixtures = Path(__file__).resolve().parent / FIXTURES
        card_ms, cpu_ms, bp_ms, n_pts, worst = viz_backprojection_check(
            fixtures, work)
        log(f'[viz] ContinuousDrawer.step x {BACKPROJECT_VIEWS} (640x480 '
            f'RGB-D views): every cloud within {worst:g} float32 steps of '
            f'the CPU\'s; {np.mean(card_ms):.1f} ms a step on the card '
            f'(first {card_ms[0]:.1f}, last {card_ms[-1]:.1f}; host wall '
            f'time, the growing cloud\'s concatenation included) beside '
            f'{np.mean(cpu_ms):.1f} on the CPU; the back-projection alone '
            + ', '.join(f'{m:.2f}' for m in bp_ms) + ' ms of CUDA events; '
            f'final cloud {n_pts} points ({smi})')
        explorer = viz_explorer_check(data_root, work,
                                      bool(versions['matplotlib']))
        log(f'[viz] explorer on phase 13\'s tree: listings equal '
            f'({explorer["listing"]["count"]} scans, '
            f'{explorer["listing"]["stats"]}); show_image(render_box=True) '
            f'sha256 equal on the card and the CPU: '
            + ', '.join(f'{s} {h[:16]}' for s, h in
                        explorer['show_image_sha256'].items()))
        log(f'[viz] render_continuous_scene ({EXPLORER_VIEWS} views, '
            f'{explorer["format"]}): {len(explorer["files"])} files, '
            f'{explorer["byte_equal"]} byte-equal on the card and the CPU, '
            f'{explorer["ply_lines_differ"]} PLY lines a last digit apart; '
            f'{explorer["render_s"]["card"]:.1f} s on the card, '
            f'{explorer["render_s"]["cpu"]:.1f} s on the CPU')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f'[phase 21] in {seconds:.1f} s ({smi})')
    return dict(renderers=versions, nms_kept=len(kept), nms_ms=nms_ms,
                nms_near_threshold=near, corners_max_abs_err=err,
                step_ms=card_ms, cpu_step_ms=cpu_ms, backproject_ms=bp_ms,
                final_points=n_pts, max_float32_steps=worst,
                explorer=explorer, seconds=seconds)


# --------------------------------------------------------------------------
# 22. the 2D ResNet at depth 101 (the grounder) and 18 / 34 (occupancy)
# --------------------------------------------------------------------------
OCC_DEPTHS = (18, 34)
OCC_CARD_RTOL = 1e-4     # card vs CPU logits, as `occ_small_input_check`


def resnet101_phase(flagship):
    """Phase 22a: the flagship config with `model.backbone.depth=101` at
    full width, flax's fresh weights: from launch counts of 0 three
    float32 requests (the first captured, the third's stages timed), then
    from 0 again one bf16 remat AdamW step (`--amp` on the config's
    remat) captured; every kernel call of the request and of the step
    held against its plain version; request ms, the 2D stage's device ms
    and peak memory beside phase 5's ResNet-50."""
    from proxytransformation_torch.data.synthetic import flagship_batch
    from proxytransformation_torch.engine.runner import (apply_amp,
                                                         build_model_from_cfg)
    from proxytransformation_torch.engine.train import (
        build_lr_schedule, build_optimizer, make_train_step)
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.utils.config import Config
    repo = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    cfg = Config.fromfile(str(repo / FLAGSHIP_CONFIG))
    cfg['model']['backbone'] = dict(cfg['model']['backbone'], depth=101)

    def build(model_cfg):
        model = build_model_from_cfg(dict(model_cfg), device='cuda')
        require(model.backbone.depth == 101
                and len(model.backbone.layer3) == 23
                and model.backbone.out_channels == (64, 128, 256, 512),
                'phase 22 did not build the ResNet-101 grounder')
        return model

    model = flax_init_(build(cfg['model']), torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    dev = torch.device('cuda')
    batches = [batch_to_device(flagship_batch(seed=r), dev) for r in range(3)]
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    req_ms, req_host_ms, calls = [], [], {}
    with torch.no_grad():
        for r, batch in enumerate(batches):
            out = {}
            fn = lambda: out.update(model(batch))  # noqa: E731
            if r == 0:
                calls = capture_kernel_calls(fn)
            else:
                d, h = cuda_ms(fn, 1)
                req_ms += d
                req_host_ms += h
            for k in ('bboxes_3d', 'scores_3d'):
                require(bool(torch.isfinite(out[k]).all()),
                        f'ResNet-101 request {r}: non-finite {k}')
            require(out['bboxes_3d'].shape == (2, out['scores_3d'].shape[1],
                                               9), 'boxes of another shape')
            require(bool(out['query_mask'].any()), 'no valid query')
        req_counts = _cuda.launch_counts()
        req_peak = torch.cuda.max_memory_allocated() / 2**30
        stages = stage_breakdown(model, batches[-1])
    per_request = {k: len(calls.get(k, ())) for k in RUNNER_KERNELS}
    for name in PREDICT_KERNELS:
        require(per_request[name] > 0 and
                req_counts[name] == 3 * per_request[name],
                f'{name}: {req_counts[name]} launches in the ResNet-101 '
                f'requests, {per_request[name]} captured a request')
    weights = model.state_dict()
    del model, batches
    torch.cuda.empty_cache()

    # the bf16 remat step (`--amp` on the config's remat=True), from the
    # same weights
    apply_amp(cfg)
    model = build(cfg['model'])
    model.load_state_dict(weights)
    del weights
    require(model.remat and model.remat_painting
            and model.compute_dtype == 'bfloat16', 'not the --amp model')
    model.train()
    step = make_train_step(model, build_optimizer(model),
                           build_lr_schedule(5e-4, steps_per_epoch=1))
    step_batch = batch_to_device(flagship_batch(seed=0, with_targets=True),
                                 dev)
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = {}
    t0 = time.perf_counter()
    step_calls = capture_kernel_calls(lambda: metrics.update(step(
        step_batch, torch.Generator(device=dev).manual_seed(0))))
    step_s = time.perf_counter() - t0
    step_counts = _cuda.launch_counts()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    model.eval()
    require(all(np.isfinite(float(v)) for v in metrics.values()),
            f'ResNet-101 bf16 step: {metrics}')
    per_step = {k: len(step_calls.get(k, ())) for k in RUNNER_KERNELS}
    for name in RUNNER_KERNELS:
        require(per_step[name] > 0 and step_counts[name] == per_step[name],
                f'{name}: {step_counts[name]} launches in the ResNet-101 '
                f'bf16 step, {per_step[name]} captured')
    joined = {k: calls.get(k, []) + step_calls.get(k, [])
              for k in RUNNER_KERNELS}
    del calls, step_calls, model, step, step_batch
    torch.cuda.empty_cache()
    with torch.no_grad():
        rows = check_calls(joined, RUNNER_KERNELS,
                           'the ResNet-101 request and bf16 step')
    del joined
    counts = {k: req_counts[k] + step_counts[k] for k in RUNNER_KERNELS}
    log(f'[resnet101] the flagship config with model.backbone.depth=101 '
        f'({n_params} parameters, flax init): float32 requests (B=2, 100k '
        f'points, 20 views at 480x480) 2 and 3: '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(req_host_ms, req_ms))
        + ' (request 1 captured); phase 5\'s ResNet-50 requests: '
        + ', '.join(f'{d:.1f}' for d in flagship['req_ms'])
        + f' ms of CUDA events; 2D stage {stages["backbone"]:.2f} ms of a '
        f'{stages["request"]:.1f} ms request (ResNet-50: '
        f'{flagship["stages"]["backbone"]:.2f} of '
        f'{flagship["stages"]["request"]:.1f}); peak {req_peak:.2f} GiB '
        f'(ResNet-50: {flagship["peak"]:.2f}); one bf16 remat AdamW step '
        f'{step_s * 1e3:.1f} ms (captured), total loss '
        f'{float(metrics["total_loss"]):.5f}, peak {step_peak:.2f} GiB; '
        f'kernel calls a request {per_request}, the step {per_step}; phase '
        f'22a in {time.perf_counter() - t_phase:.1f} s')
    summary = dict(request_ms=req_ms, request_host_ms=req_host_ms,
                   flagship_request_ms=flagship['req_ms'], stages=stages,
                   flagship_stages=flagship['stages'],
                   request_peak_gib=req_peak,
                   flagship_peak_gib=flagship['peak'], step_s=step_s,
                   step_peak_gib=step_peak, per_request=per_request,
                   per_step=per_step,
                   losses={k: float(v) for k, v in metrics.items()},
                   counts=counts, seconds=time.perf_counter() - t_phase)
    return dict(rows=rows, counts=counts, per_step=per_step,
                summary=summary)


def occ_depth_phase(depth):
    """Phase 22b: the occupancy config with `model.backbone.depth=depth`
    on phase 15's synthetic sets through tools/train.py (one B=2 step, no
    val: `val_interval` past the epoch); then one request on the step's
    batch on the card and, from the same weights, on the CPU: logits at
    every scale within OCC_CARD_RTOL · (1 + max|x|), the labels equal
    wherever the CPU logits' top two are more than twice the largest
    logit difference apart (elsewhere a label may flip)."""
    from proxytransformation_torch.engine.runner import build_model_from_cfg
    from proxytransformation_torch.ops import _cuda
    from proxytransformation_torch.tools import train as train_cli
    from proxytransformation_torch.utils.config import Config
    repo = Path(__file__).resolve().parent
    work = repo / 'build' / f'chip_smoke_occ{depth}'
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    first = {}
    with capturing_first_step(first):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = train_cli.main(occupancy_argv(
            work, 2, options=(f'model.backbone.depth={depth}',
                              'train_cfg.val_interval=9')))
        wall = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    model = runner.model
    require(model.backbone.depth == depth
            and model.feat_proj.in_features == 16
            and len(runner.train_log) == 1,
            f'phase 22 occupancy at depth {depth}: {runner.train_log}')
    losses = runner.train_log[0]
    require(all(np.isfinite(v) for v in losses.values()),
            f'occupancy at depth {depth}: losses {losses}')
    require(not any(counts.values()) and not any(first['calls'].values()),
            f'a kernel of csrc/ launched at occupancy depth {depth}')
    batch = first['batch']
    with torch.no_grad():
        req_ms, req_host_ms = cuda_ms(lambda: model(batch), 2)
        got = model.logits(batch)
        got_occ = model.bbox_head.predict(got).cpu()
        got = [x.cpu() for x in got]
    cfg = dict(Config.fromfile(str(repo / OCC_CONFIG))['model'])
    cfg['backbone'] = dict(cfg['backbone'], depth=depth)
    cpu = build_model_from_cfg(cfg, device='cpu')
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_batch = {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in batch.items()}
    del runner, model, first, batch
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu.logits(cpu_batch)
        want_occ = cpu.bbox_head.predict(want)
    cpu_s = time.perf_counter() - t0
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        errs.append(float((g - w).abs().max()))
        require(errs[-1] <= OCC_CARD_RTOL * (1 + float(w.abs().max())),
                f'occupancy depth {depth}, scale {i}: card and CPU logits '
                f'differ by {errs[-1]}')
    # with every logit within errs[0] of the CPU's, a label can differ
    # only where the CPU's top two are within twice that
    top2 = want[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * errs[0]
    require(bool(clear.any()) and torch.equal(got_occ[clear],
                                              want_occ[clear]),
            f'occupancy depth {depth}: labels differ off the near ties')
    n_differ = int((got_occ != want_occ).sum())
    log(f'[resnet occ] {OCC_CONFIG} with model.backbone.depth={depth}: one '
        f'step, a checkpoint in {wall:.1f} s, losses '
        + ' '.join(f'{k} {losses[k]:.5f}' for k in (
            'loss_occ_0', 'loss_occ_1', 'loss_occ_2', 'grad_norm'))
        + f'; a request (B=2): '
        + ', '.join(f'{h:.1f} ms ({d:.1f} ms of CUDA events)'
                    for h, d in zip(req_host_ms, req_ms))
        + f'; peak {peak:.2f} GiB; card vs CPU logits max abs err by scale '
        f'{[f"{e:.3g}" for e in errs]}, labels equal at all '
        f'{int(clear.sum())} of {clear.numel()} voxels whose top two '
        f'logits are over twice that apart; {n_differ} labels differ in all '
        f'(CPU request {cpu_s:.1f} s); in {time.perf_counter() - t_phase:.1f} '
        f's')
    return dict(wall_s=wall, losses=losses, request_ms=req_ms,
                request_host_ms=req_host_ms, peak_gib=peak,
                card_cpu_logit_err=errs, clear_voxels=int(clear.sum()),
                labels_differ=n_differ, cpu_request_s=cpu_s)


def resnet_depth_phases(smi, flagship):
    """Phase 22: ResNet-101 through the grounder, ResNet-18 and -34
    through the occupancy predictor."""
    t_phase = time.perf_counter()
    out = resnet101_phase(flagship)
    out['occupancy'] = {d: occ_depth_phase(d) for d in OCC_DEPTHS}
    log(f'[phase 22] in {time.perf_counter() - t_phase:.1f} s ({smi})')
    return out


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
    if sys.argv[1:2] == ['--dp-step']:
        sys.exit(dp_step_worker(Path(sys.argv[2])))
    sys.exit(main())
