"""What a Runner iteration costs beside a bare train step, on the card.

    python -m proxytransformation_torch.tools.profile_runner \
        [--steps 8] [--workers 0 2 6] [--bare 4]

The flagship config with `--amp` (its `remat=True` kept), its train set
swapped for `SyntheticGroundingDataset` at full scale (100k points, 20
views at 480x480), B=2, one epoch of `--steps` steps, no val; once for
each loader setting in `--workers` (0: the prefetch thread; n > 0: a
spawn pool of n processes). For each it prints the runner's
`train_timing` (s/it, data wait, first wait), the median host time of an
iteration after the first (from one step's start to the next's), of the
step call itself and of the batch's host→device copy, and then a bare
`train_step` on the run's last batch, already on the card, timed alone
with CUDA events and the host clock. Also the host time to make and
collate one batch with no step beside it. One JSON line per setting goes
to chiprun_out/profile_runner.json.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import time
from pathlib import Path

import torch

from ..data.preprocessor import Det3DDataPreprocessor
from ..engine import runner as runner_mod
from ..engine.runner import Runner, apply_amp
from ..utils.config import Config
from ..utils.registry import DATASETS

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / 'configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py'


def flagship_cfg(steps: int, workers: int) -> Config:
    cfg = Config.fromfile(str(CONFIG))
    ds = dict(type='SyntheticGroundingDataset', n_points=100_000,
              n_views=20, img_size=480, length=2 * steps)
    cfg.merge_from_dict({'train_dataloader.dataset': ds,
                         'train_dataloader.batch_size': 2,
                         'train_dataloader.num_workers': workers,
                         'train_cfg.max_epochs': 1,
                         'train_cfg.val_interval': 1 << 30})
    apply_amp(cfg)
    return cfg


def run(steps: int, workers: int, n_bare: int) -> dict:
    work = ROOT / 'build' / f'profile_runner_{workers}'
    shutil.rmtree(work, ignore_errors=True)
    starts, ends, copies, last = [], [], [], {}
    make_train_step = runner_mod.make_train_step
    split_batch = Runner._split_batch

    def timed_make(model, optimizer, schedule=None):
        step = make_train_step(model, optimizer, schedule)

        def train_step(batch, generator=None):
            starts.append(time.perf_counter())
            out = step(batch, generator)
            ends.append(time.perf_counter())
            last['batch'] = batch
            return out
        return train_step

    def timed_split(self, batch):
        t = time.perf_counter()
        out = split_batch(self, batch)
        copies.append(time.perf_counter() - t)
        return out

    runner_mod.make_train_step = timed_make
    Runner._split_batch = timed_split
    try:
        runner = Runner(flagship_cfg(steps, workers), str(work))
        runner.train()
    finally:
        runner_mod.make_train_step = make_train_step
        Runner._split_batch = split_batch
    iters = [b - a for a, b in zip(starts, starts[1:])]
    calls = [b - a for a, b in zip(starts, ends)]

    bare = make_train_step(runner.model, runner.optimizer, runner.schedule)
    bare_ms, bare_host_ms = [], []
    for _ in range(n_bare):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        bare(last['batch'], runner.generator)
        end.record()
        torch.cuda.synchronize()
        bare_host_ms.append((time.perf_counter() - t) * 1e3)
        bare_ms.append(start.elapsed_time(end))
    out = dict(workers=workers, steps=len(starts),
               train_timing=runner.train_timing,
               iter_ms_after_first=[x * 1e3 for x in iters[1:]],
               step_call_ms=[x * 1e3 for x in calls],
               h2d_ms=[x * 1e3 for x in copies],
               bare_step_ms=bare_ms, bare_step_host_ms=bare_host_ms)
    del runner, bare, last
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return out


def batch_host_ms(reps: int = 3) -> list:
    """Make and collate one B=2 batch on the host, nothing beside it."""
    cfg = flagship_cfg(reps, 0)
    pp = dict(cfg['model']['data_preprocessor'], n_points=100_000,
              n_views=20, max_text_len=256)
    pp.pop('type')
    collate = Det3DDataPreprocessor(**pp)
    ds = DATASETS.build(cfg['train_dataloader']['dataset'])
    out = []
    for r in range(reps):
        t = time.perf_counter()
        collate([ds[2 * r], ds[2 * r + 1]])
        out.append((time.perf_counter() - t) * 1e3)
    return out


def med(xs):
    return statistics.median(xs) if xs else float('nan')


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=8)
    ap.add_argument('--workers', type=int, nargs='+', default=[0, 2, 6])
    ap.add_argument('--bare', type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_runner: needs a CUDA device')
    print(f'[device] {torch.cuda.get_device_name(0)}', flush=True)
    host = batch_host_ms()
    print('[batch] make + collate one B=2 batch on the host, alone: '
          + ', '.join(f'{x:.0f}' for x in host) + ' ms', flush=True)
    results = []
    for w in args.workers:
        r = run(args.steps, w, args.bare)
        results.append(r)
        t = r['train_timing']
        print(f'[runner workers={w}] {r["steps"]} steps: s/it '
              f'{t["iter_s"]:.3f} (first wait {t["first_wait_s"]:.3f} s '
              f'included), data_wait_s {t["data_wait_s"]:.4f}; after the '
              f'first, an iteration {med(r["iter_ms_after_first"]):.1f} ms '
              f'(median; min {min(r["iter_ms_after_first"]):.1f}, max '
              f'{max(r["iter_ms_after_first"]):.1f}), the step call '
              f'{med(r["step_call_ms"][1:]):.1f} ms, the batch\'s copy to '
              f'the card {med(r["h2d_ms"]):.1f} ms; bare step on the last '
              f'batch {med(r["bare_step_host_ms"]):.1f} ms host, '
              f'{med(r["bare_step_ms"]):.1f} ms CUDA events (median of '
              f'{len(r["bare_step_ms"])})', flush=True)
    out = ROOT / 'chiprun_out'
    out.mkdir(exist_ok=True)
    with open(out / 'profile_runner.json', 'w') as f:
        for r in results:
            f.write(json.dumps(dict(r, batch_host_ms=host,
                                    device=torch.cuda.get_device_name(0)))
                    + '\n')


if __name__ == '__main__':
    main()
