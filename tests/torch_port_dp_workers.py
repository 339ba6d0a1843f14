"""Rank processes for the port's data-parallel tests (no JAX here: the
children import torch, numpy and the port only).

`run_ranks(fn, world, tmp, *args)` starts `world` spawned processes, each
a gloo rank of a `file://` rendezvous in `tmp` with a process-group
timeout of 60 s and two torch threads, runs `fn(ctx, *args)` there and
returns every rank's result in rank order (`start_ranks` and
`join_ranks` split it, so the caller can work while the ranks run). The
join is bounded: past `timeout` seconds every child is killed and the
call raises.
"""
from __future__ import annotations

import copy
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

PG_TIMEOUT_S = 60.0


def _entry(rank, fn, world, tmp, args):
    from proxytransformation_torch.parallel import dist as pdist
    torch.set_num_threads(2)
    out = Path(tmp) / f'rank{rank}.pt'
    try:
        ctx = pdist.DistContext(world, rank, rank, world, 0)
        pdist.init_process_group(ctx, 'gloo',
                                 f'file://{Path(tmp) / "rendezvous"}',
                                 PG_TIMEOUT_S)
        try:
            result = fn(ctx, *args)
        finally:
            pdist.destroy_process_group()
        torch.save({'ok': result}, out)
    except BaseException:
        torch.save({'error': traceback.format_exc()}, out)
        raise


def start_ranks(fn, world, tmp, *args):
    """`world` spawned ranks running `fn(ctx, *args)`; returns the handle
    `join_ranks` takes (the caller may work meanwhile)."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    for f in tmp.glob('rank*.pt'):
        f.unlink()
    (tmp / 'rendezvous').unlink(missing_ok=True)
    env = {'OMP_NUM_THREADS': '2', 'MKL_NUM_THREADS': '2'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        procs = mp.start_processes(_entry, args=(fn, world, str(tmp), args),
                                   nprocs=world, join=False,
                                   start_method='spawn')
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return procs, fn, world, tmp


def join_ranks(handle, timeout=240.0):
    """Every rank's result of `start_ranks`, in rank order. The join is
    bounded: past `timeout` seconds every child is killed and the call
    raises."""
    procs, fn, world, tmp = handle
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{fn.__name__} on {world} ranks did not '
                                   f'finish in {timeout} s')
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for rank in range(world):
        got = torch.load(tmp / f'rank{rank}.pt', weights_only=False)
        if 'error' in got:
            raise RuntimeError(f'rank {rank}:\n{got["error"]}')
        results.append(got['ok'])
    return results


def run_ranks(fn, world, tmp, *args, timeout=240.0):
    return join_ranks(start_ranks(fn, world, tmp, *args), timeout)


def rank_rows(batch, ctx):
    """This rank's contiguous rows of a global numpy batch."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // ctx.world
        out[k] = v[ctx.rank * b:(ctx.rank + 1) * b]
    return out


def run_jobs(ctx, jobs):
    """Each (name, worker function, args) of `jobs` in turn on this rank,
    in one process group (one spawn for a test file's runs): {name: its
    result}."""
    return {name: fn(ctx, *args) for name, fn, args in jobs}


# --------------------------------------------------------------------------
# the small checks: gather, norms, losses, val's deal
# --------------------------------------------------------------------------
def _norm_case(ctx, kind, x, mask, params, cot):
    """One train-mode norm on this rank's rows, its loss Σ y·cot over the
    synced row count, and the gradients of x and the norm's parameters."""
    from proxytransformation_torch.models.norms import BatchNormParams
    from proxytransformation_torch.parallel import dist as pdist
    bn = BatchNormParams(x.shape[-1])
    with torch.no_grad():
        for name, v in params.items():
            getattr(bn, name).copy_(torch.from_numpy(v))
    b = x.shape[0] // ctx.world
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    xt = torch.tensor(x[rows], requires_grad=True)
    if kind == 'flax':
        y = bn.flax(xt, train=True)
    else:
        y = bn.masked(xt, torch.from_numpy(mask[rows]), train=True)
    n = pdist.synced_normaliser(torch.tensor(float(b)), 1.0)
    (torch.sum(y * torch.from_numpy(cot[rows])) / n).backward()
    pdist.average_gradients(bn.parameters())
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                running_mean=bn.running_mean.numpy(),
                running_var=bn.running_var.numpy())


def _grounding_loss_case(ctx, case):
    from proxytransformation_torch.models.grounding_head import GroundingHead
    from proxytransformation_torch.parallel import dist as pdist
    head = GroundingHead(embed_dims=case['C'], max_text_len=case['M'])
    head.load_state_dict({k: torch.from_numpy(v)
                          for k, v in case['state'].items()})
    r = rank_rows({k: case[k] for k in ('text_feats', 'text_mask', 'gt',
                                        'gt_masks', 'pos_maps',
                                        'query_mask')}, ctx)
    hidden = torch.tensor(rank_rows({'h': case['hidden'].swapaxes(0, 1)},
                                    ctx)['h'].swapaxes(0, 1).copy(),
                          requires_grad=True)
    boxes = torch.tensor(rank_rows({'b': case['boxes'].swapaxes(0, 1)},
                                   ctx)['b'].swapaxes(0, 1).copy(),
                         requires_grad=True)
    losses = head.loss(hidden, boxes, torch.from_numpy(r['text_feats']),
                       torch.from_numpy(r['text_mask']),
                       torch.from_numpy(r['gt']),
                       torch.from_numpy(r['gt_masks']),
                       torch.from_numpy(r['pos_maps']),
                       torch.from_numpy(r['query_mask']))
    total = sum(losses[k] for k in sorted(losses))
    total.backward()
    pdist.average_gradients(head.parameters())
    keys = sorted(losses)
    means = pdist.all_reduce_mean(torch.stack([losses[k] for k in keys]))
    return dict(losses={k: float(means[i]) for i, k in enumerate(keys)},
                dhidden=hidden.grad.numpy(), dboxes=boxes.grad.numpy(),
                grads={n: p.grad.numpy() for n, p in head.named_parameters()
                       if p.grad is not None})


def _fcaf3d_loss_case(ctx, case):
    from proxytransformation_torch.models.fcaf3d_head import FCAF3DHead
    from proxytransformation_torch.parallel import dist as pdist
    head = FCAF3DHead(**case['kw'])
    r = rank_rows({k: case[k] for k in ('centers', 'bboxes', 'clses',
                                        'points', 'masks', 'gt_bboxes',
                                        'gt_labels', 'gt_mask')}, ctx)
    leaves = {k: torch.tensor(r[k], requires_grad=True)
              for k in ('centers', 'bboxes', 'clses')}
    outs = (leaves['centers'], leaves['bboxes'], leaves['clses'],
            torch.from_numpy(r['points']), torch.from_numpy(r['masks']),
            torch.from_numpy(case['level_ids']))
    losses = head.loss(outs, torch.from_numpy(r['gt_bboxes']),
                       torch.from_numpy(r['gt_labels']),
                       torch.from_numpy(r['gt_mask']))
    sum(losses[k] for k in sorted(losses)).backward()
    keys = sorted(losses)
    means = pdist.all_reduce_mean(torch.stack([losses[k] for k in keys]))
    return dict(losses={k: float(means[i]) for i, k in enumerate(keys)},
                grads={k: v.grad.numpy() for k, v in leaves.items()})


def _val_deal_case(ctx, n_items, batch_size):
    """Val's path without a model: the loader's batches dealt to the ranks
    in turn, each sample's (position, index) order key, the gather."""
    from proxytransformation_torch.data.loader import DataLoader
    from proxytransformation_torch.parallel.gather import gather_in_order
    loader = DataLoader(list(range(n_items)), batch_size, collate_fn=list,
                        shuffle=False, drop_last=False,
                        deal=(ctx.rank, ctx.world))
    mine, order = [], []
    for pos, batch in zip(loader.positions(), loader):
        for j, item in enumerate(batch):
            mine.append(item)
            order.append((pos, j))
    return dict(mine=mine, gathered=gather_in_order(mine, order))


def small_checks(ctx, cases):
    from proxytransformation_torch.parallel import gather
    out = {'allgather': gather.allgather_objects(
        [('rank', ctx.rank, i) for i in range(ctx.rank + 1)])}
    out['broadcast'] = gather.broadcast_object({'from': ctx.rank})
    for kind in ('flax', 'masked'):
        out[kind] = _norm_case(ctx, kind, *cases[kind])
    out['grounding'] = _grounding_loss_case(ctx, cases['grounding'])
    out['fcaf3d'] = _fcaf3d_loss_case(ctx, cases['fcaf3d'])
    out['val_deal'] = _val_deal_case(ctx, 7, 2)
    return out


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------
def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def grounder_steps(ctx, cfg, sd, batch, masks, steps, adam=None):
    """`steps` AdamW steps of the grounder `cfg` from `sd` on this rank's
    rows of the global `batch`, the dropout's keep masks the global
    `masks`; per step the metrics, the (averaged) gradients and the state,
    and the level-0 voxel keys and Hungarian assignments of this rank.
    `adam`: a JAX step's record (its Adam moments), continued from after
    one step (test_torch_port_train.py::run_port's)."""
    from proxytransformation_torch.engine import train as ttrain
    from proxytransformation_torch.models import detector as tdet
    from proxytransformation_torch.models import grounding_head as thead
    from proxytransformation_torch.models import preshape as tpre
    model = tdet.SparseFeatureFusion3DGrounderPreshape(**cfg, device='cpu')
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    drawn = []
    for name, mod in model.named_modules():
        if isinstance(mod, tpre.Dropout) and name in masks:
            def draw(shape, device, generator, m=masks[name], name=name):
                assert tuple(shape) == m.shape, (name, shape, m.shape)
                drawn.append(name)
                return torch.from_numpy(m)
            mod.draw = draw
    seen = {}
    assign, voxelize = thead.GroundingHead.assign, tdet.voxelize_points

    def rec_assign(self, *a, **kw):
        out = assign(self, *a, **kw)
        seen.setdefault('assign', []).append(out.numpy())
        return out

    def rec_voxelize(*a, **kw):
        out = voxelize(*a, **kw)
        seen.setdefault('keys', []).append(out.keys.numpy())
        return out

    thead.GroundingHead.assign = rec_assign
    tdet.voxelize_points = rec_voxelize
    try:
        opt = ttrain.build_optimizer(model)
        if adam is not None:
            for name, p in model.named_parameters():
                if ttrain.param_label(name) != 'frozen':
                    opt.state[p] = {
                        'mu': torch.from_numpy(adam['mu'][name].copy()),
                        'nu': torch.from_numpy(adam['nu'][name].copy())}
            for group in opt.param_groups:
                group['count'] = 1
        step = ttrain.make_train_step(
            model, opt,
            ttrain.build_lr_schedule(ttrain.BASE_LR, steps_per_epoch=1))
        tb = tdet.batch_to_device(rank_rows(batch, ctx), 'cpu')
        out = []
        for _ in range(steps):
            metrics = step(tb)
            out.append(dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads={n: (p.grad if p.grad is not None
                           else torch.zeros_like(p)).numpy().copy()
                       for n, p in model.named_parameters()},
                state=_state(model)))
    finally:
        thead.GroundingHead.assign = assign
        tdet.voxelize_points = voxelize
    return dict(steps=out, seen=seen, drawn=len(drawn))


def detector_steps(ctx, cfg, batch, resume=None):
    """Two AdamW steps of the detector `cfg` from flax's seeded
    initialisers on this rank's rows of the global `batch` (the whole
    batch without `ctx`); the second from `resume` (a model and optimizer
    state_dict) when given. Per step the metrics, gradients and state;
    the first also its 'resume'."""
    from proxytransformation_torch.engine import train as ttrain
    from proxytransformation_torch.models.detector import batch_to_device
    from proxytransformation_torch.models.embodied_det3d import (
        Embodied3DDetector)
    from proxytransformation_torch.models.init import flax_init_
    from proxytransformation_torch.parallel import dist as pdist
    model = Embodied3DDetector(**cfg, device='cpu')
    flax_init_(model, torch.Generator().manual_seed(0))
    pdist.broadcast_state(model)
    opt = ttrain.build_optimizer(model)
    step = ttrain.make_train_step(model, opt)
    tb = batch_to_device(rank_rows(batch, ctx) if ctx else batch, 'cpu')
    out = []
    for i in range(2):
        if i == 1 and resume is not None:
            model.load_state_dict(resume['model'])
            opt.load_state_dict(resume['optimizer'])
        metrics = step(tb)
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                        grads={n: p.grad.numpy().copy()
                               for n, p in model.named_parameters()
                               if p.grad is not None},
                        state=_state(model)))
        if i == 0:
            out[0]['resume'] = {
                'model': {k: v.clone() for k, v in
                          model.state_dict().items()},
                'optimizer': copy.deepcopy(opt.state_dict())}
    return out


def raises(ctx, cfgs):
    """Each (name, config, device) through the Runner on this rank: the
    message of what it raised, or None."""
    from proxytransformation_torch.engine.runner import Runner
    from proxytransformation_torch.utils.config import Config
    out = {}
    for name, (path, options, work) in cfgs.items():
        cfg = Config.fromfile(path)
        cfg.merge_from_dict(Config.parse_cfg_options(options))
        try:
            Runner.from_cfg(cfg, work, 'cpu').train()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f'{type(e).__name__}: {e}'
    return out


def occupancy_runs(ctx, cfgs):
    """Each (name, config, options, work dir) through the Runner's
    `train()` (its first step recorded: the metrics, every gradient after
    the rank mean, the state after the update) on this rank, one process
    without `ctx`; the run's val_results.json."""
    import json
    from proxytransformation_torch.engine import runner as rmod
    from proxytransformation_torch.utils.config import Config
    make = rmod.make_train_step
    out = {}
    for name, (path, options, work) in cfgs.items():
        rec = {}

        def recording(model, optimizer, schedule=None, rec=rec):
            step = make(model, optimizer, schedule)

            def run(batch, generator=None):
                metrics = step(batch, generator)
                if not rec:
                    rec.update(
                        metrics={k: float(v) for k, v in metrics.items()},
                        grads={n: p.grad.numpy().copy()
                               for n, p in model.named_parameters()
                               if p.grad is not None},
                        state=_state(model), rows=len(batch['imgs']))
                return metrics
            return run

        cfg = Config.fromfile(path)
        cfg.merge_from_dict(Config.parse_cfg_options(options))
        rmod.make_train_step = recording
        try:
            rmod.Runner.from_cfg(cfg, work, 'cpu').train()
        finally:
            rmod.make_train_step = make
        rec['val_results'] = json.loads(
            (Path(work) / 'val_results.json').read_text())
        out[name] = rec
    return out
