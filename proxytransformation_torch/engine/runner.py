"""Runner: config → dataset, model and optimizer → train / val / test loops.

Counterpart of proxytransformation_tpu/engine/runner.py (mmengine's
Runner in the reference) for the grounding task: `Runner.from_cfg(cfg)`
builds everything from a python-file config, `train()` runs the epoch
loop over `engine.train.make_train_step`, `val()` / `test()` run predict
and the grounding metric. A checkpoint each epoch with rotation,
auto-resume and fast resume (the loader's order is a function of its
seed and epoch, so the consumed batches of an epoch are skipped, as the
reference's FastResumeIterBasedTrainLoop does, runner/loops.py:19-84).

The runner runs on one device: `device=None` is the card (raising
without one, `device.resolve_device`); pass `device='cpu'` for the
plain PyTorch path. The recipe (lr, weight decay, clip norm, milestones,
gamma, the decoder's lr multiplier) comes from the config. What the port
cannot honour raises rather than being dropped: other tasks, the
baseline grounder, other text towers, TTA, custom hooks (the EMA hook)
and the EmbodiedScan datasets.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DataLoader
from ..data.preprocessor import Det3DDataPreprocessor
from ..data import synthetic  # noqa: F401  (registers the datasets)
from ..device import resolve_device
from ..eval import grounding_metric  # noqa: F401  (registers the metric)
from ..models.detector import (SparseFeatureFusion3DGrounderPreshape,
                               batch_to_device)
from ..models.layers import random_init_
from ..utils.registry import DATASETS, METRICS
from ..utils.vis_backend import build_vis_backends
from .checkpoint import (latest_checkpoint, load_checkpoint,
                         load_torch_checkpoint, restore_state,
                         save_checkpoint, warm_start_params)
from .train import (BASE_LR, CLIP_NORM, DECODER_LR_MULT, GAMMA, MILESTONES,
                    WEIGHT_DECAY, build_lr_schedule, build_optimizer,
                    make_train_step)

logger = logging.getLogger('proxytransformation_torch')

_DEVICE_KEYS = ('imgs', 'points', 'points_mask', 'input_ids', 'text_mask',
                'proj_mats', 'views_mask', 'gt_bboxes', 'gt_masks',
                'positive_maps', 'pcd_rotation', 'pcd_scale_factor',
                'pcd_trans', 'pcd_flip_x', 'pcd_flip_y', 'gt_labels',
                'gt_occupancy', 'gt_occupancy_masks')

# model-config `type` → task (the JAX package's table)
_MODEL_TASKS = {
    'SparseFeatureFusion3DGrounderPreshape': 'grounding',
    'SparseFeatureFusion3DGrounder': 'grounding',
    'Embodied3DDetector': 'detection',
    'EmbodiedOccPredictor': 'occupancy',
    'DenseFusionOccPredictor': 'occupancy',
}
_NOT_PORTED = {
    'detection': 'detection pretraining is ROADMAP item 12',
    'occupancy': 'occupancy is ROADMAP item 13',
}
# the EmbodiedScan datasets of the JAX package's data/dataset.py
_REAL_DATASETS = ('MultiView3DGroundingDataset', 'EmbodiedScanDataset',
                  'RepeatDataset')

# model-config keys the grounder takes as they are
_FLAT_KEYS = ('num_queries', 'voxel_size', 'use_xyz_feat', 'n_points',
              'remat', 't_type', 'compute_dtype', 'remat_painting',
              'img_spacial_dim', 'max_text_len', 'voxel_extent',
              'text_width', 'text_layers', 'text_heads', 'embed_dims',
              'num_heads', 'ffn_channels')
# sub-config key → grounder keyword
_NESTED_KEYS = {
    'preshape': {'grid_size': 'grid_size', 'text_blocks': 'text_blocks',
                 'img_blocks': 'img_blocks',
                 'dynamic_drop_radio': 'dynamic_drop_radio',
                 'num_sub': 'num_sub', 'n_points': 'n_points'},
    'backbone': {'base_channels': 'img_base_channels',
                 'depth': 'img_depth'},
    'backbone_3d': {'depth': 'backbone3d_depth',
                    'capacities': 'sparse_capacities'},
    'neck_3d': {'out_channels': 'neck_out_channels',
                'pts_prune_threshold': 'pts_prune_threshold'},
    'decoder': {'num_layers': 'decoder_layers'},
}
# sub-config entries the grounder has fixed: the only value it can take
_FIXED = {
    ('backbone', 'type'): 'ResNet',
    ('preshape', 'type'): 'ProxyTransformationNormReverse',
    ('backbone_3d', 'type'): 'MinkResNet',
    ('backbone_3d', 'in_channels'): 3,
    ('neck_3d', 'type'): 'MinkNeck',
    ('neck_3d', 'num_classes'): 1,
    ('decoder', 'return_intermediate'): True,
    ('coord_type', ): 'DEPTH',
}
# sub-config entries checked against what the grounder derives
_DERIVED = (('neck_3d', 'voxel_size'), ('neck_3d', 'in_channels'))


def apply_amp(cfg) -> None:
    """`--amp`: bfloat16 compute with the painting checkpointed (the
    reference's AMP OptimWrapper, tools/train.py:94-105); setdefault, so
    explicit config or --cfg-options values win."""
    model_cfg = cfg.setdefault('model', {})
    model_cfg.setdefault('compute_dtype', 'bfloat16')
    model_cfg.setdefault('remat_painting', True)


def _model_task(model_cfg: Dict[str, Any]) -> str:
    mtype = model_cfg.get('type', 'SparseFeatureFusion3DGrounderPreshape')
    if mtype not in _MODEL_TASKS:
        raise KeyError(f'unknown model type {mtype!r}; known: '
                       f'{sorted(_MODEL_TASKS)}')
    task = _MODEL_TASKS[mtype]
    if task in _NOT_PORTED:
        raise NotImplementedError(f'{mtype}: {_NOT_PORTED[task]}')
    if mtype == 'SparseFeatureFusion3DGrounder':
        raise NotImplementedError(
            'SparseFeatureFusion3DGrounder (the baseline without the '
            'preshape) is ROADMAP item 14')
    return task


def build_model_from_cfg(model_cfg: Dict[str, Any], device=None
                         ) -> SparseFeatureFusion3DGrounderPreshape:
    """The grounder of a reference-style nested model config (the JAX
    package's keyword mapping, engine/runner.py:124-181). Every key must
    reach the model or hold the one value the port has fixed; another
    key or value raises, so that no knob is dropped silently (the JAX
    package's own `--amp` once was, engine/runner.py:140-143)."""
    _model_task(model_cfg)
    cfg = dict(model_cfg)
    kw: Dict[str, Any] = {k: cfg[k] for k in _FLAT_KEYS if k in cfg}
    if 'voxel_extent' in kw:
        kw['voxel_extent'] = tuple(kw['voxel_extent'])
    unknown = []
    for sub, table in _NESTED_KEYS.items():
        for k, v in cfg.get(sub, {}).items():
            if k in table:
                kw[table[k]] = tuple(v) if k == 'capacities' else v
            elif (sub, k) not in _FIXED and (sub, k) not in _DERIVED:
                unknown.append(f'{sub}.{k}')
    for key, want in _FIXED.items():
        d = cfg
        for part in key[:-1]:
            d = d.get(part, {})
        if key[-1] in d and d[key[-1]] != want:
            raise NotImplementedError(
                f'model.{".".join(key)}={d[key[-1]]!r}: the port builds '
                f'{want!r} only')
    # keys the runner reads, or that the sub-dicts above carry
    handled = set(_FLAT_KEYS) | set(_NESTED_KEYS) | {
        'type', 'data_preprocessor', 'coord_type'}
    unknown += [k for k in cfg if k not in handled]
    if unknown:
        raise ValueError(f'model config keys the port does not take: '
                         f'{sorted(unknown)}')
    neck = cfg.get('neck_3d', {})
    if 'voxel_size' in neck and neck['voxel_size'] != kw.get('voxel_size',
                                                            0.01):
        raise ValueError('neck_3d.voxel_size differs from the model\'s '
                         'voxel_size, which the neck uses')
    if 'in_channels' in neck:
        base = kw.get('img_base_channels', 16)
        derived = [m + base * 4 * 2 ** i
                   for i, m in enumerate((64, 128, 256, 512))]
        if list(neck['in_channels']) != derived:
            raise ValueError(f'neck_3d.in_channels {neck["in_channels"]} '
                             f'differ from the derived {derived}')
    return SparseFeatureFusion3DGrounderPreshape(**kw, device=device)


def _recipe(cfg) -> Dict[str, Any]:
    """The optimizer and schedule values of a config (the JAX Runner's
    `_init_state`, engine/runner.py:330-351, plus the decoder's lr
    multiplier of `paramwise_cfg`); what the port's AdamW cannot honour
    raises."""
    wrapper = cfg.get('optim_wrapper', {}) or {}
    opt = wrapper.get('optimizer', {}) or {}
    if opt.get('type', 'AdamW') != 'AdamW':
        raise NotImplementedError(f'optimizer {opt["type"]!r}: the port '
                                  'has AdamW only')
    clip = wrapper.get('clip_grad', {}) or {}
    if clip.get('norm_type', 2) != 2:
        raise NotImplementedError('clip_grad.norm_type other than 2')
    decoder_mult = DECODER_LR_MULT
    custom = (wrapper.get('paramwise_cfg', {}) or {}).get('custom_keys', {})
    for key, spec in custom.items():
        if key == 'decoder' and spec.get('decay_mult', 1.0) == 1.0:
            decoder_mult = spec.get('lr_mult', decoder_mult)
        elif not (key == 'text_encoder' and spec.get('lr_mult') == 0.0):
            raise NotImplementedError(
                f'paramwise_cfg.custom_keys.{key}={spec}: the port takes '
                'a decoder lr_mult and a frozen text encoder only')
    sched = cfg.get('param_scheduler', {}) or {}
    if sched.get('type', 'MultiStepLR') != 'MultiStepLR' \
            or not sched.get('by_epoch', True) or sched.get('begin', 0):
        raise NotImplementedError(f'param_scheduler {sched}: the port has '
                                  'MultiStepLR by epoch from epoch 0 only')
    return dict(base_lr=opt.get('lr', BASE_LR),
                weight_decay=opt.get('weight_decay', WEIGHT_DECAY),
                decoder_lr_mult=decoder_mult,
                clip_norm=clip.get('max_norm', CLIP_NORM),
                milestones=tuple(sched.get('milestones', MILESTONES)),
                gamma=sched.get('gamma', GAMMA))


class Runner:

    def __init__(self, cfg, work_dir: Optional[str] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        hooks = cfg.get('custom_hooks') or []
        if hooks:
            raise NotImplementedError(
                f'custom_hooks {[h.get("type") for h in hooks]}: the port '
                'has none yet (the EMA hook, models/misc.py::'
                'ExpMomentumEMA, is ROADMAP item 10.6)')
        self.work_dir = work_dir or cfg.get('work_dir', './work_dir')
        os.makedirs(self.work_dir, exist_ok=True)
        logging.basicConfig(level=logging.INFO)

        self.model = build_model_from_cfg(cfg['model'], self.device)
        pp_cfg = dict(cfg['model'].get('data_preprocessor', {}))
        pp_cfg.pop('type', None)
        pp_cfg.setdefault('n_points', self.model.n_points)
        pp_cfg.setdefault('max_text_len', self.model.max_text_len)
        self.n_views = cfg.get('n_views', 20)
        self._pp_cfg = pp_cfg
        # train and eval view capacities differ in the reference protocol
        # (20 train / 50 ordered eval views): the collate capacity follows
        # each loader's own pipeline
        self.preprocessor = self._make_preprocessor()
        self.train_cfg = cfg.get('train_cfg', {})
        self.optimizer = None
        self.schedule = None
        self.generator = None
        self.global_step = 0
        self._steps_per_epoch = 1
        self.vis_backends = build_vis_backends(cfg, self.work_dir)

    def _log_scalars(self, scalars, step=None):
        for be in self.vis_backends:
            be.add_scalars(scalars, step=step)

    @classmethod
    def from_cfg(cls, cfg, work_dir=None, device=None) -> 'Runner':
        return cls(cfg, work_dir, device)

    # ------------------------------------------------------------------
    def _make_preprocessor(
            self, n_views: Optional[int] = None) -> Det3DDataPreprocessor:
        """Collate preprocessor; `n_views` (from a loader's pipeline)
        overrides the config default."""
        pp_cfg = dict(self._pp_cfg)
        if n_views is not None:
            pp_cfg['n_views'] = n_views
        else:
            pp_cfg.setdefault('n_views', self.n_views)
        return Det3DDataPreprocessor(**pp_cfg)

    @staticmethod
    def _pipeline_n_views(ds_cfg: Dict[str, Any]) -> Optional[int]:
        """The view count a loader's own pipeline loads (MultiView
        Pipeline n_images), walking through wrappers like RepeatDataset."""
        seen = 0
        while isinstance(ds_cfg, dict) and 'pipeline' not in ds_cfg \
                and 'dataset' in ds_cfg and seen < 8:
            ds_cfg = ds_cfg['dataset']
            seen += 1
        for t in (ds_cfg.get('pipeline') or []) \
                if isinstance(ds_cfg, dict) else []:
            if isinstance(t, dict) and 'n_images' in t:
                return int(t['n_images'])
        return None

    def _build_loader(self, loader_cfg: Dict[str, Any], train: bool):
        ds_cfg = loader_cfg['dataset']
        if ds_cfg.get('type') in _REAL_DATASETS:
            raise NotImplementedError(
                f'{ds_cfg["type"]}: the EmbodiedScan data path is not '
                'ported yet (ROADMAP item 10.3); give a '
                'SyntheticGroundingDataset through --cfg-options')
        dataset = DATASETS.build(ds_cfg)
        n_views = self._pipeline_n_views(ds_cfg)
        collate = (self.preprocessor
                   if n_views is None or n_views == self.preprocessor.n_views
                   else self._make_preprocessor(n_views))
        # one host: one shard
        return DataLoader(dataset,
                          batch_size=loader_cfg.get('batch_size', 1),
                          collate_fn=collate,
                          shuffle=train and loader_cfg.get(
                              'sampler', {}).get('shuffle', True),
                          drop_last=train,
                          num_workers=loader_cfg.get('num_workers', 0))

    def _split_batch(self, batch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        device = {k: v for k, v in batch.items() if k in _DEVICE_KEYS}
        host = {k: v for k, v in batch.items() if k not in _DEVICE_KEYS}
        return batch_to_device(device, self.device), host

    @staticmethod
    def _pad_batch(batch, batch_size):
        """Repeat-pad a partial final val batch to the full batch size so
        the array shapes stay those of every other batch (the per-sample
        host lists keep their true length, so padded predictions are
        never read)."""
        lead = next(v for k, v in batch.items()
                    if k in _DEVICE_KEYS and hasattr(v, 'shape'))
        real = lead.shape[0]
        if real == batch_size:
            return batch, real
        pad = batch_size - real
        out = {}
        for k, v in batch.items():
            if k in _DEVICE_KEYS and hasattr(v, 'shape') and v.ndim >= 1:
                out[k] = np.concatenate(
                    [np.asarray(v),
                     np.repeat(np.asarray(v)[-1:], pad, axis=0)], axis=0)
            else:
                out[k] = v
        return out, real

    def _init_state(self):
        """Seeded weights (drawn on the CPU, so every device starts from
        the same ones), the config's optimizer and schedule, the dropout
        generator (seed + 1) and the `load_from` warm start."""
        seed = self.cfg.get('seed', 0)
        random_init_(self.model, torch.Generator().manual_seed(seed))
        recipe = _recipe(self.cfg)
        self.schedule = build_lr_schedule(
            recipe['base_lr'], self._steps_per_epoch,
            max_epochs=self.train_cfg.get('max_epochs', 12),
            milestones=recipe['milestones'], gamma=recipe['gamma'])
        self.optimizer = build_optimizer(
            self.model, base_lr=recipe['base_lr'],
            weight_decay=recipe['weight_decay'],
            decoder_lr_mult=recipe['decoder_lr_mult'],
            clip_norm=recipe['clip_norm'])
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.global_step = 0
        load_from = self.cfg.get('load_from')
        if load_from:
            if not os.path.exists(load_from):
                raise FileNotFoundError(f'load_from {load_from} not found')
            sd = (load_torch_checkpoint(load_from)
                  if os.path.isfile(load_from)
                  else load_checkpoint(load_from)['model'])
            n = warm_start_params(self.model, sd)
            logger.info('warm start from %s: %d parameters copied',
                        load_from, n)

    def resume_from(self, path: str) -> Tuple[int, int]:
        """Full resume from a checkpoint directory: the model, the AdamW
        state, the generator and the global step; returns (epoch,
        iteration) to continue from."""
        logger.info('resuming from %s', path)
        payload = load_checkpoint(path)
        restore_state(self.model, self.optimizer, payload, self.generator)
        self.global_step = payload['step']
        return payload['epoch'], payload['iteration']

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def train(self, resume: Optional[str] = None):
        loader = self._build_loader(self.cfg['train_dataloader'], True)
        self._steps_per_epoch = max(len(loader), 1)
        max_epochs = self.train_cfg.get('max_epochs', 12)
        val_interval = self.train_cfg.get('val_interval', max_epochs + 1)
        log_interval = self.cfg.get('log_interval', 50)
        max_keep = self.cfg.get('default_hooks', {}).get(
            'checkpoint', {}).get('max_keep_ckpts', 2)

        self._init_state()
        start_epoch = start_iter = 0
        if resume:
            path = (latest_checkpoint(self.work_dir)
                    if resume == 'auto' else resume)
            if path:
                start_epoch, start_iter = self.resume_from(path)
                if start_iter:
                    logger.info('fast-resume: skipping %d consumed '
                                'batches of epoch %d', start_iter,
                                start_epoch)
        step_fn = make_train_step(self.model, self.optimizer, self.schedule)
        self.train_log = []

        def _timed(inner):
            """Yield (seconds blocked waiting for the batch, batch): with a
            prefetching loader ~0 after the first batch, as the worker
            prepares batch i+1 while the device runs step i."""
            while True:
                t = time.time()
                try:
                    b = next(inner)
                except StopIteration:
                    return
                yield time.time() - t, b

        ckpt_iters = self.cfg.get('checkpoint_interval_iters')
        for epoch in range(start_epoch, max_epochs):
            loader.set_epoch(epoch)
            t0 = time.time()
            data_sum = first_wait = 0.0
            for i, (dwait, batch) in enumerate(_timed(iter(loader))):
                if i == start_iter:
                    first_wait = dwait   # pipeline fill, not steady state
                else:
                    data_sum += dwait
                if i < start_iter:
                    continue  # fast resume: skip the consumed batches
                dev_batch, _ = self._split_batch(batch)
                metrics = step_fn(dev_batch, self.generator)
                self.global_step += 1
                # metrics are read back (a device sync) only here
                if (i + 1) % log_interval == 0 or i == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t0) / (i + 1 - start_iter)
                    ddt = data_sum / max(i - start_iter, 1)
                    logger.info('epoch %d iter %d/%d %.2fs/it data=%.3fs '
                                'total=%.4f grad=%.2f', epoch, i + 1,
                                len(loader), dt, ddt,
                                m['total_loss'], m['grad_norm'])
                    rec = dict(m, epoch=epoch, sec_per_iter=dt,
                               data_time=ddt)
                    self.train_log.append(dict(rec, iter=i + 1))
                    self._log_scalars(rec, step=epoch * len(loader) + i + 1)
                if ckpt_iters and (i + 1) % ckpt_iters == 0 \
                        and i + 1 < len(loader):
                    save_checkpoint(self.work_dir, self.model,
                                    self.optimizer, self.global_step, epoch,
                                    max_keep, iteration=i + 1,
                                    generator=self.generator)
            self._sync()
            n_done = max(len(loader) - start_iter, 1)
            self.train_timing = {
                'iter_s': (time.time() - t0) / n_done,
                'data_wait_s': data_sum / max(n_done - 1, 1),
                'first_wait_s': first_wait,
            }
            start_iter = 0
            save_checkpoint(self.work_dir, self.model, self.optimizer,
                            self.global_step, epoch + 1, max_keep,
                            generator=self.generator)
            if (epoch + 1) % val_interval == 0:
                self.val(init_state=False)
        return self.model

    # ------------------------------------------------------------------
    def val(self, resume: Optional[str] = None, init_state: bool = True,
            tta: bool = False):
        if tta:
            raise NotImplementedError('test-time augmentation (models/'
                                      'tta.py) is ROADMAP item 14')
        loader_cfg = self.cfg.get('val_dataloader') \
            or self.cfg.get('test_dataloader')
        loader = self._build_loader(loader_cfg, train=False)
        self._steps_per_epoch = max(len(loader), 1)
        metric_cfg = dict(self.cfg.get('val_evaluator',
                                       {'type': 'GroundingMetric'}))
        metric_cfg.setdefault('type', 'GroundingMetric')
        # a leaderboard dump (format_only) goes to the work dir
        metric_cfg.setdefault('result_dir', self.work_dir)
        metric = METRICS.build(metric_cfg)

        bs = loader_cfg.get('batch_size', 1)
        if init_state or self.optimizer is None:
            self._init_state()
            if resume:
                self.model.load_state_dict(load_checkpoint(resume)['model'])
            else:
                logger.warning(
                    'val() is scoring freshly-initialized random weights '
                    '(no checkpoint given) — pass resume=CKPT or call '
                    'after train() for a meaningful metric')
        for batch in loader:
            batch, _ = self._pad_batch(batch, bs)
            dev_batch, host = self._split_batch(batch)
            out = {k: v.cpu().numpy()
                   for k, v in self.model(dev_batch).items()}
            for b, ann in enumerate(host['eval_ann_info']):
                metric.process(None, [{
                    'eval_ann_info': ann,
                    'pred_instances_3d': {
                        'bboxes_3d': out['bboxes_3d'][b],
                        'scores_3d': out['scores_3d'][b],
                        'target_scores_3d': out['scores_3d'][b]},
                }])
        results = metric.evaluate()
        logger.info('val results: %s',
                    {k: round(v, 4) for k, v in results.items()})
        if results:
            self._log_scalars({f'val/{k}': v for k, v in results.items()})
        with open(os.path.join(self.work_dir, 'val_results.json'), 'w') as f:
            json.dump(results, f)
        return results

    def test(self, resume: Optional[str] = None, tta: bool = False):
        return self.val(resume=resume, tta=tta)
