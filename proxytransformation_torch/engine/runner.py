"""Runner: config → dataset, model and optimizer → train / val / test loops.

Counterpart of proxytransformation_tpu/engine/runner.py (mmengine's
Runner in the reference) for the grounding, detection and occupancy
tasks: `Runner.from_cfg(cfg)` builds everything from a python-file
config, `train()` runs the epoch loop over `engine.train.make_train_step`,
`val()` / `test()` run predict and the task's metric (the grounding
metric, with test-time augmentation on request; for the detector the
batched 3D NMS of the config's `test_cfg`, then `IndoorDetMetric`; for
the occupancy models `OccupancyMetric` against the dense gt at full
resolution). Fresh weights follow flax's initialisers
(`models/init.py`), seeded from the config. A checkpoint each epoch
with rotation, auto-resume and fast resume (the loader's order is a
function of its seed and epoch, so the consumed batches of an epoch are
skipped, as the reference's FastResumeIterBasedTrainLoop does,
runner/loops.py:19-84).

Each process runs on one device: `device=None` is the card (raising
without one, `device.resolve_device`); pass `device='cpu'` for the
plain PyTorch path. Inside a process group (`parallel/`, the CLIs'
`--launcher pytorch`) the runner is data-parallel as the JAX Runner's
mesh is: the train loader is sharded by node and each rank loads its
slice of the node's batch (the ranks must divide it: the JAX Runner
would fit its mesh to fewer devices, the port raises), rank 0's fresh
state is broadcast, the step computes the global batch's norms, loss
normalisers, draws and gradients (`engine/train.py`), val deals the
loader's batches to the ranks in turn and gathers the predictions back
in loader order for rank 0's metric, and rank 0 alone writes
checkpoints, logs, scalars and result files (a barrier after each).
That holds for every task: the occupancy models' batch-coupled
reductions are the ImVoxel neck's train-mode norms (global sums) and
each scale's batch mean of per-sample losses (the global mean over
equal slices). The recipe (lr, weight decay, clip norm, milestones,
gamma, the decoder's lr multiplier) comes from the config, and so does
the EMA hook (`custom_hooks`: `ExpMomentumEMA`, advanced after each
optimizer step, carried in the checkpoint and swapped in for val and
test). What the port cannot honour raises rather than being dropped:
other text towers, other hooks, `--amp` on the detector and the
occupancy models, TTA outside grounding, and any model-config key the
builders do not take.
"""
from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DataLoader
from ..data.preprocessor import Det3DDataPreprocessor
from ..data import dataset, synthetic  # noqa: F401  (register datasets)
from ..device import resolve_device
from ..eval import (grounding_metric, indoor_eval,  # noqa: F401  (metrics)
                    occupancy_metric)
from ..models.detector import (SparseFeatureFusion3DGrounder,
                               SparseFeatureFusion3DGrounderPreshape,
                               batch_to_device)
from ..models.embodied_det3d import Embodied3DDetector
from ..models.init import flax_init_
from ..models.misc import ExpMomentumEMA
from ..models.occ import (DenseFusionOccPredictor, EmbodiedOccPredictor,
                          occ_multiscale_supervision)
from ..models.resnet import ResNet, check_img_depth_for_neck
from ..models.tta import merge_aug_bboxes_3d
from ..ops.nms3d import multiclass_nms
from ..parallel.dist import barrier, broadcast_state, context
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
# the val metric of each task when the config names none
_DEFAULT_METRIC = {'grounding': 'GroundingMetric',
                   'detection': 'IndoorDetMetric',
                   'occupancy': 'OccupancyMetric'}
# keys of the EMA hook the port honours (`priority` orders hooks, and the
# port has no other)
_EMA_HOOK_KEYS = {'type', 'ema_type', 'momentum', 'gamma', 'priority'}

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

# the detector's keywords, read as the grounder's are
_DET_FLAT_KEYS = ('voxel_size', 'n_points', 'num_classes', 'voxel_extent',
                  'pts_prune_threshold')
_DET_NESTED_KEYS = {
    'backbone': {'base_channels': 'img_base_channels', 'depth': 'img_depth'},
    'backbone_3d': {'depth': 'backbone3d_depth',
                    'capacities': 'sparse_capacities'},
    'bbox_head': {'out_channels': 'head_out_channels',
                  'pts_prune_threshold': 'pts_prune_threshold',
                  'pts_assign_threshold': 'pts_assign_threshold',
                  'pts_center_threshold': 'pts_center_threshold'},
}
_DET_FIXED = {
    ('backbone', 'type'): 'ResNet',
    ('backbone_3d', 'type'): 'MinkResNet',
    ('backbone_3d', 'in_channels'): 3,
    ('coord_type', ): 'DEPTH',
}
# bbox_head entries checked against the model's own values: type and
# num_reg_outs choose the rotation parameters, the rest must agree
_DET_HEAD_CHECKED = ('type', 'num_reg_outs', 'num_classes', 'voxel_size',
                     'in_channels')
_HEAD_ROT = {'FCAF3DHead': 'euler', 'FCAF3DHeadRotMat': 'ortho6d'}
_REG_OUTS_ROT = {9: 'euler', 12: 'ortho6d'}
# test_cfg keys and defaults (the JAX Runner's val, engine/runner.py:
# 636-647)
_TEST_CFG = {'score_thr': 0.01, 'iou_thr': 0.5, 'nms_pre': 1000,
             'max_out': 256}


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
    return _MODEL_TASKS[mtype]


def _check_fixed(cfg: Dict[str, Any], fixed: Dict[tuple, Any]) -> None:
    for key, want in fixed.items():
        d = cfg
        for part in key[:-1]:
            d = d.get(part, {})
        if key[-1] in d and d[key[-1]] != want:
            raise NotImplementedError(
                f'model.{".".join(key)}={d[key[-1]]!r}: the port builds '
                f'{want!r} only')


def _painted_widths(kw: Dict[str, Any]) -> List[int]:
    """The painted levels' widths: MinkResNet's 64/128/256/512 plus the
    2D ResNet's stage widths at the model's depth and base."""
    img = ResNet.stage_channels(kw.get('img_depth', 50),
                                kw.get('img_base_channels', 16))
    return [m + c for m, c in zip((64, 128, 256, 512), img)]


def _build_detection_model(model_cfg: Dict[str, Any],
                           device=None) -> Embodied3DDetector:
    """`Embodied3DDetector` of a detection config
    (configs/detection/*.py; the JAX package's `_build_detection_model`,
    engine/runner.py:54-83, which drops unknown keys). Every key must
    reach the detector, hold its one fixed value or agree with what the
    detector derives; anything else raises."""
    cfg = dict(model_cfg)
    if 'compute_dtype' in cfg or 'remat_painting' in cfg:
        raise NotImplementedError(
            'Embodied3DDetector runs in float32 only: the JAX package\'s '
            'detector has no bfloat16 mode (--amp sets compute_dtype), '
            'and the port adds no feature the reference lacks')
    kw: Dict[str, Any] = {k: cfg[k] for k in _DET_FLAT_KEYS if k in cfg}
    if 'voxel_extent' in kw:
        kw['voxel_extent'] = tuple(kw['voxel_extent'])
    unknown = []
    for sub, table in _DET_NESTED_KEYS.items():
        for k, v in cfg.get(sub, {}).items():
            if k in table:
                if table[k] in kw and kw[table[k]] != v:
                    raise ValueError(f'model.{sub}.{k}={v!r} differs from '
                                     f'model.{k}={kw[table[k]]!r}')
                kw[table[k]] = tuple(v) if k == 'capacities' else v
            elif (sub, k) not in _DET_FIXED and not (
                    sub == 'bbox_head' and k in _DET_HEAD_CHECKED):
                unknown.append(f'{sub}.{k}')
    _check_fixed(cfg, _DET_FIXED)
    unknown += [k for k in cfg if k not in {
        *_DET_FLAT_KEYS, *_DET_NESTED_KEYS, 'type', 'data_preprocessor',
        'coord_type', 'test_cfg'}]
    unknown += [f'test_cfg.{k}' for k in cfg.get('test_cfg', {})
                if k not in _TEST_CFG]
    if unknown:
        raise ValueError(f'model config keys the port does not take: '
                         f'{sorted(unknown)}')
    head = cfg.get('bbox_head', {})
    rot = _HEAD_ROT.get(head.get('type', 'FCAF3DHead'))
    if rot is None:
        raise NotImplementedError(f'bbox_head.type={head["type"]!r}: the '
                                  f'port has {sorted(_HEAD_ROT)}')
    if 'num_reg_outs' in head:
        by_outs = _REG_OUTS_ROT.get(head['num_reg_outs'])
        if by_outs is None or (head.get('type') == 'FCAF3DHeadRotMat'
                               and by_outs != rot):
            raise ValueError(f'bbox_head.num_reg_outs='
                             f'{head["num_reg_outs"]!r} with '
                             f'{head.get("type", "FCAF3DHead")}')
        rot = by_outs     # 12 outputs are the RotMat head's
    kw['rot_param'] = rot
    if 'num_classes' in head and kw.setdefault(
            'num_classes', head['num_classes']) != head['num_classes']:
        raise ValueError(f'bbox_head.num_classes={head["num_classes"]!r} '
                         f'differs from model.num_classes='
                         f'{kw["num_classes"]!r}')
    if 'voxel_size' in head and head['voxel_size'] != kw.get('voxel_size',
                                                             0.01):
        raise ValueError('bbox_head.voxel_size differs from the model\'s '
                         'voxel_size, which the head uses')
    check_img_depth_for_neck(kw.get('img_depth', 50), 'Embodied3DDetector')
    if 'in_channels' in head:
        derived = _painted_widths(kw)
        if list(head['in_channels']) != derived:
            raise ValueError(f'bbox_head.in_channels {head["in_channels"]} '
                             f'differ from the derived {derived}')
    return Embodied3DDetector(**kw, device=device)


# the occupancy models' keywords (the JAX package's `_build_occ_model`,
# engine/runner.py:86-111)
_OCC_FLAT_KEYS = ('n_voxels', 'voxel_range', 'num_classes')
_OCC_NESTED_KEYS = {
    'backbone': {'base_channels': 'img_base_channels', 'depth': 'img_depth'},
    'neck_3d': {'out_channels': 'neck_channels'},
    'bbox_head': {'use_semantic': 'use_semantic'},
}
_OCC_FIXED = {
    ('backbone', 'type'): 'ResNet',
    ('neck_3d', 'type'): 'IndoorImVoxelNeck',
    ('bbox_head', 'type'): 'ImVoxelOccHead',
}
_OCC_MODELS = {'EmbodiedOccPredictor': EmbodiedOccPredictor,
               'DenseFusionOccPredictor': DenseFusionOccPredictor}


def _build_occ_model(model_cfg: Dict[str, Any], device=None):
    """`EmbodiedOccPredictor` / `DenseFusionOccPredictor` of an occupancy
    config (configs/occupancy/*.py), reading what the JAX package's
    `_build_occ_model` reads (which drops any other key). Every key must
    reach the model or hold its one fixed value; `bbox_head.num_classes`
    must agree with `num_classes`; anything else raises."""
    cfg = dict(model_cfg)
    if 'compute_dtype' in cfg or 'remat_painting' in cfg:
        raise NotImplementedError(
            f'{cfg["type"]} runs in float32 only: the JAX package\'s '
            'occupancy models have no bfloat16 mode (--amp sets '
            'compute_dtype)')
    kw: Dict[str, Any] = {k: cfg[k] for k in _OCC_FLAT_KEYS if k in cfg}
    unknown = []
    for sub, table in _OCC_NESTED_KEYS.items():
        for k, v in cfg.get(sub, {}).items():
            if k in table:
                kw[table[k]] = v
            elif (sub, k) not in _OCC_FIXED and (sub, k) != ('bbox_head',
                                                             'num_classes'):
                unknown.append(f'{sub}.{k}')
    unknown += [k for k in cfg if k not in {
        *_OCC_FLAT_KEYS, *_OCC_NESTED_KEYS, 'type', 'data_preprocessor'}]
    if unknown:
        raise ValueError(f'model config keys the port does not take: '
                         f'{sorted(unknown)}')
    _check_fixed(cfg, _OCC_FIXED)
    head = cfg.get('bbox_head', {})
    if 'num_classes' in head and kw.setdefault(
            'num_classes', head['num_classes']) != head['num_classes']:
        raise ValueError(f'bbox_head.num_classes={head["num_classes"]!r} '
                         f'differs from model.num_classes='
                         f'{kw["num_classes"]!r}')
    return _OCC_MODELS[cfg['type']](**kw, device=device)


def build_model_from_cfg(model_cfg: Dict[str, Any], device=None):
    """The grounder (the flagship or the baseline), the detector or an
    occupancy model of a reference-style nested model config (the JAX
    package's keyword mapping, engine/runner.py:54-181). Every key must
    reach the model or hold the one value the port has fixed; another key
    or value raises, so that no knob is dropped silently (the JAX
    package's own `--amp` once was, engine/runner.py:140-143). The
    baseline `SparseFeatureFusion3DGrounder` is built as itself (the JAX
    Runner builds the preshape grounder for it) and takes no `preshape`
    block."""
    task = _model_task(model_cfg)
    if task == 'detection':
        return _build_detection_model(model_cfg, device)
    if task == 'occupancy':
        return _build_occ_model(model_cfg, device)
    baseline = model_cfg.get('type') == 'SparseFeatureFusion3DGrounder'
    if baseline and 'preshape' in model_cfg:
        raise ValueError('model.preshape: SparseFeatureFusion3DGrounder is '
                         'the baseline without the preshape module')
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
    _check_fixed(cfg, _FIXED)
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
    cls = (SparseFeatureFusion3DGrounder if baseline
           else SparseFeatureFusion3DGrounderPreshape)
    check_img_depth_for_neck(kw.get('img_depth', 50), cls.__name__)
    if 'in_channels' in neck:
        derived = _painted_widths(kw)
        if list(neck['in_channels']) != derived:
            raise ValueError(f'neck_3d.in_channels {neck["in_channels"]} '
                             f'differ from the derived {derived}')
    return cls(**kw, device=device)


def ema_from_hooks(hooks) -> Optional[ExpMomentumEMA]:
    """The EMA of `custom_hooks`, as the JAX Runner's `_ema` reads it
    (engine/runner.py:315-330): `EMAHook` with `ema_type='ExpMomentumEMA'`
    (or no ema_type) or `ExpMomentumEMA`, with `momentum` and `gamma`.
    Another hook, another ema_type or a key the port does not take
    raises."""
    ema = None
    for hook in hooks or []:
        kind = hook.get('type', '')
        if kind not in ('EMAHook', 'ExpMomentumEMA') \
                or hook.get('ema_type', 'ExpMomentumEMA') != 'ExpMomentumEMA':
            raise NotImplementedError(
                f'custom hook {hook}: the port has the ExpMomentumEMA hook '
                'only')
        unknown = sorted(set(hook) - _EMA_HOOK_KEYS)
        if unknown:
            raise NotImplementedError(
                f'custom hook {hook}: keys {unknown} are not honoured')
        if ema is not None:
            raise NotImplementedError(f'custom hook {hook}: a second EMA hook')
        ema = ExpMomentumEMA(momentum=hook.get('momentum', 0.0002),
                             gamma=hook.get('gamma', 2000))
    return ema


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
        self.dist = context()
        self.task = _model_task(cfg['model'])
        self.device = resolve_device(device)
        self.ema = ema_from_hooks(cfg.get('custom_hooks'))
        # name → float32 EMA copy of each parameter (buffers are not
        # averaged, as in the JAX package)
        self.ema_state: Optional[Dict[str, torch.Tensor]] = None
        self.work_dir = work_dir or cfg.get('work_dir', './work_dir')
        os.makedirs(self.work_dir, exist_ok=True)
        logging.basicConfig(level=logging.INFO)
        # rank 0 logs; the other ranks say only what goes wrong
        logger.setLevel(logging.INFO if self.dist.is_main
                        else logging.WARNING)

        self.model = build_model_from_cfg(cfg['model'], self.device)
        pp_cfg = dict(cfg['model'].get('data_preprocessor', {}))
        pp_cfg.pop('type', None)
        pp_cfg.setdefault('n_points', getattr(self.model, 'n_points',
                                              100_000))
        pp_cfg.setdefault('max_text_len',
                          getattr(self.model, 'max_text_len', 256))
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
        self.vis_backends = (build_vis_backends(cfg, self.work_dir)
                             if self.dist.is_main else [])

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
        dataset = DATASETS.build(ds_cfg)
        n_views = self._pipeline_n_views(ds_cfg)
        collate = (self.preprocessor
                   if n_views is None or n_views == self.preprocessor.n_views
                   else self._make_preprocessor(n_views))
        ctx = self.dist
        # the config's workers are the node's: split over its ranks
        workers = loader_cfg.get('num_workers', 0)
        if workers:
            workers = max(1, workers // ctx.local_world)
        # train: a shard a node and a slice of each batch a rank; val and
        # test: the whole loader, its batches dealt to the ranks in turn
        return DataLoader(dataset,
                          batch_size=loader_cfg.get('batch_size', 1),
                          collate_fn=collate,
                          shuffle=train and loader_cfg.get(
                              'sampler', {}).get('shuffle', True),
                          drop_last=train,
                          num_shards=ctx.nodes if train else 1,
                          shard_id=ctx.node if train else 0,
                          rank_slice=((ctx.local_rank, ctx.local_world)
                                      if train else (0, 1)),
                          deal=(0, 1) if train else (ctx.rank, ctx.world),
                          num_workers=workers)

    def _split_batch(self, batch) -> Tuple[Dict[str, torch.Tensor], Dict]:
        device = {k: v for k, v in batch.items() if k in _DEVICE_KEYS}
        host = {k: v for k, v in batch.items() if k not in _DEVICE_KEYS}
        check = getattr(self.model, 'check_text_ids', None)
        if check is not None and 'input_ids' in device:
            check(device['input_ids'])   # on the host, before the card
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
        """Seeded weights by flax's initialisers (drawn on the CPU, so
        every device starts from the same ones), the EMA copy of them, the
        config's optimizer and schedule, the dropout generator (seed + 1,
        alike on every rank) and the `load_from` warm start; then rank 0's
        parameters, buffers and EMA copy on every rank."""
        seed = self.cfg.get('seed', 0)
        flax_init_(self.model, torch.Generator().manual_seed(seed))
        # the EMA starts from the seeded weights, before the warm start, as
        # the JAX package's create_train_state(with_ema=True) does
        self.ema_state = None if self.ema is None else {
            n: p.detach().clone() for n, p in self.model.named_parameters()}
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
        broadcast_state(self.model, self.ema_state)

    def _save(self, epoch: int, iteration: int = 0) -> None:
        """The checkpoint, from rank 0 alone; every rank waits for it."""
        if self.dist.is_main:
            max_keep = self.cfg.get('default_hooks', {}).get(
                'checkpoint', {}).get('max_keep_ckpts', 2)
            path = save_checkpoint(
                self.work_dir, self.model, self.optimizer, self.global_step,
                epoch, max_keep, iteration=iteration,
                generator=self.generator, ema=self.ema_state)
            logger.info('saved checkpoint %s', path)
        barrier()

    def resume_from(self, path: str) -> Tuple[int, int]:
        """Full resume from a checkpoint directory: the model, the AdamW
        state, the generator and the global step; returns (epoch,
        iteration) to continue from."""
        logger.info('resuming from %s', path)
        payload = load_checkpoint(path)
        restore_state(self.model, self.optimizer, payload, self.generator,
                      self.ema_state)
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
        params = dict(self.model.named_parameters())
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
                if self.ema is not None:
                    # the JAX train step passes the step count before it
                    self.ema.update(self.ema_state, params, self.global_step)
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
                    self._save(epoch, iteration=i + 1)
            self._sync()
            n_done = max(len(loader) - start_iter, 1)
            self.train_timing = {
                'iter_s': (time.time() - t0) / n_done,
                'data_wait_s': data_sum / max(n_done - 1, 1),
                'first_wait_s': first_wait,
            }
            start_iter = 0
            self._save(epoch + 1)
            if (epoch + 1) % val_interval == 0:
                self.val(init_state=False)
        return self.model

    # ------------------------------------------------------------------
    def _tta_metas(self):
        """The augmented copies of `tta_cfg`, as MultiScaleFlipAug3D
        enumerates them (reference test_time_aug.py:13-119; the JAX
        Runner's `_tta_metas`): each scale of `pts_scale_ratio`, without
        and (with `flip`) with each flip direction."""
        tta_cfg = self.cfg.get('tta_cfg', {})
        scales = tta_cfg.get('pts_scale_ratio', [1.0])
        if isinstance(scales, (int, float)):
            scales = [scales]
        flip = tta_cfg.get('flip', True)
        directions = tta_cfg.get('flip_direction', ['horizontal'])
        if isinstance(directions, str):
            directions = [directions]
        metas = []
        for s in scales:
            for do_flip in ([False, True] if flip else [False]):
                for d in (directions if do_flip else ['horizontal']):
                    metas.append({
                        'pcd_scale_factor': float(s),
                        'pcd_horizontal_flip': do_flip and d == 'horizontal',
                        'pcd_vertical_flip': do_flip and d == 'vertical',
                    })
        return metas

    @staticmethod
    def _apply_tta_aug(batch, meta):
        """An augmented copy of a collated (numpy) batch: the points
        flipped and scaled, and the flags and scale the painting's inverse
        replay reads (the reference's aug_test, sparse_featfusion_grounder_
        preshape.py:1031-1074)."""
        out = dict(batch)
        pts = np.array(batch['points'], np.float32, copy=True)
        if meta['pcd_horizontal_flip']:
            pts[..., 0] *= -1
        if meta['pcd_vertical_flip']:
            pts[..., 1] *= -1
        s = meta.get('pcd_scale_factor', 1.0)
        if s != 1.0:
            pts[..., :3] *= s
        out['points'] = pts
        B = pts.shape[0]
        out['pcd_flip_x'] = np.full((B, ), meta['pcd_horizontal_flip'])
        out['pcd_flip_y'] = np.full((B, ), meta['pcd_vertical_flip'])
        base = np.asarray(batch.get('pcd_scale_factor',
                                    np.ones((B, 1), np.float32)), np.float32)
        out['pcd_scale_factor'] = base * s
        return out

    @classmethod
    def _stack_tta_batches(cls, batch, aug_metas):
        """Every augmented copy stacked along the batch axis, so one
        forward predicts them all; host lists stay those of the batch."""
        augs = [cls._apply_tta_aug(batch, m) for m in aug_metas]
        return {k: (np.concatenate([a[k] for a in augs], axis=0)
                    if isinstance(v, np.ndarray) and v.ndim > 0 else v)
                for k, v in augs[0].items()}

    def _predict(self, batch, bs: int, aug_metas):
        """The model's outputs for one padded batch and its host part: a
        list with one entry per augmented copy (one entry without TTA),
        numpy but for the detector's, which stay on the device for its
        NMS."""
        if len(aug_metas) > 1:
            dev_batch, host = self._split_batch(
                self._stack_tta_batches(batch, aug_metas))
            out = {k: v.cpu().numpy() for k, v in self.model(dev_batch).items()}
            return [{k: v[i * bs:(i + 1) * bs] for k, v in out.items()}
                    for i in range(len(aug_metas))], host
        meta = aug_metas[0]
        dev_batch, host = self._split_batch(
            batch if meta is None else self._apply_tta_aug(batch, meta))
        out = self.model(dev_batch)
        if self.task == 'detection':
            return [out], host
        return [{k: v.cpu().numpy() for k, v in out.items()}], host

    def _occupancy_samples(self, out, anns):
        """Each scene's predicted labels beside its dense gt at full
        resolution (ratio 1) from the sparse `gt_occupancy` of its
        `eval_ann_info` (the JAX Runner's val, engine/runner.py:594-607)."""
        occ = out['occupancy']
        samples = []
        for b, ann in enumerate(anns):
            gt = torch.as_tensor(np.asarray(ann['gt_occupancy'], np.float32)
                                 .reshape(-1, 4))
            dense = occ_multiscale_supervision(
                gt, torch.ones(len(gt), dtype=torch.bool), 1,
                tuple(occ[b].shape))
            samples.append({'pred_occupancy': occ[b],
                            'gt_occupancy_dense': dense.numpy()})
        return samples

    def _grounding_preds(self, outs, aug_metas, n):
        """Per scene {'bboxes_3d', 'scores_3d', 'target_scores_3d'}; with
        TTA the copies merged by `merge_aug_bboxes_3d`."""
        preds = []
        for b in range(n):
            if aug_metas[0] is None:
                boxes, scores = outs[0]['bboxes_3d'][b], outs[0]['scores_3d'][b]
            else:
                merged = merge_aug_bboxes_3d(
                    [{'bboxes_3d': o['bboxes_3d'][b],
                      'scores_3d': o['scores_3d'][b]} for o in outs],
                    aug_metas)
                boxes, scores = merged['bboxes_3d'], merged['scores_3d']
            preds.append({'bboxes_3d': boxes, 'scores_3d': scores,
                          'target_scores_3d': scores})
        return preds

    def val(self, resume: Optional[str] = None, init_state: bool = True,
            tta: bool = False):
        """Predict over the val (else test) loader and score with the
        task's metric; `tta` predicts the augmented copies of `tta_cfg`
        in one forward and merges them (grounding only)."""
        if tta and self.task != 'grounding':
            raise NotImplementedError('TTA is a grounding-path feature')
        loader_cfg = self.cfg.get('val_dataloader') \
            or self.cfg.get('test_dataloader')
        loader = self._build_loader(loader_cfg, train=False)
        self._steps_per_epoch = max(len(loader), 1)
        metric_cfg = dict(self.cfg.get('val_evaluator', {}))
        metric_cfg.setdefault('type', _DEFAULT_METRIC[self.task])
        if metric_cfg['type'] == 'GroundingMetric':
            # a leaderboard dump (format_only) goes to the work dir
            metric_cfg.setdefault('result_dir', self.work_dir)
        metric = METRICS.build(metric_cfg)

        bs = loader_cfg.get('batch_size', 1)
        if init_state or self.optimizer is None:
            self._init_state()
            if resume:
                payload = load_checkpoint(resume)
                self.model.load_state_dict(payload['model'])
                self._load_ema(payload, resume)
            else:
                logger.warning(
                    'val() is scoring freshly-initialized random weights '
                    '(no checkpoint given) — pass resume=CKPT or call '
                    'after train() for a meaningful metric')
        aug_metas = self._tta_metas() if tta else [None]
        # each sample's place in the loader's order, for the gather
        order = []
        with self._ema_weights():
            for pos, batch in zip(loader.positions(), loader):
                batch, _ = self._pad_batch(batch, bs)
                outs, host = self._predict(batch, bs, aug_metas)
                anns = host['eval_ann_info']
                if self.task == 'detection':
                    samples = [{'eval_ann_info': ann, 'pred_instances_3d': p}
                               for ann, p in zip(anns,
                                                 self._detections(outs[0]))]
                elif self.task == 'occupancy':
                    samples = self._occupancy_samples(outs[0], anns)
                else:
                    samples = [{'eval_ann_info': ann, 'pred_instances_3d': p}
                               for ann, p in zip(anns, self._grounding_preds(
                                   outs, aug_metas, len(anns)))]
                for j, sample in enumerate(samples):
                    metric.process(None, [sample])
                    order.append((pos, j))
        results = (metric.evaluate(order=order) if self.dist.world > 1
                   else metric.evaluate())
        logger.info('val results: %s',
                    {k: round(v, 4) for k, v in results.items()})
        if results:
            self._log_scalars({f'val/{k}': v for k, v in results.items()})
        if self.dist.is_main:
            with open(os.path.join(self.work_dir, 'val_results.json'),
                      'w') as f:
                json.dump(results, f)
        barrier()
        return results

    def _detections(self, out: Dict[str, torch.Tensor]):
        """The detector's outputs through the batched per-class NMS of
        `test_cfg` (on the device) → per scene {'bboxes_3d', 'scores_3d',
        'labels_3d'} of the kept boxes, numpy."""
        test_cfg = dict(_TEST_CFG, **self.cfg['model'].get('test_cfg', {}))
        nms = multiclass_nms(out['bboxes_3d'], out['scores_3d'], out['mask'],
                             **test_cfg)
        boxes, scores, labels, valid = (a.cpu().numpy() for a in nms)
        return [{'bboxes_3d': boxes[b][valid[b]],
                 'scores_3d': scores[b][valid[b]],
                 'labels_3d': labels[b][valid[b]].astype(np.int64)}
                for b in range(len(valid))]

    def _load_ema(self, payload: Dict[str, Any], path: str) -> None:
        """The checkpoint's EMA weights into `ema_state`; a checkpoint
        saved without the hook leaves its own weights there."""
        if self.ema_state is None:
            return
        src = payload.get('ema')
        if src is None:
            logger.warning('%s holds no EMA weights: the EMA hook starts '
                           'from its parameters', path)
            src = payload['model']
        with torch.no_grad():
            for name, e in self.ema_state.items():
                e.copy_(src[name])

    @contextmanager
    def _ema_weights(self):
        """With the EMA hook, the parameters hold the EMA weights for the
        duration (mmengine's EMAHook swap, reference ema.py:123-189; the
        JAX Runner's val, engine/runner.py:553-557); running statistics
        stay the model's."""
        if self.ema_state is None:
            yield
            return
        logger.info('validating with EMA-averaged weights')
        params = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.ema_state[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])

    def test(self, resume: Optional[str] = None, tta: bool = False):
        return self.val(resume=resume, tta=tta)
