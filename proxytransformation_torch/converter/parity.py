"""The port's side of the activation-parity harness.

`record_activations(model, batch)` runs one predict request of a port
grounder (or a standalone `MinkResNet` on a `SparseLevel`, or a
standalone 2D `ResNet` on its NHWC images) with forward
hooks on its modules and returns the npz contract that the JAX package's
`converter/parity.py::check_parity` replays (its docstring, :17-61):

  text_feat_map              in0 (B, L, Ct) / out (B, L, C)
  text_encoder               in0 ids / in1 mask / out (B, L, Ct)
  bbox_head.reg_branch       in0 (..., C) / out (..., 9) (the first call)
  preshape.simple_encoder    in0 center / in1 cluster / out
  preshape.get_offsets       in0 center / in1 cluster / out, before the
                             tanh · margin
  backbone                   in0 images NCHW / out0..3 NCHW
  backbone_3d.stem           in_coords / in_feats of level 0, out_coords /
                             out_feats of conv1 before norm1
  backbone_3d                in_coords / in_feats, out{i}_coords /
                             out{i}_feats of every stage
  decoder                    the eight named inputs, out (L, B, Q, C)
                             stacked intermediates and out_bboxes
  detector                   in_{key} of every predict key, out_bboxes,
                             out_scores

Sparse coordinates are MinkowskiEngine's (b, x, y, z) in finest-voxel
units, and rows a level masks are dropped, as ME holds no such rows. A
standalone MinkResNet records its two families only, a standalone
ResNet (any depth: the harness reads it off the converted tree) the
`backbone` family only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops.sparse import SparseLevel, downsample_coords

PREDICT_KEYS = ('imgs', 'points', 'points_mask', 'input_ids', 'text_mask',
                'proj_mats', 'views_mask')
DECODER_INPUTS = ('query', 'key', 'key_padding_mask', 'query_coords',
                  'key_coords', 'pred_bboxes', 'text_feats',
                  'text_attention_mask')


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _nchw(t: torch.Tensor) -> np.ndarray:
    return _np(t.permute(0, 3, 1, 2))


class _Recorder:
    def __init__(self):
        self.acts: Dict[str, np.ndarray] = {}
        self.handles = []

    def hook(self, mod: nn.Module, fn, with_kwargs=False):
        self.handles.append(mod.register_forward_hook(
            fn, with_kwargs=with_kwargs))

    def first(self, key: str, value: np.ndarray) -> None:
        self.acts.setdefault(key, value)

    def io(self, name: str):
        """Record the tensor inputs and output of a module's first call."""
        def fn(mod, args, out):
            if f'{name}.out' in self.acts:
                return
            for i, x in enumerate(args):
                if torch.is_tensor(x):
                    self.acts[f'{name}.in{i}'] = _np(x)
            self.acts[f'{name}.out'] = _np(out)
        return fn

    def backbone_3d(self, mod):
        """The stem's conv1 (its level-1 rows from level 0 again) and every
        stage of a MinkResNet."""
        conv1 = {}
        self.hook(mod.conv1, lambda m, a, out: conv1.setdefault('out', out))

        def fn(m, args, out):
            level0: SparseLevel = args[0]
            lvl1 = downsample_coords(level0, m.capacities[0])
            for name in ('backbone_3d.stem', 'backbone_3d'):
                self.first(f'{name}.in_coords', _np(level0.C))
                self.first(f'{name}.in_feats', _np(level0.F))
            self.first('backbone_3d.stem.out_coords', _np(lvl1.C))
            self.first('backbone_3d.stem.out_feats',
                       _np(conv1['out'][lvl1.mask]))
            for i, lvl in enumerate(out[0]):
                self.first(f'backbone_3d.out{i}_coords', _np(lvl.C))
                self.first(f'backbone_3d.out{i}_feats', _np(lvl.F))
        self.hook(mod, fn)

    def backbone(self, mod, args, out):
        """The 2D ResNet's images and its four stages, NCHW."""
        self.first('backbone.in0', _nchw(args[0]))
        for i, o in enumerate(out):
            self.first(f'backbone.out{i}', _nchw(o))

    def close(self):
        for h in self.handles:
            h.remove()


@torch.no_grad()
def record_activations(model: nn.Module, batch) -> Dict[str, np.ndarray]:
    """The npz contract of one eval forward: `model` a port grounder and
    `batch` its batch dict (tensors on the model's device), `model` a
    `MinkResNet` and `batch` its level-0 `SparseLevel`, or `model` a 2D
    `ResNet` and `batch` its (N, H, W, 3) images."""
    from ..models.resnet import ResNet
    from ..models.sparse_resnet import MinkResNet
    rec = _Recorder()
    try:
        if isinstance(model, MinkResNet):
            rec.backbone_3d(model)
            model(batch)
            return rec.acts
        rec.hook(model if isinstance(model, ResNet) else model.backbone,
                 rec.backbone)
        if isinstance(model, ResNet):
            model(batch)
            return rec.acts
        for name in ('text_feat_map', 'text_encoder'):
            rec.hook(getattr(model, name), rec.io(name))
        rec.hook(model.bbox_head.reg_branches[0],
                 rec.io('bbox_head.reg_branch'))
        if hasattr(model, 'preshape'):      # the baseline has none
            for name in ('simple_encoder', 'get_offsets'):
                rec.hook(getattr(model.preshape, name),
                         rec.io(f'preshape.{name}'))
        rec.backbone_3d(model.backbone_3d)

        def decoder(mod, args, kwargs, out):
            for k, x in zip(DECODER_INPUTS, args):
                rec.first(f'decoder.{k}', _np(x))
            rec.first('decoder.out', _np(out[0]))
            rec.first('decoder.out_bboxes', _np(out[1]))
        rec.hook(model.decoder, decoder, with_kwargs=True)

        out = model(batch)     # predict: eval mode whatever model.training
        for k in PREDICT_KEYS:
            rec.acts[f'detector.in_{k}'] = _np(batch[k])
        rec.acts['detector.out_bboxes'] = _np(out['bboxes_3d'])
        rec.acts['detector.out_scores'] = _np(out['scores_3d'])
        return rec.acts
    finally:
        rec.close()
