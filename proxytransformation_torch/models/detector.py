"""End-to-end ego-centric 3D visual grounder (the flagship), and the
baseline without the preshape.

Counterpart of proxytransformation_tpu/models/detector.py::
SparseFeatureFusion3DGrounderPreshape and ::SparseFeatureFusion3DGrounder
(the baseline voxelizes the raw points: no ProxyTransformation module,
and no `preshape.*` parameters), in float32 or, with
`compute_dtype='bfloat16'`, in the reference's bfloat16 mode: `forward`
is predict (eval mode, no gradient), `loss` the train-mode losses
(mode='loss'):

  imgs (B,V,H,W,3) ──ResNet50──► 4 image levels ──┐
  input_ids (B,L) ──CLIP text──► text feats ──────┤
  points (B,N,3)+mask ──ProxyTransformation◄──────┘
      │ voxelize (xyz feats)
      ▼
  MinkResNet34 ──► 4 sparse levels ──2D→3D painting──►
  MinkNeck FPN + prune ──► (B, 4·P, C) tokens
      │ top-k queries by contrastive score
      ▼
  6-layer decoder with box refinement ──► GroundingHead.predict / .loss

Batch dict (padded, masked tensors on the model's device): imgs, points,
points_mask, input_ids, text_mask, proj_mats (B,V,4,4), views_mask and
optionally pcd_rotation / pcd_scale_factor / pcd_trans / pcd_flip_x /
pcd_flip_y; for the loss also gt_bboxes (B,G,9), gt_masks (B,G) and
positive_maps (B,G,max_text_len).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import full_float32, resolve_device
from ..ops.sparse import topk_stable, voxelize_points
from .decoder import SparseFeatureFusionTransformerDecoder
from .grounding_head import GroundingHead
from .layers import linear, random_init_
from .point_fusion import apply_inverse_aug, batch_point_sample
from .preshape import ProxyTransformationNormReverse
from .resnet import ResNet, check_img_depth_for_neck
from .sparse_neck import MinkNeck
from .sparse_resnet import MinkResNet, check_backbone3d_depth
from .text_encoder import CLIPTextEncoder
from .text_variants import build_text_encoder


_COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class SparseFeatureFusion3DGrounderPreshape(nn.Module):
    """The flagship grounder; defaults are the flagship config
    (configs/grounding/proxy-tiblock33-gs12-wbias-ddr0.6-clip.py).

    `device=None` builds it on the card and raises when there is none;
    pass `device='cpu'` to run the plain PyTorch path on the CPU.

    `compute_dtype='bfloat16'` is the reference's `--amp` mode
    (reference models/detector.py:95-146): the 2D ResNet, the preshape's
    dense layers and attention, MinkResNet after its stem conv and the
    decoder compute in bfloat16, the neck and the painting keep the
    dtype they are given, and geometry, norm statistics, scores and
    losses stay float32; parameters stay float32. Its sparse convs run
    the bf16 form of the conv kernels on the card.

    `remat` recomputes the 2D ResNet's blocks, MinkResNet's basic blocks
    and the decoder layers in the backward (`torch.utils.checkpoint`, as
    `nn.remat` in the reference; the recompute leaves BatchNorm running
    statistics alone). `remat_painting` does the same for the 2D→3D
    painting (reference detector.py:202-204); None follows `remat`.
    `use_xyz_feat=False` voxelizes the point channels after xyz (colour)
    as features instead of xyz. `t_type` names the text tower: 'clip'
    builds the CLIP tower of `text_width`, `text_layers` and `text_heads`;
    any other `text_variants.build_text_encoder` accepts (Roberta, BERT,
    FLAVA, T5, DeBERTa, open_clip, the HF-CLIP sizes) builds that tower
    at its published size, and `text_feat_map` reads its width. The tower
    is frozen (no gradient, no update). MinkResNet depths 50 and 101 are
    refused: the neck takes the 64/128/256/512 channels of the basic
    stages (as in the JAX package, which cannot build them either). The
    2D ResNet (`img_depth`) is 50 or 101: 18 and 34 are refused, as the
    neck's widths assume the bottleneck's expansion of 4 (the JAX
    grounder fails at the neck's sum there).
    """

    # the baseline subclass builds no preshape module
    use_preshape = True

    def __init__(self, num_queries: int = 256, voxel_size: float = 0.01,
                 use_xyz_feat: bool = True,
                 max_text_len: int = 256, n_points: int = 100_000,
                 img_base_channels: int = 16, img_depth: int = 50,
                 t_type: str = 'clip', text_width: int = 768,
                 text_layers: int = 12, text_heads: int = 12,
                 grid_size: int = 12,
                 text_blocks: int = 3, img_blocks: int = 3,
                 dynamic_drop_radio: float = 0.6, num_sub: int = 30,
                 img_spacial_dim: int = 15, backbone3d_depth: int = 34,
                 sparse_capacities: Sequence[int] = (100_000, 80_000, 50_000,
                                                     20_000, 6_000, 2_000),
                 voxel_extent: Sequence[int] = (1280, 1280, 512),
                 neck_out_channels: int = 256, pts_prune_threshold: int = 1000,
                 decoder_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, ffn_channels: int = 2048,
                 remat: bool = False, compute_dtype: str = 'float32',
                 remat_painting: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f'compute_dtype must be one of '
                             f'{sorted(_COMPUTE_DTYPES)}, got {compute_dtype!r}')
        check_backbone3d_depth(backbone3d_depth)
        check_img_depth_for_neck(img_depth, type(self).__name__)
        cdt = _COMPUTE_DTYPES[compute_dtype]
        dev = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        self.remat_painting = (self.remat if remat_painting is None
                               else bool(remat_painting))
        self.use_xyz_feat = use_xyz_feat
        self.num_queries = num_queries
        self.voxel_size = voxel_size
        self.n_points = n_points
        self.max_text_len = max_text_len
        self.voxel_extent = tuple(voxel_extent)
        with torch.device(dev):
            self.backbone = ResNet(img_depth, img_base_channels, cdt,
                                   self.remat)
            if t_type == 'clip':
                self.text_encoder = CLIPTextEncoder(width=text_width,
                                                    layers=text_layers,
                                                    heads=text_heads)
            else:
                self.text_encoder, text_width = build_text_encoder(t_type)
            self.text_feat_map = linear(text_width, embed_dims)
            if self.use_preshape:
                self.preshape = ProxyTransformationNormReverse(
                    embed_dim=embed_dims, num_heads=num_heads,
                    grid_size=grid_size, text_blocks=text_blocks,
                    img_blocks=img_blocks,
                    dynamic_drop_radio=dynamic_drop_radio, num_sub=num_sub,
                    input_dim=self.backbone.out_channels[-1],
                    img_spacial_dim=img_spacial_dim, dtype=cdt)
            self.backbone_3d = MinkResNet(backbone3d_depth, 3,
                                          sparse_capacities, cdt,
                                          self.remat)
            img_chans = self.backbone.out_channels
            mink_chans = [64, 128, 256, 512]
            self.neck_3d = MinkNeck(
                1, tuple(m + i for m, i in zip(mink_chans, img_chans)),
                neck_out_channels, pts_prune_threshold)
            self.decoder = SparseFeatureFusionTransformerDecoder(
                decoder_layers, embed_dims, num_heads, ffn_channels, cdt,
                self.remat)
            self.bbox_head = GroundingHead(embed_dims, 9, max_text_len)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.text_feat_map.weight.device

    def check_text_ids(self, input_ids) -> None:
        """Raise when a host array of token ids has an id the text tower
        has no embedding for, or more tokens than its positions (call it
        before the batch goes to the card: an embedding there would
        assert; the tower checks CPU tensors itself)."""
        self.text_encoder.check_ids(input_ids)

    def random_init_(self, seed: int) -> 'SparseFeatureFusion3DGrounderPreshape':
        """Seeded random weights (see `layers.random_init_`)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return random_init_(self, gen)

    # ------------------------------------------------------------------
    def encode_text(self, input_ids, text_mask):
        return self.text_feat_map(self.text_encoder(input_ids, text_mask))

    def extract_feat(self, batch: Dict[str, Any], text_feats,
                     train: bool = False,
                     generator: Optional[torch.Generator] = None):
        imgs = batch['imgs']
        B, V, H, W, _ = imgs.shape
        img_feats = [f.reshape((B, V) + f.shape[1:])
                     for f in self.backbone(imgs.reshape(B * V, H, W, 3))]
        xyz = batch['points'][..., :3]
        if self.use_preshape:
            points, points_mask = self.preshape(
                xyz, batch['points_mask'], text_feats, batch['text_mask'],
                img_feats[-1], train, generator)
        else:
            points, points_mask = xyz, batch['points_mask']
        if self.use_xyz_feat:
            feats = points
        else:
            # the point channels after xyz (e.g. colour) as voxel features
            if batch['points'].shape[-1] <= 3:
                raise ValueError(
                    'use_xyz_feat=False needs points with >3 channels '
                    f'(got {batch["points"].shape[-1]}); keep color '
                    'channels in the pipeline or set use_xyz_feat=True')
            feats = batch['points'][..., 3:]
        lvl0 = voxelize_points(points, points_mask, feats, self.voxel_size,
                               self.n_points, self.voxel_extent)
        levels, self_maps, self_plans = self.backbone_3d(lvl0, train)

        def paint_fn(world_xyz, vmask, lvl_idx):
            inv = apply_inverse_aug(
                world_xyz, batch.get('pcd_rotation'),
                batch.get('pcd_scale_factor'), batch.get('pcd_trans'),
                batch.get('pcd_flip_x'), batch.get('pcd_flip_y'))
            args = (img_feats[lvl_idx], inv, batch['proj_mats'], (H, W),
                    vmask, batch['views_mask'])
            if self.remat_painting:
                return checkpoint(batch_point_sample, *args,
                                  use_reentrant=False)
            return batch_point_sample(*args)

        return self.neck_3d(levels, self_maps=self_maps,
                            self_plans=self_plans, paint_fn=paint_fn,
                            train=train)

    def pre_decoder(self, feats, xyz, feats_mask, text_feats, text_mask):
        """Top-k query selection by contrastive score; the selected boxes
        carry no gradient (reference detector.py:238)."""
        head = self.bbox_head
        enc_cls = head.cls_branches[0](feats, text_feats, text_mask,
                                       feats_mask)
        enc_cls = torch.where(torch.isfinite(enc_cls), enc_cls,
                              torch.full_like(enc_cls, -1e9))
        sel_score = torch.amax(enc_cls, dim=-1)
        sel_score = torch.where(feats_mask, sel_score,
                                torch.full_like(sel_score, float('-inf')))
        topk_idx = topk_stable(sel_score, min(self.num_queries,
                                              feats.shape[1]))
        pred_bboxes = head.bbox_pred_to_bbox(xyz, head.reg_branches[0](feats))
        rows = topk_idx[..., None]
        return (torch.take_along_dim(feats, rows, dim=1),
                torch.take_along_dim(xyz, rows, dim=1),
                torch.take_along_dim(pred_bboxes, rows, dim=1).detach(),
                torch.gather(feats_mask, 1, topk_idx))

    def forward_transformer(self, feats, xyz, feats_mask, text_feats,
                            text_mask, train: bool = False):
        query, query_coords, pred_bboxes, query_mask = self.pre_decoder(
            feats, xyz, feats_mask, text_feats, text_mask)
        hidden, all_boxes = self.decoder(
            query, feats, ~feats_mask, query_coords, xyz, pred_bboxes,
            text_feats, ~text_mask,
            reg_branch_fn=self.bbox_head.reg_branches[0],
            bbox_coder_fn=self.bbox_head.bbox_pred_to_bbox,
            feats_mask=feats_mask, query_mask=query_mask, train=train)
        return hidden, all_boxes, query_mask

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Predict: {'bboxes_3d' (B,Q,9), 'scores_3d' (B,Q),
        'query_mask' (B,Q)}, float32, computed with the precision of
        `device.full_float32` whatever the caller's settings."""
        with full_float32():
            text_mask = batch['text_mask']
            text_feats = self.encode_text(batch['input_ids'], text_mask)
            feats, _, xyz, feats_mask = self.extract_feat(batch, text_feats)
            hidden, all_boxes, query_mask = self.forward_transformer(
                feats, xyz, feats_mask, text_feats, text_mask)
            boxes, scores = self.bbox_head.predict(
                hidden, all_boxes, text_feats, text_mask, query_mask)
        return {'bboxes_3d': boxes, 'scores_3d': scores,
                'query_mask': query_mask}

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Train-mode losses with the graph for their gradients: the
        final layer's 'loss_cls' / 'loss_bbox' and 'd{i}.*' of the other
        decoder layers. Batch statistics update the running ones in
        place; dropout and DropPath draw from `generator`. The frozen
        text tower runs without a graph (its output's `stop_gradient`,
        reference detector.py:156); the 2D ResNet's BatchNorm stays in
        eval mode (reference models/resnet.py:8-9). TF32 and bfloat16
        reduced-precision sums are off inside; wrap the backward in
        `device.full_float32()` too (as `engine.train.make_train_step`
        does)."""
        with full_float32():
            text_mask = batch['text_mask']
            with torch.no_grad():
                text = self.text_encoder(batch['input_ids'], text_mask)
            text_feats = self.text_feat_map(text)
            feats, _, xyz, feats_mask = self.extract_feat(
                batch, text_feats, train=True, generator=generator)
            hidden, all_boxes, query_mask = self.forward_transformer(
                feats, xyz, feats_mask, text_feats, text_mask, train=True)
            return self.bbox_head.loss(
                hidden, all_boxes, text_feats, text_mask,
                batch['gt_bboxes'], batch['gt_masks'],
                batch['positive_maps'], query_mask)


class SparseFeatureFusion3DGrounder(SparseFeatureFusion3DGrounderPreshape):
    """The baseline grounder (reference sparse_featfusion_grounder.py:
    31-767): the flagship without the preshape module. The preshape's
    keywords are accepted and unused."""

    use_preshape = False


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy/array batch → tensors on `device` (bools stay bool, ints
    become int32 like the JAX package's batches)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        a = np.asarray(v)
        if a.dtype.kind in 'iu':
            a = a.astype(np.int32)
        elif a.dtype.kind == 'f':
            a = a.astype(np.float32)
        out[k] = torch.tensor(a, device=device)
    return out
