"""Multi-view 3D detector: the detection pretraining model.

Counterpart of proxytransformation_tpu/models/embodied_det3d.py::
Embodied3DDetector (the reference's `Embodied3DDetector`): ResNet-50
image features of every view, the voxelized points through MinkResNet,
each backbone level painted with the image features of its stage
(2D→3D, nearest sample), then the FCAF3D head. Training it gives the
checkpoint the grounder warm-starts from (`load_from`).

    imgs (B,V,H,W,3) ──ResNet50──► 4 image levels ──┐
    points (B,N,3)+mask ──voxelize──► MinkResNet ──► 4 sparse levels
        ──painting (per level)◄──────────────────────┘
        ──► FCAF3DHead (sparse FPN, prune) ──► predict / loss

Batch dict (padded, masked tensors on the model's device): imgs, points,
points_mask, proj_mats (B,V,4,4), views_mask and optionally pcd_rotation
/ pcd_scale_factor / pcd_trans; for the loss also gt_bboxes (B,G,9),
gt_labels (B,G) and gt_masks (B,G). As in the JAX package, the painting
undoes the rotation, scale and translation of the augmentation but not
a flip (`pcd_flip_x` / `pcd_flip_y` are not read).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from ..device import full_float32, resolve_device
from ..ops.sparse import voxelize_points
from .fcaf3d_head import FCAF3DHead
from .point_fusion import apply_inverse_aug, batch_point_sample
from .resnet import ResNet, check_img_depth_for_neck
from .sparse_resnet import MinkResNet, check_backbone3d_depth


class Embodied3DDetector(nn.Module):
    """Defaults are the detection config's
    (configs/detection/embodied-det3d-resnet50.py), float32 only.
    `device=None` builds it on the card and raises when there is none;
    pass `device='cpu'` for the plain PyTorch path. `rot_param='ortho6d'`
    gives the head of `FCAF3DHeadRotMat` (12 regression outputs).
    `img_depth` is 50 or 101: the head's widths assume the bottleneck's
    expansion of 4, and depths 18 and 34 raise (the JAX detector fails
    at the head's sum there)."""

    def __init__(self, voxel_size: float = 0.01, n_points: int = 100_000,
                 num_classes: int = 284, img_base_channels: int = 16,
                 img_depth: int = 50, backbone3d_depth: int = 34,
                 sparse_capacities: Sequence[int] = (100_000, 80_000, 50_000,
                                                     20_000, 6_000, 2_000),
                 voxel_extent: Sequence[int] = (1280, 1280, 512),
                 head_out_channels: int = 128,
                 pts_prune_threshold: int = 1000,
                 pts_assign_threshold: int = 27,
                 pts_center_threshold: int = 18, rot_param: str = 'euler',
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        check_backbone3d_depth(backbone3d_depth)
        check_img_depth_for_neck(img_depth, type(self).__name__)
        self.voxel_size = voxel_size
        self.n_points = n_points
        self.voxel_extent = tuple(voxel_extent)
        mink_chans = [64, 128, 256, 512]
        with torch.device(resolve_device(device)):
            self.backbone = ResNet(img_depth, img_base_channels)
            img_chans = self.backbone.out_channels
            self.backbone_3d = MinkResNet(backbone3d_depth, 3,
                                          sparse_capacities)
            self.bbox_head = FCAF3DHead(
                num_classes=num_classes,
                in_channels=tuple(m + i for m, i in zip(mink_chans,
                                                        img_chans)),
                out_channels=head_out_channels,
                pts_prune_threshold=pts_prune_threshold,
                pts_assign_threshold=pts_assign_threshold,
                pts_center_threshold=pts_center_threshold,
                rot_param=rot_param)
        self.eval()

    def extract_feat(self, batch: Dict[str, Any], train: bool = False):
        """The painted backbone levels, their self maps and plans."""
        imgs = batch['imgs']
        B, V, H, W, _ = imgs.shape
        img_feats = [f.reshape((B, V) + f.shape[1:])
                     for f in self.backbone(imgs.reshape(B * V, H, W, 3))]
        points = batch['points']
        if points.shape[-1] != 3:
            raise ValueError('the detector voxelizes xyz points, got '
                             f'{points.shape[-1]} channels')
        lvl0 = voxelize_points(points, batch['points_mask'], points,
                               self.voxel_size, self.n_points,
                               self.voxel_extent)
        levels, self_maps, self_plans = self.backbone_3d(lvl0, train)
        painted = []
        for i, lvl in enumerate(levels):
            inv = apply_inverse_aug(
                lvl.world_xyz(), batch.get('pcd_rotation'),
                batch.get('pcd_scale_factor'), batch.get('pcd_trans'))
            feat2d = batch_point_sample(img_feats[i], inv, batch['proj_mats'],
                                        (H, W), lvl.mask, batch['views_mask'])
            painted.append(lvl._replace(
                feats=torch.cat([lvl.feats, feat2d], dim=-1)))
        return painted, self_maps, self_plans

    def _head_outs(self, batch, train: bool):
        levels, self_maps, self_plans = self.extract_feat(batch, train)
        return self.bbox_head(levels, self_maps=self_maps,
                              self_plans=self_plans, train=train)

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Predict: {'bboxes_3d' (B, LP, 9), 'scores_3d' (B, LP, C),
        'mask' (B, LP)} before NMS, float32, TF32 off."""
        with full_float32():
            boxes, scores, mask = self.bbox_head.predict(
                self._head_outs(batch, False))
        return {'bboxes_3d': boxes, 'scores_3d': scores, 'mask': mask}

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Train-mode 'loss_center', 'loss_bbox' and 'loss_cls' with the
        graph for their gradients; batch statistics update the running
        ones in place (the 2D ResNet's BatchNorm stays in eval mode). The
        detector draws nothing at random: `generator` is the train step's
        and goes unused. TF32 is off inside."""
        with full_float32():
            return self.bbox_head.loss(self._head_outs(batch, True),
                                       batch['gt_bboxes'],
                                       batch['gt_labels'],
                                       batch['gt_masks'])
