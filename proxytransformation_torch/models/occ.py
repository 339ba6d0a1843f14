"""Occupancy prediction: ImVoxelNet-style dense volumes from multi-view
images (and points), a 3D conv neck and a per-scale occupancy head.

Counterpart of proxytransformation_tpu/models/occ.py (reference
embodied_occ.py:25-455, dense_fusion_occ.py:26-467,
imvoxel_occ_head.py:19-184, imvoxel_neck.py:8-143, occ_loss.py:7-141):

    imgs (B,V,H,W,3) ──ResNet, stage 1──► feat_proj ──┐
    voxel centres (X,Y,Z) ──project, bilinear sample, mean over views──►
    volume (B,C,X,Y,Z) [+ points ──point_proj──► dense scatter (mean)]
        ──IndoorImVoxelNeck──► 3 scales ──ImVoxelOccHead──► logits
        ──► predict (argmax) / loss (CE + semantic and geometric
            scene-class affinity, 0.5^i a scale)

The JAX package keeps volumes NXYZC with the flat index (x·Y + y)·Z + z;
here the convolutions run on (B, C, X, Y, Z) through `nn.Conv3d` (its
weight is flax's (kx, ky, kz, C_in, C_out) kernel transposed to (C_out,
C_in, kx, ky, kz)) and the head's logits are handed to the loss as
(B, X, Y, Z, C). The neck's BatchNorms are flax's (`BatchNormParams.flax`:
momentum 0.99, variance E[x²] - E[x]²); the 2D ResNet's stays in eval
mode, as in the JAX package. `forward` and `loss` run with TF32 off
(`device.full_float32`): cuDNN's 3D convolutions take TF32 by default.

Batch dict (tensors on the model's device): imgs, proj_mats (B,V,4,4),
views_mask and, for `DenseFusionOccPredictor`, points (B,N,3) and
points_mask; for the loss also gt_occupancy (B,G,4) [x, y, z, label] and
gt_occupancy_masks (B,G).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import full_float32, resolve_device
from ..ops.voxelize import dynamic_scatter_3d
from .det_losses import _max, geo_scal_loss, sem_scal_loss
from .norms import BatchNormParams
from .point_fusion import batch_point_sample
from .resnet import ResNet

IGNORE = 255


def occ_multiscale_supervision(gt_occ: torch.Tensor, gt_mask: torch.Tensor,
                               ratio: int, grid_shape: Tuple[int, int, int],
                               vis_mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Sparse (G, 4) [x, y, z, label] gt of one sample → dense (X, Y, Z)
    int64 labels at 1/ratio resolution: each cell takes the largest label
    that falls in it (0 = empty; 255 outside `vis_mask`)."""
    X, Y, Z = grid_shape
    coords = torch.div(gt_occ[:, :3].to(torch.int32), ratio,
                       rounding_mode='floor').long()
    labels = gt_occ[:, 3].to(torch.int32).long()
    hi = torch.tensor([X, Y, Z], device=gt_occ.device)
    ok = gt_mask & torch.all((coords >= 0) & (coords < hi), dim=-1)
    flat = (coords[:, 0] * Y + coords[:, 1]) * Z + coords[:, 2]
    flat = torch.where(ok, flat, torch.full_like(flat, X * Y * Z))
    dense = torch.zeros(X * Y * Z + 1, dtype=torch.long, device=gt_occ.device)
    dense.scatter_reduce_(0, flat, labels, 'amax')
    dense = dense[:-1].reshape(X, Y, Z)
    if vis_mask is not None:
        dense = torch.where(vis_mask, dense, torch.full_like(dense, IGNORE))
    return dense


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest upsampling of (B, C, X, Y, Z) to twice each extent:
    `jax.image.resize(..., 'nearest')` at exactly 2x reads source i // 2."""
    for dim in (2, 3, 4):
        x = x.repeat_interleave(2, dim=dim)
    return x


class _Conv3dBlock(nn.Module):
    """3x3x3 conv (no bias), flax BatchNorm, ReLU."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, channels, 3, stride=stride,
                              padding=1, bias=False)
        self.norm = BatchNormParams(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv(x).permute(0, 2, 3, 4, 1)
        return torch.relu(self.norm.flax(y, train)).permute(0, 4, 1, 2, 3)


class IndoorImVoxelNeck(nn.Module):
    """3D encoder-decoder over the dense volume: `n_scales` down stages
    (`down_i` strided but the first, then `down_ib`), then from the
    coarsest up: the coarser level upsampled, through the 1x1x1 `lat_i`,
    added, and `out_i` to `out_channels`. Outputs fine → coarse."""

    def __init__(self, in_channels: int, out_channels: int = 128,
                 n_scales: int = 3):
        super().__init__()
        self.n_scales = n_scales
        cin = in_channels
        for i in range(n_scales):
            c = out_channels * 2 ** i
            self.add_module(f'down_{i}', _Conv3dBlock(cin, c,
                                                      1 if i == 0 else 2))
            self.add_module(f'down_{i}b', _Conv3dBlock(c, c))
            self.add_module(f'out_{i}', _Conv3dBlock(c, out_channels))
            if i < n_scales - 1:
                self.add_module(f'lat_{i}', nn.Conv3d(2 * c, c, 1))
            cin = c

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> List[torch.Tensor]:
        downs = []
        h = x
        for i in range(self.n_scales):
            h = getattr(self, f'down_{i}')(h, train)
            h = getattr(self, f'down_{i}b')(h, train)
            downs.append(h)
        outs = []
        up = None
        for i in range(self.n_scales - 1, -1, -1):
            h = downs[i]
            if up is not None:
                h = h + getattr(self, f'lat_{i}')(upsample2x(up))
            outs.append(getattr(self, f'out_{i}')(h, train))
            up = h
        return outs[::-1]


class ImVoxelOccHead(nn.Module):
    """A 1x1x1 conv a scale (`occ_i`, no bias) to `num_classes` logits, or
    to one occupancy logit when `use_semantic` is off."""

    def __init__(self, in_channels: int, num_classes: int = 81,
                 use_semantic: bool = True, n_scales: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.use_semantic = use_semantic
        out = num_classes if use_semantic else 1
        for i in range(n_scales):
            self.add_module(f'occ_{i}', nn.Conv3d(in_channels, out, 1,
                                                  bias=False))
        self.n_scales = n_scales

    def forward(self, mlvl_feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """(B, C, X, Y, Z) a scale → (B, X, Y, Z, classes) logits."""
        return [getattr(self, f'occ_{i}')(f).permute(0, 2, 3, 4, 1)
                for i, f in enumerate(mlvl_feats)]

    def _sample_loss(self, p: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        valid = gt != IGNORE
        v = valid.to(p.dtype)
        n_valid = _max(torch.sum(v), 1.0)
        if self.use_semantic:
            logp = torch.log_softmax(p, -1)
            safe = torch.clamp(gt, 0, self.num_classes - 1)
            ce = -torch.take_along_dim(logp, safe[..., None], -1)[..., 0]
            ce = torch.sum(ce * v) / n_valid
            return ce + sem_scal_loss(p, gt, valid) + geo_scal_loss(
                p, gt, 0, valid)
        x = p[..., 0]
        occ = (gt > 0).to(p.dtype)
        # |x| with jnp.abs's gradient of 1 at 0
        bce = (_max(x, 0.0) - x * occ
               + torch.log1p(torch.exp(-torch.where(x >= 0, x, -x))))
        return torch.sum(bce * v) / n_valid

    def loss(self, occ_preds: List[torch.Tensor], gt_occ: torch.Tensor,
             gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{'loss_occ_i'}: the batch mean of each sample's loss against its
        gt at ratio 2^i, times 0.5^i."""
        losses = {}
        for i, pred in enumerate(occ_preds):
            grid = tuple(pred.shape[1:4])
            per = [self._sample_loss(
                pred[b], occ_multiscale_supervision(gt_occ[b], gt_mask[b],
                                                    2 ** i, grid))
                for b in range(pred.shape[0])]
            losses[f'loss_occ_{i}'] = torch.mean(torch.stack(per)) * (0.5 ** i)
        return losses

    def predict(self, occ_preds: List[torch.Tensor]) -> torch.Tensor:
        """The finest scale: argmax labels (B, X, Y, Z) int64, or the
        occupancy probability without semantics."""
        pred = occ_preds[0]
        if self.use_semantic:
            return torch.argmax(pred, -1)
        return torch.sigmoid(pred[..., 0])


def voxel_centers(n_voxels: Sequence[int], voxel_range: Sequence[float],
                  device=None) -> torch.Tensor:
    """(X, Y, Z, 3) float32 centres lo + (i + 0.5) · voxel, the voxel the
    true float32 quotient (hi - lo) / [X, Y, Z], as XLA folds it."""
    X, Y, Z = n_voxels
    r = np.asarray(voxel_range, np.float32)
    vx = torch.from_numpy((r[3:] - r[:3]) / np.asarray([X, Y, Z], np.float32))
    idx = torch.stack(torch.meshgrid(torch.arange(X), torch.arange(Y),
                                     torch.arange(Z), indexing='ij'), -1)
    centers = torch.from_numpy(r[:3]) + (idx.float() + 0.5) * vx
    return centers.to(device)


class EmbodiedOccPredictor(nn.Module):
    """ImVoxelNet-style occupancy predictor; defaults are the JAX model's
    (the occupancy config sets 81 classes, neck 128). `device=None`
    builds it on the card and raises when there is none; pass
    `device='cpu'` for the CPU. `img_depth` is any of the 2D ResNet's
    (18, 34, 50, 101): `feat_proj` reads its first stage's width."""

    fuse_points = False

    def __init__(self, n_voxels: Sequence[int] = (40, 40, 16),
                 voxel_range: Sequence[float] = (-3.2, -3.2, -0.78,
                                                 3.2, 3.2, 1.78),
                 num_classes: int = 81, img_base_channels: int = 16,
                 img_depth: int = 50, neck_channels: int = 64,
                 use_semantic: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.n_voxels = tuple(int(n) for n in n_voxels)
        self.voxel_range = tuple(float(v) for v in voxel_range)
        self.num_classes = num_classes
        with torch.device(resolve_device(device)):
            self.backbone = ResNet(img_depth, img_base_channels)
            self.feat_proj = nn.Linear(self.backbone.out_channels[0],
                                       neck_channels)
            self.neck_3d = IndoorImVoxelNeck(neck_channels, neck_channels)
            self.bbox_head = ImVoxelOccHead(neck_channels, num_classes,
                                            use_semantic)
            if self.fuse_points:
                self.point_proj = nn.Linear(3, neck_channels)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.feat_proj.weight.device

    def extract_feat(self, batch: Dict[str, Any], train: bool = False
                     ) -> List[torch.Tensor]:
        """The neck's three (B, C, X', Y', Z') scales."""
        imgs = batch['imgs']
        B, V, H, W, _ = imgs.shape
        feats = self.feat_proj(self.backbone(imgs.reshape(B * V, H, W, 3),
                                             n_stages=1)[0])
        feats = feats.reshape((B, V) + feats.shape[1:])
        X, Y, Z = self.n_voxels
        pts = voxel_centers(self.n_voxels, self.voxel_range,
                            imgs.device).reshape(1, -1, 3)
        vol = batch_point_sample(feats, pts.expand(B, -1, -1),
                                 batch['proj_mats'], (H, W),
                                 views_mask=batch['views_mask'], aligned=True)
        vol = vol.reshape(B, X, Y, Z, -1)
        if self.fuse_points:
            points = batch['points']
            pfeats = self.point_proj(points)
            vol = vol + torch.stack([
                dynamic_scatter_3d(points[b], pfeats[b],
                                   batch['points_mask'][b], self.voxel_range,
                                   self.n_voxels)[0] for b in range(B)])
        return self.neck_3d(vol.permute(0, 4, 1, 2, 3), train)

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Predict: {'occupancy': (B, X, Y, Z)} labels (or probabilities),
        eval mode, TF32 off."""
        with full_float32():
            preds = self.bbox_head(self.extract_feat(batch, False))
            return {'occupancy': self.bbox_head.predict(preds)}

    def logits(self, batch: Dict[str, Any], train: bool = False
               ) -> List[torch.Tensor]:
        """The head's (B, X', Y', Z', classes) logits at every scale."""
        with full_float32():
            return self.bbox_head(self.extract_feat(batch, train))

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Train-mode 'loss_occ_{0,1,2}' with the graph for their
        gradients; the neck's batch statistics update its running ones in
        place. The model draws nothing at random (`generator` goes
        unused). TF32 is off inside."""
        with full_float32():
            return self.bbox_head.loss(self.logits(batch, True),
                                       batch['gt_occupancy'],
                                       batch['gt_occupancy_masks'])


class DenseFusionOccPredictor(EmbodiedOccPredictor):
    """The point-fused variant: each sample's xyz points, through
    `point_proj`, are mean-scattered into the volume and added."""

    fuse_points = True
