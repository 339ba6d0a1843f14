"""Batch collation and preprocessing → the padded, static-shape batch.

The port's own copy of proxytransformation_tpu/data/preprocessor.py (the
reference `Det3DDataPreprocessor`, models/data_preprocessors/
data_preprocessor.py:23-583): image mean/std normalization with BGR→RGB
and padding to a multiple of 32, the static padding of points (with a
mask), views, text and gt boxes, and the tokenization and positive maps
(reference sparse_featfusion_grounder_preshape.py:641-691), all numpy on
the host. Every key the JAX package emits is emitted here, the detection
`gt_labels` and the occupancy targets included, with `eval_ann_info`
passed through per sample; `models.detector.batch_to_device` moves the
array keys to the device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.text_encoder import build_tokenizer, create_positive_map
from ..utils.registry import MODELS


@MODELS.register_module()
class Det3DDataPreprocessor:

    def __init__(self,
                 mean: Sequence[float] = (123.675, 116.28, 103.53),
                 std: Sequence[float] = (58.395, 57.12, 57.375),
                 bgr_to_rgb: bool = True,
                 pad_size_divisor: int = 32,
                 n_points: int = 100_000,
                 n_views: int = 20,
                 max_text_len: int = 256,
                 max_gts: int = 8,
                 point_channels: int = 3,
                 max_occ: int = 20_000,
                 tokenizer_path: Optional[str] = None):
        if point_channels < 3:
            raise ValueError(
                f'point_channels must be >= 3 (xyz), got {point_channels}')
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.bgr_to_rgb = bgr_to_rgb
        self.pad_size_divisor = pad_size_divisor
        self.n_points = n_points
        self.n_views = n_views
        self.max_text_len = max_text_len
        self.max_gts = max_gts
        self.point_channels = point_channels
        self.max_occ = max_occ
        self.tokenizer = build_tokenizer(tokenizer_path)

    def _norm_img(self, img: np.ndarray) -> np.ndarray:
        img = img.astype(np.float32)
        if self.bgr_to_rgb:
            img = img[..., ::-1]
        img = (img - self.mean) / self.std
        d = self.pad_size_divisor
        h, w = img.shape[-3:-1]
        ph = (-h) % d
        pw = (-w) % d
        if ph or pw:
            pad = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
            img = np.pad(img, pad)
        return img

    def __call__(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        B = len(samples)
        texts = [s.get('text', '') for s in samples]
        tokenized = self.tokenizer(texts)
        L = min(tokenized.input_ids.shape[1], self.max_text_len)
        input_ids = tokenized.input_ids[:, :L]
        text_mask = tokenized.attention_mask[:, :L].astype(bool)

        # images: (B, V, H, W, 3) normalized + view mask
        imgs_list = [s['imgs'] for s in samples]
        V = self.n_views
        h = max(im.shape[-3] for im in imgs_list)
        w = max(im.shape[-2] for im in imgs_list)
        h += (-h) % self.pad_size_divisor
        w += (-w) % self.pad_size_divisor
        imgs = np.zeros((B, V, h, w, 3), np.float32)
        views_mask = np.zeros((B, V), bool)
        proj_mats = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
        for b, s in enumerate(samples):
            im = self._norm_img(s['imgs'])  # (v, h, w, 3)
            v = min(im.shape[0], V)
            imgs[b, :v, :im.shape[1], :im.shape[2]] = im[:v]
            views_mask[b, :v] = True
            d2i = s.get('depth2img') or {}
            intr = d2i.get('intrinsic', [])
            extr = d2i.get('extrinsic', [])
            for vi in range(min(v, len(extr))):
                K = np.eye(4, dtype=np.float32)
                Km = np.asarray(intr[vi], np.float32)
                K[:Km.shape[0], :Km.shape[1]] = Km
                E = np.eye(4, dtype=np.float32)
                Em = np.asarray(extr[vi], np.float32)
                E[:Em.shape[0], :Em.shape[1]] = Em
                proj_mats[b, vi] = K @ E
            sf = s.get('scale_factor')
            if sf is not None:
                # fold the image resize into the projection
                S = np.diag([sf[0], sf[1], 1.0, 1.0]).astype(np.float32)
                proj_mats[b, :v] = S @ proj_mats[b, :v]

        # points: (B, N, C) + mask with C fixed by config (not the
        # per-batch max, which would change array shapes between batches
        # — one jit recompile per shape and a mid-training failure for
        # 3-channel batches under use_xyz_feat=False). Extra channels
        # beyond xyz (color, etc.) are carried through so
        # `use_xyz_feat=False` models can voxelize them as features;
        # channels beyond `point_channels` are truncated, missing ones
        # zero-padded.
        C = self.point_channels
        points = np.zeros((B, self.n_points, C), np.float32)
        points_mask = np.zeros((B, self.n_points), bool)
        for b, s in enumerate(samples):
            p = np.asarray(s['points'], np.float32)
            n = min(len(p), self.n_points)
            c = min(p.shape[-1], C)
            points[b, :n, :c] = p[:n, :c]
            points_mask[b, :n] = True

        # gts
        G = self.max_gts
        gt_bboxes = np.zeros((B, G, 9), np.float32)
        gt_masks = np.zeros((B, G), bool)
        positive_maps = np.zeros((B, G, self.max_text_len), np.float32)
        for b, s in enumerate(samples):
            boxes = np.asarray(s.get('gt_bboxes_3d',
                                     np.zeros((0, 9))), np.float32)
            if len(boxes) > G:
                import warnings
                warnings.warn(
                    f'sample has {len(boxes)} gt boxes > max_gts={G}; '
                    'truncating — raise max_gts in the preprocessor '
                    'config to keep all targets', stacklevel=2)
            g = min(len(boxes), G)
            gt_bboxes[b, :g] = boxes[:g]
            gt_masks[b, :g] = True
            tp = s.get('tokens_positive', [[[0, 1]]] * g)
            pm = create_positive_map(tokenized, tp, b, self.max_text_len)
            pm = (pm > 0).astype(np.float32)  # bool().float() as reference
            positive_maps[b, :min(g, len(pm))] = pm[:g]

        batch = {
            'imgs': imgs,
            'points': points,
            'points_mask': points_mask,
            'input_ids': input_ids.astype(np.int32),
            'text_mask': text_mask,
            'proj_mats': proj_mats,
            'views_mask': views_mask,
            'gt_bboxes': gt_bboxes,
            'gt_masks': gt_masks,
            'positive_maps': positive_maps,
        }
        # inverse-aug params for painting (identity when absent)
        rot = np.stack([
            np.asarray(s.get('pcd_rotation') if s.get('pcd_rotation')
                       is not None else np.eye(3), np.float32)
            for s in samples
        ])
        scale = np.asarray([
            s.get('pcd_scale_factor') or 1.0 for s in samples
        ], np.float32)
        trans = np.stack([
            np.asarray(s.get('pcd_trans') if s.get('pcd_trans') is not None
                       else np.zeros(3), np.float32) for s in samples
        ])
        batch['pcd_rotation'] = rot
        batch['pcd_scale_factor'] = scale[:, None]
        batch['pcd_trans'] = trans

        # detection per-gt class ids (Embodied3DDetector loss target)
        if any(s.get('gt_labels_3d') is not None
               and len(np.atleast_1d(s['gt_labels_3d'])) for s in samples):
            gt_labels = np.zeros((B, G), np.int32)
            for b, s in enumerate(samples):
                lab = np.atleast_1d(np.asarray(s.get('gt_labels_3d', []),
                                               np.int64))
                g = min(len(lab), G)
                gt_labels[b, :g] = lab[:g]
            batch['gt_labels'] = gt_labels

        # occupancy sparse targets (EmbodiedOccPredictor loss target):
        # (B, max_occ, 4) [x, y, z, label] + validity mask
        if any(s.get('gt_occupancy') is not None for s in samples):
            O = self.max_occ
            occ = np.zeros((B, O, 4), np.float32)
            occ_mask = np.zeros((B, O), bool)
            for b, s in enumerate(samples):
                g = np.asarray(s.get('gt_occupancy',
                                     np.zeros((0, 4))),
                               np.float32).reshape(-1, 4)
                n = min(len(g), O)
                occ[b, :n] = g[:n]
                occ_mask[b, :n] = True
            batch['gt_occupancy'] = occ
            batch['gt_occupancy_masks'] = occ_mask

        batch['eval_ann_info'] = [s.get('eval_ann_info') for s in samples]
        return batch
