"""Host-side data pipeline transforms (numpy).

The port's own copy of proxytransformation_tpu/data/transforms.py (the
reference's datasets/transforms/ — multiview.py, points.py, loading.py,
augmentation.py, formatting.py), on plain numpy dicts; the device never
sees ragged data (the preprocessor pads downstream). Files are read by
`image_io.imread` and views resized by `resize.resize_bilinear_u8`, both
byte-equal with the cv2 calls the JAX package makes; the point kernels
are `native.py`'s, which follow the JAX package's native library.

The random draws use numpy's global generator (`np.random.choice`,
`uniform`, `normal`, `rand`) in the JAX package's order and calls: parity
of the draws, so that the same `np.random.seed` picks the same views,
points and augmentations in both packages.

Train pipeline parity (configs/...clip.py:105-125): LoadAnnotations3D →
MultiViewPipeline(20 views: LoadImageFromFile → LoadDepthFromFile →
ConvertRGBDToPoints → PointSample(10k) → Resize 480²) →
AggregateMultiViewPoints → PointSample(100k) → GlobalRotScaleTrans →
Pack3DDetInputs.
"""
from __future__ import annotations

import copy
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..structures.boxes import box_flip, box_transform
from ..structures.projection import points_cam2img
from ..utils.registry import TRANSFORMS
from . import image_io
from .native import (depth_to_points, fps_sample, invert_4x4,
                     transform_points_inplace)
from .resize import resize_bilinear_u8


class Compose:

    def __init__(self, transforms: Sequence):
        self.transforms = [
            TRANSFORMS.build(t) if isinstance(t, dict) else t
            for t in transforms
        ]

    def __call__(self, results: dict) -> dict:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


@TRANSFORMS.register_module()
class LoadAnnotations3D:
    """Pull ann_info into top-level keys (reference loading.py:160-593)."""

    def __call__(self, results: dict) -> dict:
        ann = results.get('ann_info', {})
        results['gt_bboxes_3d'] = np.asarray(
            ann.get('gt_bboxes_3d', np.zeros((0, 9))), np.float32)
        results['gt_labels_3d'] = np.asarray(
            ann.get('gt_labels_3d', np.zeros((0, ))), np.int64)
        return results


@TRANSFORMS.register_module()
class LoadImageFromFile:
    """Load one RGB image (BGR order like mmcv, for preprocessor parity)."""

    def __init__(self, backend_args=None, to_float32: bool = False):
        self.to_float32 = to_float32

    def __call__(self, results: dict) -> dict:
        img = image_io.imread(results['img_path'])  # BGR HWC uint8
        if self.to_float32:
            img = img.astype(np.float32)
        results['img'] = img
        results['img_shape'] = img.shape[:2]
        results['ori_shape'] = img.shape[:2]
        return results


@TRANSFORMS.register_module()
class LoadDepthFromFile:
    """Load a 16-bit depth map and scale by depth_shift
    (reference loading.py:76-156)."""

    def __init__(self, backend_args=None):
        pass

    def __call__(self, results: dict) -> dict:
        depth = image_io.imread(results['depth_img_path'],
                                image_io.IMREAD_UNCHANGED)
        # keep uint16 raw; ConvertRGBDToPoints divides by depth_shift
        # (native fast path) — float fallback for other sources
        if depth.dtype != np.uint16:
            depth = depth.astype(np.float32) / results.get('depth_shift',
                                                           1000.0)
        results['depth_img'] = depth
        return results


@TRANSFORMS.register_module()
class ConvertRGBDToPoints:
    """Back-project a depth map to camera-frame points
    (reference points.py:19-96)."""

    def __init__(self, coord_type: str = 'CAMERA', use_color: bool = False):
        self.use_color = use_color

    def __call__(self, results: dict) -> dict:
        depth = results['depth_img']
        k = np.asarray(results['depth_cam2img'], np.float32)
        # LoadDepthFromFile already divided by depth_shift; the native
        # kernel wants the raw uint16, so rescale when possible
        if depth.dtype == np.uint16:
            pts = depth_to_points(depth, k,
                                  results.get('depth_shift', 1000.0))
        else:
            h, w = depth.shape[:2]
            us, vs = np.meshgrid(np.arange(w), np.arange(h))
            d = depth.reshape(-1)
            nz = d > 0
            u = us.reshape(-1)[nz].astype(np.float32)
            v = vs.reshape(-1)[nz].astype(np.float32)
            d = d[nz]
            fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
            pts = np.stack([(u - cx) * d / fx, (v - cy) * d / fy, d], -1)
        if self.use_color:
            img = results['img']
            uv = points_cam2img(torch.from_numpy(np.asarray(pts, np.float32)),
                                torch.from_numpy(k)).numpy()
            ui = np.clip(np.round(uv[:, 0]).astype(np.int64), 0,
                         img.shape[1] - 1)
            vi = np.clip(np.round(uv[:, 1]).astype(np.int64), 0,
                         img.shape[0] - 1)
            pts = np.concatenate([pts, img[vi, ui].astype(np.float32)], -1)
        results['points'] = pts
        return results


@TRANSFORMS.register_module()
class PointSample:
    """Random subsample to num_points (with replacement when short;
    reference points.py:289-428)."""

    def __init__(self, num_points: int, replace: Optional[bool] = None):
        self.num_points = num_points
        self.replace = replace

    def __call__(self, results: dict) -> dict:
        pts = results['points']
        n = len(pts)
        replace = self.replace
        if replace is None:
            replace = n < self.num_points
        if n == 0:
            results['points'] = np.zeros((self.num_points, pts.shape[-1]
                                          if pts.ndim == 2 else 3),
                                         np.float32)
            return results
        idx = np.random.choice(n, self.num_points, replace=replace)
        results['points'] = pts[idx]
        return results


@TRANSFORMS.register_module()
class FPSPointSample:
    """Farthest-point subsample (reference points.py:98-287, the
    torch_cluster CUDA path replaced by numpy)."""

    def __init__(self, num_points: int):
        self.num_points = num_points

    def __call__(self, results: dict) -> dict:
        pts = results['points']
        n = len(pts)
        if n <= self.num_points:
            return PointSample(self.num_points)(results)
        sel = fps_sample(pts, self.num_points)
        results['points'] = pts[sel]
        return results


@TRANSFORMS.register_module()
class Resize:
    """Resize the image (and scale intrinsics via scale_factor)."""

    def __init__(self, scale: Tuple[int, int], keep_ratio: bool = False):
        self.scale = scale  # (w, h)
        self.keep_ratio = keep_ratio

    def __call__(self, results: dict) -> dict:
        img = results['img']
        h, w = img.shape[:2]
        new_w, new_h = self.scale
        results['img'] = resize_bilinear_u8(img, (new_w, new_h))
        results['img_shape'] = (new_h, new_w)
        results['scale_factor'] = np.array([new_w / w, new_h / h],
                                           np.float32)
        return results


@TRANSFORMS.register_module()
class MultiViewPipeline:
    """Select frames, run the per-view sub-pipeline, concatenate
    (reference multiview.py:92-191)."""

    def __init__(self, transforms, n_images: int, ordered: bool = False):
        self.transforms = Compose(transforms)
        self.n_images = n_images
        self.ordered = ordered

    def __call__(self, results: dict) -> dict:
        n_avail = len(results['img_path'])
        ids = np.arange(n_avail)
        replace = self.n_images > n_avail
        if self.ordered:
            step = (n_avail - 1) // max(self.n_images - 1, 1)
            if step > 0:
                ids = ids[::step][:self.n_images]
            else:
                ids = np.random.choice(ids, self.n_images, replace=replace)
        else:
            ids = np.random.choice(ids, self.n_images, replace=replace)

        imgs, points, intr, extr = [], [], [], []
        last = {}
        for i in ids.tolist():
            r = {
                'img_path': results['img_path'][i],
                'depth_img_path': results['depth_img_path'][i],
                'depth_shift': results.get('depth_shift', 1000.0),
            }
            d2i = results['depth2img']
            if isinstance(results.get('depth_cam2img'), list):
                r['depth_cam2img'] = np.array(results['depth_cam2img'][i])
                r['cam2img'] = np.array(d2i['intrinsic'][i])
            else:
                r['depth_cam2img'] = np.array(results['depth_cam2img'])
                r['cam2img'] = np.array(results['cam2img'])
            r = self.transforms(r)
            last = r
            if 'img' in r:
                imgs.append(r['img'])
            if 'points' in r:
                points.append(r['points'])
            intr.append(np.array(d2i['intrinsic'][i] if isinstance(
                d2i['intrinsic'], list) else d2i['intrinsic']))
            extr.append(np.array(d2i['extrinsic'][i]))
        for k, v in last.items():
            if k not in ('img', 'points', 'img_path'):
                results[k] = v
        if imgs:
            results['img'] = imgs
        if points:
            results['points_per_view'] = points
        results['depth2img'] = dict(intrinsic=intr, extrinsic=extr)
        return results


@TRANSFORMS.register_module()
class AggregateMultiViewPoints:
    """Ego→global via solving extrinsic systems, then concat
    (reference multiview.py:194-251)."""

    def __init__(self, coord_type: str = 'DEPTH', save_slices: bool = False):
        self.save_slices = save_slices

    def __call__(self, results: dict) -> dict:
        pts_views = results.pop('points_per_view')
        extr = results['depth2img']['extrinsic']
        out = []
        slices = [0]
        for pts, e in zip(pts_views, extr):
            p = np.ascontiguousarray(pts, np.float32)
            transform_points_inplace(p, invert_4x4(np.asarray(e)))
            out.append(p)
            slices.append(slices[-1] + len(p))
        results['points'] = np.concatenate(out, 0) if out else \
            np.zeros((0, 3), np.float32)
        if self.save_slices:
            results['points_slice_indices'] = slices
        return results


@TRANSFORMS.register_module()
class GlobalRotScaleTrans:
    """Random z-rotation, scaling, translation of points + boxes
    (reference augmentation.py:252-475). Records the aug params so the
    model can replay the inverse for 2D→3D painting."""

    def __init__(self, rot_range=(-0.087266, 0.087266),
                 scale_ratio_range=(0.9, 1.1),
                 translation_std=(0.1, 0.1, 0.1), shift_height=False):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = translation_std

    def __call__(self, results: dict) -> dict:
        angle = np.random.uniform(*self.rot_range)
        c, s = np.cos(angle), np.sin(angle)
        # right-multiplication convention: p_new = p @ R
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        scale = np.random.uniform(*self.scale_ratio_range)
        trans = np.random.normal(scale=self.translation_std,
                                 size=3).astype(np.float32)

        pts = results['points']
        pts = pts.copy()
        pts[:, :3] = (pts[:, :3] @ rot) * scale + trans
        results['points'] = pts

        boxes = results.get('gt_bboxes_3d')
        if boxes is not None and len(boxes):
            # rotate (pure rotation so euler extraction stays valid),
            # then scale, then translate — reference aug order R, S, T
            mat = np.eye(4, dtype=np.float32)
            mat[:3, :3] = rot.T  # left-mult equivalent of p @ rot
            boxes = box_transform(
                torch.from_numpy(np.asarray(boxes, np.float32)),
                torch.from_numpy(mat)).numpy().copy()
            boxes[:, :6] *= scale
            boxes[:, :3] += trans
            results['gt_bboxes_3d'] = boxes
        results['pcd_rotation'] = rot
        results['pcd_rotation_angle'] = angle
        results['pcd_scale_factor'] = scale
        results['pcd_trans'] = trans
        results['transformation_3d_flow'] = ['R', 'S', 'T']
        return results


@TRANSFORMS.register_module()
class RandomFlip3D:
    """Random horizontal flip of points/boxes/images
    (reference augmentation.py:10-250). Unused by the main grounding
    config; kept for detection-path parity."""

    def __init__(self, sync_2d: bool = True, flip_ratio_bev_horizontal=0.0,
                 flip_ratio_bev_vertical=0.0):
        self.ratio_h = flip_ratio_bev_horizontal
        self.ratio_v = flip_ratio_bev_vertical

    def __call__(self, results: dict) -> dict:
        flip_h = np.random.rand() < self.ratio_h
        flip_v = np.random.rand() < self.ratio_v
        pts = results['points'].copy()
        boxes = results.get('gt_bboxes_3d')
        if flip_h:
            pts[:, 0] = -pts[:, 0]
            if boxes is not None and len(boxes):
                boxes = box_flip(torch.from_numpy(np.asarray(
                    boxes, np.float32)), 'X').numpy()
        if flip_v:
            pts[:, 1] = -pts[:, 1]
            if boxes is not None and len(boxes):
                boxes = box_flip(torch.from_numpy(np.asarray(
                    boxes, np.float32)), 'Y').numpy()
        results['points'] = pts
        if boxes is not None:
            results['gt_bboxes_3d'] = boxes
        results['flip_x'] = flip_h
        results['flip_y'] = flip_v
        return results


@TRANSFORMS.register_module()
class PointsRangeFilter:
    """Drop points outside a range (reference points.py:431-489)."""

    def __init__(self, point_cloud_range: Sequence[float]):
        self.range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, results: dict) -> dict:
        pts = results['points']
        m = np.all((pts[:, :3] >= self.range[:3])
                   & (pts[:, :3] <= self.range[3:6]), -1)
        results['points'] = pts[m]
        return results


@TRANSFORMS.register_module()
class Pack3DDetInputs:
    """Final packaging into the sample dict the preprocessor collates
    (reference formatting.py:47-291)."""

    def __init__(self, keys: Sequence[str] = ()):
        self.keys = keys

    def __call__(self, results: dict) -> dict:
        sample = {
            'points': np.asarray(results['points'], np.float32),
            'imgs': np.stack(results['img']).astype(np.float32)
            if isinstance(results.get('img'), list) else results.get('img'),
            'gt_bboxes_3d': results.get('gt_bboxes_3d',
                                        np.zeros((0, 9), np.float32)),
            'gt_labels_3d': results.get('gt_labels_3d',
                                        np.zeros((0, ), np.int64)),
            'text': results.get('text', ''),
            'tokens_positive': results.get('tokens_positive', [[[0, 1]]]),
            'depth2img': results.get('depth2img'),
            'scale_factor': results.get('scale_factor'),
            'pcd_rotation': results.get('pcd_rotation'),
            'pcd_scale_factor': results.get('pcd_scale_factor'),
            'pcd_trans': results.get('pcd_trans'),
            'eval_ann_info': {
                'gt_bboxes_3d': results.get('gt_bboxes_3d',
                                            np.zeros((0, 9), np.float32)),
                'gt_labels_3d': results.get('gt_labels_3d',
                                            np.zeros((0, ), np.int64)),
                'is_hard': results.get('is_hard', False),
                'is_view_dep': results.get('is_view_dep', False),
                'is_unique': results.get('is_unique', False),
            },
        }
        if results.get('gt_occupancy') is not None:
            sample['gt_occupancy'] = np.asarray(results['gt_occupancy'],
                                                np.float32)
            sample['eval_ann_info']['gt_occupancy'] = \
                sample['gt_occupancy']
        return sample


@TRANSFORMS.register_module()
class MultiScaleFlipAug3D:
    """Test-time augmentation wrapper (reference test_time_aug.py:13-119):
    produces one transformed copy of the sample per (scale, flip)
    combination; `aug_test`/`merge_aug_bboxes_3d` fuse the predictions."""

    def __init__(self, transforms, img_scale=None, pts_scale_ratio=1.0,
                 flip=False, flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        self.pts_scale_ratio = (
            [pts_scale_ratio] if isinstance(pts_scale_ratio, (int, float))
            else list(pts_scale_ratio))
        self.flip = flip
        self.flip_directions = ([flip_direction] if isinstance(
            flip_direction, str) else list(flip_direction))

    def __call__(self, results: dict):
        aug_samples = []
        flip_opts = [False, True] if self.flip else [False]
        for scale in self.pts_scale_ratio:
            for do_flip in flip_opts:
                for direction in (self.flip_directions if do_flip
                                  else ['horizontal']):
                    r = copy.deepcopy(results)
                    pts = np.asarray(r['points'], np.float32).copy()
                    meta = {'pcd_scale_factor': scale,
                            'pcd_horizontal_flip': False,
                            'pcd_vertical_flip': False}
                    if scale != 1.0:
                        pts[:, :3] *= scale
                    if do_flip and direction == 'horizontal':
                        pts[:, 0] = -pts[:, 0]
                        meta['pcd_horizontal_flip'] = True
                    if do_flip and direction == 'vertical':
                        pts[:, 1] = -pts[:, 1]
                        meta['pcd_vertical_flip'] = True
                    r['points'] = pts
                    r['aug_meta'] = meta
                    out = self.transforms(r)
                    out['aug_meta'] = meta
                    aug_samples.append(out)
        return aug_samples


@TRANSFORMS.register_module()
class ConstructMultiSweeps:
    """Build 1..N cumulative point sweeps from per-view clouds
    (reference multiview.py:255-328): each sweep concatenates the
    points of views 1..k, for continuous 3D perception."""

    def __call__(self, results: dict) -> dict:
        slices = results.get('points_slice_indices')
        pts = results['points']
        if slices is None:
            results['multi_sweeps'] = [pts]
            return results
        sweeps = [pts[:slices[k]] for k in range(1, len(slices))]
        results['multi_sweeps'] = sweeps
        return results


@TRANSFORMS.register_module()
class PointsToGPU:
    """No-op marker (reference saving.py:10-87 moved points to CUDA in
    the worker; device placement here happens at jit boundaries)."""

    def __call__(self, results: dict) -> dict:
        return results


@TRANSFORMS.register_module()
class LoadPreprocessedData:
    """Load a cached preprocessed sample from disk (reference
    loading.py:17-72's SHM cache, file-backed here)."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir

    def __call__(self, results: dict) -> dict:
        key = results.get('scan_id', '').replace('/', '_')
        path = os.path.join(self.cache_dir, key + '.pkl')
        if os.path.exists(path):
            with open(path, 'rb') as f:
                cached = pickle.load(f)
            results.update(cached)
            results['_cache_hit'] = True
        return results


@TRANSFORMS.register_module()
class SavingPreprocessData:
    """Persist expensive pipeline outputs (reference saving.py:10-87)."""

    def __init__(self, cache_dir: str,
                 keys=('points', 'img', 'depth2img')):
        self.cache_dir = cache_dir
        self.keys = keys
        os.makedirs(cache_dir, exist_ok=True)

    def __call__(self, results: dict) -> dict:
        if results.get('_cache_hit'):
            return results
        key = results.get('scan_id', '').replace('/', '_')
        path = os.path.join(self.cache_dir, key + '.pkl')
        with open(path, 'wb') as f:
            pickle.dump({k: results[k] for k in self.keys if k in results},
                        f)
        return results
