"""Dataset explorer.

Counterpart of proxytransformation_tpu/explorer.py (reference:
explorer.py:17-501): list scenes, inspect annotations, count categories,
and render scenes, views and occupancy through the port's visualizers on
an explicit device (`None`: the card). Images are read by the port's
`data/image_io.py::imread`, which decodes as cv2 does.
"""
from __future__ import annotations

import os
import pickle
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from .data.categories import EMBODIEDSCAN_CLASSES
from .data.image_io import IMREAD_COLOR, IMREAD_UNCHANGED, imread
from .visualization.base_visualizer import EmbodiedScanBaseVisualizer
from .visualization.continuous_drawer import (ContinuousDrawer,
                                              ContinuousOccupancyDrawer)
from .visualization.img_drawer import ImgDrawer
from .visualization.utils import Device


class EmbodiedScanExplorer:

    def __init__(self, data_root: str = '', ann_files: Sequence[str] = (),
                 verbose: bool = False, save_dir: str = './viz',
                 device: Device = None):
        self.data_root = data_root
        self.verbose = verbose
        self.classes = list(EMBODIEDSCAN_CLASSES)
        self.visualizer = EmbodiedScanBaseVisualizer(self.classes, save_dir,
                                                     device)
        self.device = self.visualizer.device
        self.data: List[dict] = []
        for path in ann_files:
            with open(path, 'rb') as f:
                ann = pickle.load(f)
            self.data.extend(ann.get('data_list', []))
        # the categories of the last file read, as in the JAX explorer
        if 'categories' in (ann.get('metainfo', {}) if ann_files else {}):
            self.cat2label = ann['metainfo']['categories']
        else:
            self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.label2cat = {v: k for k, v in self.cat2label.items()}

    # ------------------------------------------------------------------
    def list_scenes(self) -> List[str]:
        return [d.get('sample_idx', str(i)) for i, d in enumerate(self.data)]

    def count_scenes(self) -> int:
        return len(self.data)

    def scene_info(self, scene_id: str) -> Optional[dict]:
        for d in self.data:
            if d.get('sample_idx') == scene_id:
                n_imgs = len(d.get('images', []))
                n_inst = len(d.get('instances', []))
                cats = Counter(
                    self.label2cat.get(i.get('bbox_label_3d'), '?')
                    for i in d.get('instances', []))
                return {'scan_id': scene_id, 'num_images': n_imgs,
                        'num_instances': n_inst, 'categories': dict(cats)}
        return None

    def category_statistics(self) -> Dict[str, int]:
        counts: Counter = Counter()
        for d in self.data:
            for inst in d.get('instances', []):
                counts[self.label2cat.get(inst.get('bbox_label_3d'),
                                          '?')] += 1
        return dict(counts.most_common())

    # ------------------------------------------------------------------
    def render_scene(self, scene_id: str, points: np.ndarray,
                     show: bool = False) -> Optional[str]:
        """Render a scene's points + annotated boxes."""
        for d in self.data:
            if d.get('sample_idx') == scene_id:
                boxes = np.asarray([
                    inst['bbox_3d'] for inst in d.get('instances', [])
                ], np.float32).reshape(-1, 9)
                labels = np.asarray([
                    inst.get('bbox_label_3d', 0)
                    for inst in d.get('instances', [])
                ], np.int64)
                return self.visualizer.visualize_scene(
                    points, boxes, labels, name=scene_id.replace('/', '_'),
                    show=show)
        return None

    def render_occupancy(self, occ: np.ndarray, name: str = 'occ'):
        """Render a dense (X, Y, Z) occupancy grid as colored voxels."""
        idx = np.stack(np.nonzero(occ > 0), -1).astype(np.float32)
        if len(idx) == 0:
            return None
        labels = occ[occ > 0].reshape(-1)
        colors = np.stack([
            np.asarray(self.visualizer.colors[int(l)]) * 255 for l in labels
        ])
        pts = np.concatenate([idx, colors], -1)
        return self.visualizer.visualize_scene(pts, name=name)

    # ------------------------------------------------------------------
    # listing helpers (reference explorer.py:133-203)
    def list_categories(self) -> List[Dict]:
        """All categories with their label ids, sorted by id."""
        return [{'category': k, 'id': v}
                for k, v in sorted(self.cat2label.items(),
                                   key=lambda kv: kv[1])]

    def _find(self, scene_id: str) -> Optional[dict]:
        for d in self.data:
            if d.get('sample_idx') == scene_id:
                return d
        return None

    def list_cameras(self, scene_id: str) -> Optional[List[str]]:
        """Camera/frame names of one scene (from its image paths)."""
        d = self._find(scene_id)
        if d is None:
            return None
        return [os.path.splitext(os.path.basename(
            im.get('img_path', str(i))))[0]
            for i, im in enumerate(d.get('images', []))]

    def list_instances(self, scene_id: str) -> Optional[List[Dict]]:
        """Per-instance 9-DoF box + category of one scene."""
        d = self._find(scene_id)
        if d is None:
            return None
        return [{
            'bbox_3d': np.asarray(inst['bbox_3d'], np.float32),
            'name': self.label2cat.get(inst.get('bbox_label_3d'), '?'),
        } for inst in d.get('instances', [])]

    # ------------------------------------------------------------------
    # continuous rendering (reference explorer.py:278-384), via the
    # step-through drawers; headless by default
    def render_continuous_scene(self, scene_id: str,
                                depth_reader=None,
                                img_reader=None,
                                start_cam: Optional[str] = None,
                                headless: bool = True):
        """Walk a scene view by view, accumulating the RGB-D cloud.

        `depth_reader(path) -> (H, W) array` / `img_reader(path)` load
        the on-disk frames (by default `imread` unchanged, and in color
        turned to RGB).
        """
        d = self._find(scene_id)
        if d is None:
            return None
        depth_reader = depth_reader or (
            lambda p: imread(p, IMREAD_UNCHANGED))
        img_reader = img_reader or (
            lambda p: imread(p, IMREAD_COLOR)[..., ::-1])
        cams = self.list_cameras(scene_id)
        start = cams.index(start_cam) if start_cam in (cams or []) else 0
        views = []
        cam2img = np.asarray(d.get('cam2img', np.eye(4)), np.float32)
        for im in d.get('images', [])[start:]:
            views.append({
                'depth': depth_reader(im['depth_path']),
                'img': img_reader(im['img_path']),
                'intrinsic': np.asarray(im.get('cam2img', cam2img),
                                        np.float32),
                'cam2global': np.asarray(im['cam2global'], np.float32),
                'visible_instance_ids': im.get('visible_instance_ids', []),
            })
        boxes = np.asarray([i['bbox_3d'] for i in
                            d.get('instances', [])],
                           np.float32).reshape(-1, 9)
        labels = [i.get('bbox_label_3d', 0) for i in d.get('instances', [])]
        drawer = ContinuousDrawer(views, boxes=boxes, labels=labels,
                                  classes=self.classes,
                                  save_dir=self.visualizer.save_dir,
                                  device=self.device)
        if headless:
            return drawer.run_headless(scene_id.replace('/', '_'))
        drawer.run_interactive()
        return drawer

    def render_continuous_occupancy(self, occ_per_view,
                                    voxel_size: float = 0.16,
                                    headless: bool = True):
        """Step through per-view occupancy predictions."""
        views = [{'occupancy': o} for o in occ_per_view]
        drawer = ContinuousOccupancyDrawer(
            views, voxel_size=voxel_size, classes=self.classes,
            save_dir=self.visualizer.save_dir, device=self.device)
        if headless:
            states = []
            while (s := drawer.step()) is not None:
                states.append(s)
            return states
        drawer.run_interactive()
        return drawer

    def show_image(self, scene_id: str, camera_name: str,
                   render_box: bool = False,
                   img_reader=None) -> Optional[np.ndarray]:
        """One view's image (BGR), optionally with projected box
        wireframes (reference explorer.py:442-501)."""
        d = self._find(scene_id)
        if d is None:
            return None
        cams = self.list_cameras(scene_id) or []
        if camera_name not in cams:
            return None
        im = d['images'][cams.index(camera_name)]
        img_reader = img_reader or (lambda p: imread(p, IMREAD_COLOR))
        img = img_reader(im['img_path'])
        if render_box and d.get('instances'):
            axis_align = np.asarray(
                d.get('axis_align_matrix', np.eye(4)), np.float64)
            cam2img = np.eye(4, dtype=np.float64)
            intr = np.asarray(im.get('cam2img', d.get('cam2img')),
                              np.float64)
            cam2img[:intr.shape[0], :intr.shape[1]] = intr
            extrinsic = np.linalg.inv(
                axis_align @ np.asarray(im['cam2global'], np.float64))
            proj = cam2img @ extrinsic
            boxes = np.asarray([i['bbox_3d'] for i in d['instances']],
                               np.float32).reshape(-1, 9)
            labels = np.asarray([i.get('bbox_label_3d', 0)
                                 for i in d['instances']], np.int64)
            img = ImgDrawer(self.classes, self.device).draw_boxes(
                img, boxes, proj.astype(np.float32), labels)
        return img
