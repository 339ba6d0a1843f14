"""EmbodiedScan datasets (grounding + detection), host-side.

The port's own copy of proxytransformation_tpu/data/dataset.py, a
re-implementation of the reference datasets (reference:
datasets/mv_3dvg_dataset.py:21-632, datasets/embodiedscan_dataset.py:
17-410): load `embodiedscan_infos_{split}.pkl`, join with the visual
grounding language json, build per-view extrinsics
`inv(axis_align @ cam2global)` and depth shift (1000, 4000 for
matterport3d), derive hard/unique flags from distractor counts and
view-dependence from the SR3D keyword list.

The SharedArray /dev/shm machinery of the reference (serialization +
rank-0 broadcast, :186-247) is replaced by ordinary in-process storage:
the input pipeline is per host, so nothing is broadcast across processes.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from ..utils.registry import DATASETS
from .categories import EMBODIEDSCAN_CLASSES
from .transforms import Compose

_VIEW_DEP_WORDS = ('front', 'behind', 'back', 'left', 'right', 'facing',
                   'leftmost', 'rightmost', 'looking', 'across')


def is_view_dep(text: str) -> bool:
    """SR3D view-dependence heuristic (reference :303-311)."""
    words = set(text.split())
    return any(rel in words for rel in _VIEW_DEP_WORDS)


def _load_ann_file(path: str):
    if path.endswith('.pkl'):
        with open(path, 'rb') as f:
            return pickle.load(f)
    with open(path) as f:
        return json.load(f)


@DATASETS.register_module()
class MultiView3DGroundingDataset:
    """Scan infos ⨝ language annotations → per-utterance samples."""

    METAINFO = {'classes': EMBODIEDSCAN_CLASSES}

    def __init__(self,
                 data_root: str,
                 ann_file: str,
                 vg_file: str,
                 pipeline: Sequence = (),
                 metainfo: Optional[dict] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 box_type_3d: str = 'Euler-Depth',
                 load_eval_anns: bool = True,
                 tokens_positive_rebuild: bool = False,
                 data_prefix: Optional[dict] = None):
        self.data_root = data_root
        self.ann_file = os.path.join(data_root, ann_file)
        self.vg_file = os.path.join(data_root, vg_file)
        self.test_mode = test_mode
        self.load_eval_anns = load_eval_anns
        self.tokens_positive_rebuild = tokens_positive_rebuild
        self.data_prefix = data_prefix or {}
        self.pipeline = Compose(pipeline)

        classes = (metainfo or {}).get('classes', 'all')
        if classes == 'all' or classes is None:
            self.classes = list(self.METAINFO['classes'])
        else:
            self.classes = list(classes)
        self.label_mapping = {i: i for i in range(len(self.classes))}

        scan_list = self._load_scans()
        self.scans = {d['scan_id']: d for d in scan_list}
        self.data_list = self._load_language_data()

    # ------------------------------------------------------------------
    def _load_scans(self) -> List[dict]:
        annotations = _load_ann_file(self.ann_file)
        metainfo = annotations.get('metainfo', {})
        if 'categories' in metainfo:
            # category name → contiguous train label
            cat2label = metainfo['categories']
            self.label_mapping = {
                v: self.classes.index(k) if k in self.classes else -1
                for k, v in cat2label.items()
            }
        out = []
        for info in annotations['data_list']:
            out.append(self._parse_scan(info))
        return out

    def _parse_scan(self, info: dict) -> dict:
        """Per-scan geometry (reference parse_data_info :505-564)."""
        axis_align = np.asarray(
            info.get('axis_align_matrix', np.eye(4)), np.float64)
        scan_id = info['sample_idx']
        depth_shift = 4000.0 if scan_id.split('/')[0] == 'matterport3d' \
            else 1000.0
        cam2img = info.get('cam2img')
        img_paths, depth_paths, extrinsics, intrinsics = [], [], [], []
        prefix = self.data_prefix.get('img_path', self.data_root)
        for im in info['images']:
            img_paths.append(os.path.join(prefix, im['img_path']))
            depth_paths.append(os.path.join(prefix, im['depth_path']))
            align_global2cam = np.linalg.inv(
                axis_align @ np.asarray(im['cam2global'], np.float64))
            extrinsics.append(align_global2cam.astype(np.float32))
            intrinsics.append(np.asarray(
                cam2img if cam2img is not None else im['cam2img'],
                np.float32))
        ann = self._parse_ann(info)
        return {
            'scan_id': scan_id,
            'axis_align_matrix': axis_align.astype(np.float32),
            'img_path': img_paths,
            'depth_img_path': depth_paths,
            'depth_shift': depth_shift,
            'depth2img': dict(extrinsic=extrinsics, intrinsic=intrinsics),
            'depth_cam2img': info.get('depth_cam2img', intrinsics),
            'cam2img': cam2img,
            'ann_info': ann,
        }

    def _parse_ann(self, info: dict) -> dict:
        """instances → gt arrays (reference parse_ann_info :566-632)."""
        instances = info.get('instances', [])
        if not instances:
            return {'gt_bboxes_3d': np.zeros((0, 9), np.float32),
                    'gt_labels_3d': np.zeros((0, ), np.int64),
                    'bbox_id': np.zeros((0, ), np.int64)}
        boxes = np.stack([np.asarray(i['bbox_3d'], np.float32)
                          for i in instances])
        labels = np.asarray([
            self.label_mapping.get(i['bbox_label_3d'], -1)
            for i in instances
        ], np.int64)
        bbox_ids = np.asarray([i.get('bbox_id', idx)
                               for idx, i in enumerate(instances)], np.int64)
        return {'gt_bboxes_3d': boxes, 'gt_labels_3d': labels,
                'bbox_id': bbox_ids}

    # ------------------------------------------------------------------
    def _load_language_data(self) -> List[dict]:
        """Join per-utterance annos with their scans
        (reference load_language_data :370-503)."""
        annos = _load_ann_file(self.vg_file)
        out = []
        for anno in annos:
            scan = self.scans.get(anno['scan_id'])
            if scan is None:
                continue
            text = anno['text'].lower()
            item = {
                'scan_id': anno['scan_id'],
                'text': text,
                'axis_align_matrix': scan['axis_align_matrix'],
                'img_path': scan['img_path'],
                'depth_img_path': scan['depth_img_path'],
                'depth2img': scan['depth2img'],
                'depth_shift': scan['depth_shift'],
                'depth_cam2img': scan['depth_cam2img'],
                'cam2img': scan['cam2img'],
                'is_view_dep': is_view_dep(text),
            }
            ann = scan['ann_info']
            if 'target_id' in anno:
                tid = anno['target_id']
                if isinstance(tid, int):
                    ind = np.where(ann['bbox_id'] == tid)[0]
                    if len(ind) != 1:
                        continue
                    gt_boxes = ann['gt_bboxes_3d'][ind]
                    gt_labels = ann['gt_labels_3d'][ind]
                    if 'tokens_positive' in anno and not self.test_mode:
                        tp = anno['tokens_positive']
                        if self.tokens_positive_rebuild and 'target' in anno:
                            tp = [[text.find(p), text.find(p) + len(p)]
                                  for p in anno['target'].split()]
                            if any(t[0] == -1 for t in tp):
                                continue
                        item['tokens_positive'] = [tp]
                    else:
                        item['tokens_positive'] = [[[0, 1]]]
                else:  # multi-target
                    inds, keep = [], []
                    ok = True
                    for idx, t in enumerate(tid):
                        ind = np.where(ann['bbox_id'] == t)[0]
                        if len(ind) != 1:
                            ok = False
                            break
                        keep.append(idx)
                        inds.append(ind[0])
                    if not ok:
                        continue
                    gt_boxes = ann['gt_bboxes_3d'][inds]
                    gt_labels = ann['gt_labels_3d'][inds]
                    if 'tokens_positive' in anno:
                        item['tokens_positive'] = [
                            [anno['tokens_positive'][i]] for i in keep
                        ]
                distractors = anno.get('distractor_ids', [])
                item['is_hard'] = len(distractors) > 3
                item['is_unique'] = len(distractors) == 0
            else:
                gt_boxes = ann['gt_bboxes_3d']
                gt_labels = ann['gt_labels_3d']
                item['is_hard'] = False
                item['is_unique'] = False
                item['tokens_positive'] = [[[0, 1]]]
            item['ann_info'] = {
                'gt_bboxes_3d': gt_boxes,
                'gt_labels_3d': gt_labels,
                'is_hard': item['is_hard'],
                'is_view_dep': item['is_view_dep'],
                'is_unique': item['is_unique'],
            }
            out.append(item)
        return out

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, idx: int) -> dict:
        results = dict(self.data_list[idx])
        results['is_hard'] = results['ann_info']['is_hard']
        results['is_unique'] = results['ann_info']['is_unique']
        return self.pipeline(results)


@DATASETS.register_module()
class EmbodiedScanDataset(MultiView3DGroundingDataset):
    """Per-scan detection dataset (reference embodiedscan_dataset.py:17-410):
    same geometry parsing, one sample per scan, no language join."""

    def __init__(self, data_root: str, ann_file: str, pipeline=(),
                 metainfo=None, test_mode=False, filter_empty_gt=True,
                 box_type_3d='Euler-Depth', load_eval_anns=True,
                 data_prefix=None, **kw):
        self.data_root = data_root
        self.ann_file = os.path.join(data_root, ann_file)
        self.test_mode = test_mode
        self.load_eval_anns = load_eval_anns
        self.tokens_positive_rebuild = False
        self.data_prefix = data_prefix or {}
        self.pipeline = Compose(pipeline)
        classes = (metainfo or {}).get('classes', 'all')
        self.classes = (list(self.METAINFO['classes'])
                        if classes in ('all', None) else list(classes))
        self.label_mapping = {i: i for i in range(len(self.classes))}
        self.data_list = self._load_scans()
        if filter_empty_gt and not test_mode:
            self.data_list = [
                d for d in self.data_list
                if len(d['ann_info']['gt_bboxes_3d'])
            ]

    def __getitem__(self, idx: int) -> dict:
        results = dict(self.data_list[idx])
        results['text'] = ''
        return self.pipeline(results)


@DATASETS.register_module()
class RepeatDataset:
    """mmengine RepeatDataset parity."""

    def __init__(self, dataset, times: int = 1):
        self.dataset = (DATASETS.build(dataset)
                        if isinstance(dataset, dict) else dataset)
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]
