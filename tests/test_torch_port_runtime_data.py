"""The port's data path and grounding metric against the JAX package's.

`SyntheticGroundingDataset` samples and `Det3DDataPreprocessor` batches
are bit-equal with the JAX package's (every key, the detection
`gt_labels` and the occupancy targets included); the `DataLoader` yields
the same batches in the same order, epoch by epoch and shard by shard,
through its prefetch thread and through its spawn-context process pool
alike; `ground_eval` gives the same table on fixed predictions, whose
IoUs stay away from the 0.25 / 0.5 thresholds (a float IoU so close to a
threshold could flip `iou > t` on one side), and the IoUs themselves
agree to float32 rounding.
"""
import json

import numpy as np
import pytest
import torch

from proxytransformation_tpu.data.loader import DataLoader as JLoader
from proxytransformation_tpu.data.preprocessor import (
    Det3DDataPreprocessor as JPre)
from proxytransformation_tpu.data.synthetic import (
    SyntheticGroundingDataset as JSynth, SyntheticOccupancyDataset)
from proxytransformation_tpu.eval.grounding_metric import (
    ground_eval as jground_eval)
from proxytransformation_tpu.ops.box3d_overlap import box3d_iou as jiou
from proxytransformation_torch.data.loader import DataLoader as TLoader
from proxytransformation_torch.data.preprocessor import (
    Det3DDataPreprocessor as TPre)
from proxytransformation_torch.data.synthetic import (
    SyntheticGroundingDataset as TSynth)
from proxytransformation_torch.eval.grounding_metric import (
    GroundingMetric, ground_eval as tground_eval)
from proxytransformation_torch.ops.box3d_overlap import box3d_iou as tiou

SMALL = dict(n_points=96, n_views=2, img_size=32, n_objects=3)
PRE = dict(n_points=80, n_views=3, max_text_len=16, max_gts=2)


def assert_same(got, want, where='sample'):
    """Nested dicts, lists, arrays and scalars equal bit for bit, with
    the same array dtypes and shapes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f'{where}.{k}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize('seed,test_mode', [(0, False), (7, True)])
def test_synthetic_samples_match_jax(seed, test_mode):
    jds = JSynth(length=5, seed=seed, test_mode=test_mode, **SMALL)
    tds = TSynth(length=5, seed=seed, test_mode=test_mode, **SMALL)
    assert len(tds) == len(jds)
    for i in (0, 3, 4):
        assert_same(tds[i], jds[i], f'sample {i}')


def test_preprocessor_batches_match_jax():
    """Grounding samples, then occupancy samples (the `gt_occupancy`
    keys), through both preprocessors: more points than the capacity,
    fewer views than it, and in the grounding batch more gt boxes than
    `max_gts` (a warning on both sides)."""
    jpre, tpre = JPre(**PRE), TPre(**PRE)
    ground = [JSynth(length=3, seed=1, **SMALL)[i] for i in range(3)]
    for s in ground:
        s['gt_bboxes_3d'] = np.concatenate([s['gt_bboxes_3d']] * 3)
        s['tokens_positive'] = s['tokens_positive'] * 3
    occ = [SyntheticOccupancyDataset(length=2, n_occupied=8, **SMALL)[i]
           for i in range(2)]
    with pytest.warns(UserWarning, match='max_gts'):
        want = jpre(ground)
    with pytest.warns(UserWarning, match='max_gts'):
        got = tpre(ground)
    assert 'gt_labels' in got
    assert_same(got, want, 'grounding batch')
    got = tpre(occ)
    assert 'gt_occupancy' in got and 'gt_occupancy_masks' in got
    assert_same(got, jpre(occ), 'occupancy batch')


class _Indices:
    """A dataset whose sample is its own index (picklable for spawn)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _order(loader_cls, epochs=(0, 1, 2), **kw):
    loader = loader_cls(_Indices(11), collate_fn=list, **kw)
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append((len(loader), [list(b) for b in loader]))
    return out


@pytest.mark.parametrize('kw', [
    dict(batch_size=3),
    dict(batch_size=3, drop_last=False, shuffle=False),
    dict(batch_size=2, num_shards=2, shard_id=1, seed=5),
    dict(batch_size=4, drop_last=False, num_shards=3, shard_id=2),
])
def test_loader_order_matches_jax(kw):
    """Orders per epoch, shards and drop_last, through the thread."""
    assert _order(TLoader, **kw) == _order(JLoader, **kw)


def test_loader_spawn_batches_match_jax():
    """Collated batches through the port's spawn pool (two workers) and
    its thread equal the JAX loader's, over two epochs."""
    ds_kw = dict(length=5, seed=3, **SMALL)
    want = []
    jl = JLoader(JSynth(**ds_kw), batch_size=2, collate_fn=JPre(**PRE),
                 seed=1)
    for e in (0, 1):
        jl.set_epoch(e)
        want.append(list(jl))
    for workers in (0, 2):
        tl = TLoader(TSynth(**ds_kw), batch_size=2, collate_fn=TPre(**PRE),
                     seed=1, num_workers=workers)
        for e in (0, 1):
            tl.set_epoch(e)
            got = list(tl)
            assert len(got) == len(want[e]) == 2
            for g, w in zip(got, want[e]):
                assert_same(g, w, f'workers {workers} epoch {e}')


def _predictions(rng, n_samples=6, Q=12):
    """Fixed predictions around each sample's gt box: a near copy (IoU
    0.84), a shifted one (0.38), far ones (0); scores rank them per
    sample so that some samples are found at 0.25 only, some at both
    thresholds, some at neither."""
    gts, dets = [], []
    for i in range(n_samples):
        gt = np.concatenate([rng.uniform(1, 4, 3), rng.uniform(0.5, 1.0, 3),
                             [rng.uniform(-1, 1), 0, 0]]).astype(np.float32)
        boxes = np.tile(gt, (Q, 1))
        boxes[:, :3] += rng.uniform(5, 9, (Q, 3))           # far away
        boxes[0] = gt
        boxes[0, :3] += 0.03 * gt[3:6]                       # IoU 0.84
        boxes[1] = gt                          # along its own x: IoU 0.38
        boxes[1, :2] += 0.45 * gt[3] * np.array([np.cos(gt[6]),
                                                 np.sin(gt[6])])
        scores = rng.uniform(0, 1, Q).astype(np.float32)
        if i % 3 == 0:
            scores[0] = 2.0
        elif i % 3 == 1:
            scores[0], scores[1] = -1.0, 2.0
        else:
            scores[0] = scores[1] = -1.0
        gts.append({'gt_bboxes_3d': gt[None], 'is_hard': i % 2 == 0,
                    'is_view_dep': i % 3 == 0, 'is_unique': i % 4 == 0})
        dets.append({'bboxes_3d': boxes, 'target_scores_3d': scores})
    return gts, dets


def test_ground_eval_matches_jax():
    gts, dets = _predictions(np.random.RandomState(0))
    for g, d in zip(gts, dets):
        want = np.asarray(jiou(d['bboxes_3d'], g['gt_bboxes_3d']))
        got = tiou(torch.from_numpy(d['bboxes_3d']),
                   torch.from_numpy(g['gt_bboxes_3d'])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # away from the thresholds, so `iou > t` cannot flip
        assert np.all(np.minimum(np.abs(want - 0.25),
                                 np.abs(want - 0.5)) > 0.05)
    want = jground_eval(gts, dets, top_k=2)
    got = tground_eval(gts, dets, top_k=2)
    assert got == want
    assert 0 < got['Overall@0.5'] < got['Overall@0.25'] < 1


def test_grounding_metric_process_and_dump(tmp_path):
    gts, dets = _predictions(np.random.RandomState(1))
    metric = GroundingMetric(top_k=2)
    for g, d in zip(gts, dets):
        metric.process(None, [{'eval_ann_info': g, 'pred_instances_3d': d}])
    assert metric.evaluate() == jground_eval(gts, dets, top_k=2)
    assert metric.results == []
    dump = GroundingMetric(format_only=True, result_dir=str(tmp_path))
    for g, d in zip(gts, dets):
        dump.process(None, [{'eval_ann_info': g, 'pred_instances_3d': d}])
    assert dump.evaluate() == {}
    out = json.loads((tmp_path / 'test_results.json').read_text())
    assert len(out) == len(dets) and len(out[0]['bboxes_3d']) == 12
    np.testing.assert_allclose(out[0]['scores_3d'][0], 2.0)
