"""The port's EmbodiedScan data path and EMA hook against the JAX package.

On the JAX package's miniature RGB-D dataset (`tests/test_realdata_e2e.py::
_make_mini_dataset`, files written by cv2) plus a matterport scan
(depth shift 4000, a rotated axis alignment, multi-target and
`tokens_positive_rebuild` utterances) and a 3RScan scan (EmbodiedScan's
`3rscan/<id>/sequence/frame-XXXXXX.{color.jpg,depth.pgm}`: 960x540 JPEG
color, 224x172 16-bit PGM depth at shift 1000, a `depth_cam2img` of its
own; the committed fixture frame and cv2-written variants of it):

- the datasets' `data_list` (`MultiView3DGroundingDataset`,
  `EmbodiedScanDataset`, `RepeatDataset`) equal the JAX package's;
- each transform, under the same `np.random.seed`, gives what its JAX twin
  gives; whole packed samples and `Det3DDataPreprocessor` batches too.
  Images, indices, labels, tokens and points are compared bit for bit:
  the port's decoders and resize are byte-equal with cv2, and its point
  kernels round as the JAX package's native library does, fused
  multiply-adds of `transform_points` included. Boxes that went through
  `box_transform` / `box_flip` (float32 torch here, XLA there) and colors
  sampled at projected pixels are held within BOX_TOL;
- `ExpMomentumEMA` against the JAX package's update under `jax.jit` (the
  form its Runner runs) over several steps, within EMA_RTOL, and its
  momentum at every step of 0-19999: the exponent bit for bit, m within
  EMA_ULPS (float32 `exp` of numpy against XLA's may differ by an ulp);
- the port's Runner trains an epoch, validates on the EMA weights,
  checkpoints them, resumes them bit for bit and tests, through the CLIs,
  on the CPU.
"""
import copy
import json
import logging
import os
import pickle
import shutil
from pathlib import Path

import cv2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxytransformation_tpu.data  # noqa: F401  (registers transforms)
from proxytransformation_tpu.data import dataset as jds
from proxytransformation_tpu.data import transforms as jtf
from proxytransformation_tpu.data.preprocessor import (
    Det3DDataPreprocessor as JaxPreprocessor)
from proxytransformation_tpu.models.misc import ExpMomentumEMA as JaxEMA
from proxytransformation_torch.data import dataset as tds
from proxytransformation_torch.data import transforms as ttf
from proxytransformation_torch.data.preprocessor import (
    Det3DDataPreprocessor as TorchPreprocessor)
from proxytransformation_torch.engine.checkpoint import (latest_checkpoint,
                                                         load_checkpoint)
from proxytransformation_torch.engine import runner as runner_mod
from proxytransformation_torch.models.misc import ExpMomentumEMA
from proxytransformation_torch.tools import test as ttest
from proxytransformation_torch.tools import train as ttrain

from test_realdata_e2e import _CFG, _make_mini_dataset

# float32 box rotations composed by torch here and by XLA there
BOX_TOL = dict(rtol=1e-5, atol=1e-6)
EMA_RTOL = 1e-6
EMA_ULPS = 1
MATTERPORT = 'matterport3d/17DRP5sb8fy/region0'
RSCAN = '3rscan/0cac7578-8d6f-2d13-8c2d-bfa7a04f8af3'
FIXTURES = Path(__file__).resolve().parent / 'torch_port_images'
EMA_HOOK = ("custom_hooks = [dict(type='EMAHook', ema_type='ExpMomentumEMA',"
            " momentum=0.0002, gamma=2000)]\n")


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rscan_scan(root: str) -> dict:
    """A 3RScan scan's info: three frames under `3rscan/<id>/sequence/` (the
    committed 960x540 / 224x172 fixture frame, then cv2-written mirror and
    darkened variants of it), the fixture's two cameras, its room's boxes,
    a rotated axis alignment."""
    rscan = json.loads((FIXTURES / 'manifest.json').read_text())['rscan']
    seq = Path(root) / RSCAN / 'sequence'
    seq.mkdir(parents=True)
    color = cv2.imread(str(FIXTURES / rscan['image']))
    depth = cv2.imread(str(FIXTURES / rscan['depth']), cv2.IMREAD_UNCHANGED)
    images = []
    for i in range(3):
        stem = seq / f'frame-{i:06d}'
        if i == 0:
            shutil.copy(FIXTURES / rscan['image'], f'{stem}.color.jpg')
            shutil.copy(FIXTURES / rscan['depth'], f'{stem}.depth.pgm')
        else:
            flip = (lambda a: a[:, ::-1]) if i == 1 else (lambda a: a)
            cv2.imwrite(f'{stem}.color.jpg', flip(color) // i)
            cv2.imwrite(f'{stem}.depth.pgm', np.ascontiguousarray(
                flip(depth) + np.uint16(100 * i)))
        pose = np.asarray(rscan['cam2global'], np.float64)
        pose[:3, 3] += [0.05 * i, -0.03 * i, 0.0]
        images.append({
            'img_path': os.path.relpath(f'{stem}.color.jpg', root),
            'depth_path': os.path.relpath(f'{stem}.depth.pgm', root),
            'cam2global': pose})
    c, s = np.cos(-0.3), np.sin(-0.3)
    boxes = json.loads((FIXTURES / 'manifest.json').read_text())['boxes']
    return {
        'sample_idx': RSCAN,
        'axis_align_matrix': np.array([[c, -s, 0, -0.1], [s, c, 0, 0.2],
                                       [0, 0, 1, 0.0], [0, 0, 0, 1]]),
        'cam2img': np.asarray(rscan['cam2img'], np.float64),
        'depth_cam2img': np.asarray(rscan['depth_cam2img'], np.float64),
        'images': images,
        'instances': [{'bbox_3d': b, 'bbox_label_3d': j % 3, 'bbox_id': j}
                      for j, b in enumerate(boxes)]}


def make_dataset(root, rscan: bool = True) -> str:
    """The JAX test's mini dataset plus a matterport scan and (with
    `rscan`) a 3RScan scan, written to `mini_infos_ext.pkl` /
    `mini_vg_ext.json` (the matterport utterances last)."""
    root = _make_mini_dataset(str(root))
    with open(os.path.join(root, 'mini_infos_train.pkl'), 'rb') as f:
        infos = pickle.load(f)
    with open(os.path.join(root, 'mini_vg_train.json')) as f:
        vg = json.load(f)
    scan = copy.deepcopy(infos['data_list'][0])
    scan['sample_idx'] = MATTERPORT
    c, s = np.cos(0.5), np.sin(0.5)
    scan['axis_align_matrix'] = np.array(
        [[c, -s, 0, 0.3], [s, c, 0, -0.2], [0, 0, 1, 0.05], [0, 0, 0, 1]])
    for i, im in enumerate(scan['images']):
        im['cam2global'] = im['cam2global'].copy()
        im['cam2global'][:3, :3] = np.array(
            [[np.cos(0.2 * i), 0, np.sin(0.2 * i)], [0, 1, 0],
             [-np.sin(0.2 * i), 0, np.cos(0.2 * i)]])
    scan['instances'] += [
        {'bbox_3d': [-0.6, 0.4, 1.0, 1.8, 1.2, 0.6, 0.3, 0.0, 0.0],
         'bbox_label_3d': 2, 'bbox_id': 2},
        {'bbox_3d': [0.2, 0.9, 1.4, 0.4, 0.4, 0.9, -0.2, 0.1, 0.0],
         'bbox_label_3d': 0, 'bbox_id': 3}]
    infos['data_list'].append(scan)
    if rscan:
        infos['data_list'].append(rscan_scan(root))
        vg += [
            {'scan_id': RSCAN, 'text': 'the bed by the table',
             'target_id': 1, 'distractor_ids': [],
             'tokens_positive': [[4, 7]]},
            {'scan_id': RSCAN, 'text': 'the chairs', 'target_id': [0, 2],
             'distractor_ids': [1], 'tokens_positive': [[4, 10], [4, 10]]}]
    vg += [
        {'scan_id': MATTERPORT, 'text': 'The bed and the chair',
         'target_id': [2, 0], 'distractor_ids': [],
         'tokens_positive': [[4, 7], [16, 21]]},
        {'scan_id': MATTERPORT, 'text': 'the chair by the bed on the left',
         'target_id': 3, 'target': 'chair bed', 'distractor_ids': [0],
         'tokens_positive': [[0, 3]]},
        {'scan_id': MATTERPORT, 'text': 'a lamp', 'target_id': 1,
         'target': 'sofa', 'distractor_ids': [1, 2, 3, 4, 5],
         'tokens_positive': [[2, 6]]},
        {'scan_id': MATTERPORT, 'text': 'a ghost', 'target_id': 9,
         'distractor_ids': [], 'tokens_positive': [[2, 7]]},
        {'scan_id': 'scannet/scene9999_00', 'text': 'elsewhere',
         'target_id': 0, 'distractor_ids': []},
        {'scan_id': MATTERPORT, 'text': 'the whole room'},
    ]
    with open(os.path.join(root, 'mini_infos_ext.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    with open(os.path.join(root, 'mini_vg_ext.json'), 'w') as f:
        json.dump(vg, f)
    return root


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp('realdata'))


def assert_same(got, want, path='', tol_keys=()):
    """Nested dicts / sequences of arrays and values: equal bit for bit,
    float arrays under a key of `tol_keys` within BOX_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], f'{path}.{k}', tol_keys)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]', tol_keys)
    elif isinstance(want, (np.ndarray, jnp.ndarray)):
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        if path.split('.')[-1].split('[')[0] in tol_keys:
            np.testing.assert_allclose(got, want, err_msg=path, **BOX_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) or (
            np.isscalar(got) and np.isscalar(want)), (path, got, want)
        assert got == want, (path, got, want)


def both_datasets(root, cls='MultiView3DGroundingDataset', **kw):
    args = dict(data_root=root, ann_file='mini_infos_ext.pkl', **kw)
    if cls != 'EmbodiedScanDataset':
        args['vg_file'] = 'mini_vg_ext.json'
    return (getattr(tds, cls)(**args), getattr(jds, cls)(**args))


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------
@pytest.mark.parametrize('kw', [
    dict(), dict(test_mode=True), dict(tokens_positive_rebuild=True),
    dict(metainfo={'classes': ['table', 'bed', 'chair']})],
    ids=['train', 'test_mode', 'rebuild', 'classes'])
def test_grounding_data_list_equals_jax(root, kw):
    port, ref = both_datasets(root, **kw)
    assert len(port) == len(ref) > 4
    assert_same(port.data_list, ref.data_list)
    mp = [d for d in port.data_list if d['scan_id'] == MATTERPORT]
    assert mp and all(d['depth_shift'] == 4000.0 for d in mp)
    assert any(len(d['ann_info']['gt_bboxes_3d']) == 2 for d in mp)


def test_embodiedscan_and_repeat_datasets_equal_jax(root):
    for kw in (dict(), dict(test_mode=True)):
        port, ref = both_datasets(root, 'EmbodiedScanDataset', **kw)
        assert len(port) == len(ref) == 4
        assert_same(port.data_list, ref.data_list)
    inner = dict(type='MultiView3DGroundingDataset', data_root=root,
                 ann_file='mini_infos_ext.pkl', vg_file='mini_vg_ext.json',
                 pipeline=[dict(type='LoadAnnotations3D')])
    port = tds.RepeatDataset(inner, times=3)
    ref = jds.RepeatDataset(inner, times=3)
    assert len(port) == len(ref) == 3 * len(port.dataset)
    for i in (0, len(port.dataset) + 1, len(port) - 1):
        assert_same(port[i], ref[i])
    scan_port = tds.EmbodiedScanDataset(
        data_root=root, ann_file='mini_infos_ext.pkl',
        pipeline=[dict(type='LoadAnnotations3D')])
    scan_ref = jds.EmbodiedScanDataset(
        data_root=root, ann_file='mini_infos_ext.pkl',
        pipeline=[dict(type='LoadAnnotations3D')])
    assert_same(scan_port[2], scan_ref[2])


# --------------------------------------------------------------------------
# transforms, one by one
# --------------------------------------------------------------------------
VIEW = [dict(type='LoadImageFromFile'), dict(type='LoadDepthFromFile'),
        dict(type='ConvertRGBDToPoints', coord_type='CAMERA')]
MULTIVIEW = dict(type='MultiViewPipeline', n_images=2,
                 transforms=VIEW + [dict(type='PointSample', num_points=300),
                                    dict(type='Resize', scale=(48, 40))])
CLOUD = [dict(type='LoadAnnotations3D'), MULTIVIEW,
         dict(type='AggregateMultiViewPoints', coord_type='DEPTH',
              save_slices=True)]
# name → (input kind, transforms to compare, keys within BOX_TOL)
CASES = {
    'LoadAnnotations3D': ('item', [dict(type='LoadAnnotations3D')], ()),
    'LoadImageFromFile': ('view', [dict(type='LoadImageFromFile',
                                        to_float32=True)], ()),
    'LoadDepthFromFile': ('view', [dict(type='LoadDepthFromFile')], ()),
    'ConvertRGBDToPoints': ('view', VIEW, ()),
    'ConvertRGBDToPoints_color': ('view', VIEW[:2] + [
        dict(type='ConvertRGBDToPoints', use_color=True)], ()),
    'PointSample': ('view', VIEW + [dict(type='PointSample',
                                         num_points=500)], ()),
    'PointSample_replace': ('view', VIEW + [dict(type='PointSample',
                                                 num_points=9000)], ()),
    'FPSPointSample': ('view', VIEW + [dict(type='FPSPointSample',
                                            num_points=64)], ()),
    'Resize': ('view', [dict(type='LoadImageFromFile'),
                        dict(type='Resize', scale=(48, 40))], ()),
    'MultiViewPipeline': ('item', [MULTIVIEW], ()),
    'MultiViewPipeline_ordered': ('item', [dict(MULTIVIEW, n_images=2,
                                                ordered=True)], ()),
    'MultiViewPipeline_ordered_short': ('item', [dict(MULTIVIEW, n_images=5,
                                                      ordered=True)], ()),
    'AggregateMultiViewPoints': ('item', CLOUD, ()),
    'GlobalRotScaleTrans': ('item', CLOUD + [dict(type='GlobalRotScaleTrans')],
                            ('gt_bboxes_3d', )),
    'RandomFlip3D': ('item', CLOUD + [dict(
        type='RandomFlip3D', flip_ratio_bev_horizontal=1.0,
        flip_ratio_bev_vertical=0.5)], ('gt_bboxes_3d', )),
    'PointsRangeFilter': ('item', CLOUD + [dict(
        type='PointsRangeFilter',
        point_cloud_range=[-1.0, -1.0, 0.5, 1.0, 1.0, 2.0])], ()),
    'Pack3DDetInputs': ('item', CLOUD + [dict(type='Pack3DDetInputs')], ()),
    'MultiScaleFlipAug3D': ('item', CLOUD + [dict(
        type='MultiScaleFlipAug3D', pts_scale_ratio=[1.0, 1.1], flip=True,
        flip_direction=['horizontal', 'vertical'],
        transforms=[dict(type='PointSample', num_points=400)])], ()),
    'ConstructMultiSweeps': ('item', CLOUD + [
        dict(type='ConstructMultiSweeps'), dict(type='PointsToGPU')], ()),
}


def case_input(root, kind, scan=MATTERPORT):
    port, _ = both_datasets(root)
    item = dict([d for d in port.data_list if d['scan_id'] == scan][-1])
    item['is_hard'] = item['ann_info']['is_hard']
    item['is_unique'] = item['ann_info']['is_unique']
    if kind == 'item':
        return item
    return {'img_path': item['img_path'][1],
            'depth_img_path': item['depth_img_path'][1],
            'depth_shift': item['depth_shift'],
            'depth_cam2img': np.array(
                item['depth_cam2img'][1]
                if isinstance(item['depth_cam2img'], list)
                else item['depth_cam2img']),
            'cam2img': np.array(item['cam2img'])}


def run_both(transforms, inp, seed=3):
    np.random.seed(seed)
    got = ttf.Compose(copy.deepcopy(transforms))(copy.deepcopy(inp))
    np.random.seed(seed)
    want = jtf.Compose(copy.deepcopy(transforms))(copy.deepcopy(inp))
    return got, want


@pytest.mark.parametrize('name', sorted(CASES))
def test_transform_equals_jax(root, name):
    kind, transforms, tol_keys = CASES[name]
    got, want = run_both(transforms, case_input(root, kind))
    assert_same(got, want, tol_keys=tol_keys)
    if name == 'ConvertRGBDToPoints_color':
        assert got['points'].shape[1] == 6


def test_rscan_data_list_reads_pgm_depth_with_its_own_camera(root):
    """The 3RScan scan's samples: shift 1000 (the non-Matterport branch),
    PGM depth paths, the depth camera's intrinsics apart from the color
    camera's; its frames decode as cv2 reads them (960x540 BGR, 224x172
    uint16)."""
    port, ref = both_datasets(root)
    rs = [d for d in port.data_list if d['scan_id'] == RSCAN]
    assert len(rs) == 2
    assert_same(rs, [d for d in ref.data_list if d['scan_id'] == RSCAN])
    for d in rs:
        assert d['depth_shift'] == 1000.0
        assert all(p.endswith('.depth.pgm') for p in d['depth_img_path'])
        assert not np.array_equal(d['depth_cam2img'], d['cam2img'])
    got, want = run_both(VIEW[:2], case_input(root, 'view', RSCAN))
    assert got['img'].shape == (540, 960, 3)
    assert got['depth_img'].shape == (172, 224)
    assert got['depth_img'].dtype == np.uint16
    assert_same(got, want)


@pytest.mark.parametrize('name', sorted(CASES))
def test_rscan_transform_equals_jax(root, name):
    """Each transform case of `test_transform_equals_jax` on the 3RScan
    scan: its 224x172 PGM depth back-projected with `depth_cam2img`, its
    960x540 colors sampled through `cam2img`."""
    kind, transforms, tol_keys = CASES[name]
    got, want = run_both(transforms, case_input(root, kind, RSCAN))
    assert_same(got, want, tol_keys=tol_keys)


@pytest.mark.parametrize('dim', [6, 7, 9])
def test_box_ops_equal_jax(dim):
    """box_transform and box_flip (the augmentations' box updates) on 6-,
    7- and 9-dim boxes, within BOX_TOL of the JAX package's."""
    from proxytransformation_tpu.structures import boxes as jboxes
    from proxytransformation_torch.structures import boxes as tboxes
    rng = np.random.RandomState(dim)
    boxes = rng.randn(6, dim).astype(np.float32)
    mat = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.7), np.sin(0.7)
    mat[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    mat[:3, 3] = [0.3, -0.2, 0.1]
    np.testing.assert_allclose(
        tboxes.box_transform(torch.from_numpy(boxes),
                             torch.from_numpy(mat)).numpy(),
        np.asarray(jboxes.box_transform(jnp.asarray(boxes),
                                        jnp.asarray(mat))), **BOX_TOL)
    for direction in 'XYZ':
        np.testing.assert_array_equal(
            tboxes.box_flip(torch.from_numpy(boxes), direction).numpy(),
            np.asarray(jboxes.box_flip(jnp.asarray(boxes), direction)))


def test_preprocessed_cache_roundtrip(root, tmp_path):
    """SavingPreprocessData / LoadPreprocessedData: the same pickle."""
    item = case_input(root, 'item')
    cache = str(tmp_path / 'cache')
    save = [dict(type='LoadAnnotations3D'), MULTIVIEW,
            dict(type='SavingPreprocessData', cache_dir=cache)]
    np.random.seed(0)
    ttf.Compose(save)(copy.deepcopy(item))
    for compose in (ttf.Compose, jtf.Compose):
        out = compose([dict(type='LoadPreprocessedData',
                            cache_dir=cache)])(copy.deepcopy(item))
        assert out['_cache_hit'] and len(out['img']) == 2


# --------------------------------------------------------------------------
# whole samples and batches
# --------------------------------------------------------------------------
TRAIN_PIPELINE = [
    dict(type='LoadAnnotations3D'),
    dict(type='MultiViewPipeline', n_images=2,
         transforms=VIEW + [dict(type='PointSample', num_points=512),
                            dict(type='Resize', scale=(64, 64))]),
    dict(type='AggregateMultiViewPoints', coord_type='DEPTH'),
    dict(type='PointSample', num_points=1024),
    dict(type='GlobalRotScaleTrans', rot_range=[-0.087, 0.087],
         scale_ratio_range=[0.9, 1.1], translation_std=[0.1, 0.1, 0.1]),
    dict(type='Pack3DDetInputs')]
TEST_PIPELINE = [
    dict(type='LoadAnnotations3D'),
    dict(type='MultiViewPipeline', n_images=3, ordered=True,
         transforms=VIEW + [dict(type='PointSample', num_points=512),
                            dict(type='Resize', scale=(64, 64))]),
    dict(type='AggregateMultiViewPoints', coord_type='DEPTH'),
    dict(type='PointSample', num_points=1024),
    dict(type='Pack3DDetInputs')]


@pytest.mark.parametrize('test_mode', [False, True], ids=['train', 'test'])
def test_samples_and_batches_equal_jax(root, test_mode):
    pipeline = TEST_PIPELINE if test_mode else TRAIN_PIPELINE
    port, ref = both_datasets(root, pipeline=pipeline, test_mode=test_mode)
    n_views = 3 if test_mode else 2
    pp = dict(n_points=1024, n_views=n_views, max_gts=4, max_text_len=64)
    tpp, jpp = TorchPreprocessor(**pp), JaxPreprocessor(**pp)
    for start in range(0, len(port), 2):
        idx = range(start, min(start + 2, len(port)))
        np.random.seed(100 + start)
        got = [port[i] for i in idx]
        np.random.seed(100 + start)
        want = [ref[i] for i in idx]
        assert_same(got, want, tol_keys=('gt_bboxes_3d', ))
        assert_same(tpp(got), jpp(want),
                    tol_keys=('gt_bboxes', 'gt_bboxes_3d'))


# --------------------------------------------------------------------------
# the EMA hook
# --------------------------------------------------------------------------
def _jitted_jax_update(ref):
    """The JAX package's EMA update under `jax.jit`, as its Runner's
    jitted train step runs it (the step an int32 array)."""
    return jax.jit(lambda e, p, s: ref.update(e, p, s))


def test_ema_update_matches_jax():
    rng = np.random.RandomState(0)
    shapes = {'a': (3, 4), 'b': (7, ), 'c': (2, 2, 2)}
    ema_t = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
             for k, s in shapes.items()}
    # a copy: on the CPU jnp.asarray may share the numpy buffer, which the
    # port's in-place update would then change under the JAX side
    ema_j = {k: jnp.asarray(v.numpy().copy()) for k, v in ema_t.items()}
    port, ref = ExpMomentumEMA(0.0002, 2000), JaxEMA(0.0002, 2000)
    update = _jitted_jax_update(ref)
    for step in (0, 1, 2, 7, 1999, 20000):
        params = {k: rng.randn(*s).astype(np.float32)
                  for k, s in shapes.items()}
        port.update(ema_t, {k: torch.from_numpy(v)
                            for k, v in params.items()}, step)
        ema_j = update(ema_j, {k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(step, jnp.int32))
        for k in shapes:
            np.testing.assert_allclose(ema_t[k].numpy(), np.asarray(ema_j[k]),
                                       rtol=EMA_RTOL, atol=EMA_RTOL)


def test_ema_momentum_matches_the_jitted_jax_step_at_every_step():
    """Steps 0-19999 at gamma 2000: the exponent bit for bit with the
    jitted JAX expression (its division folded into a multiplication by
    the float32 reciprocal), and m within one ulp of the jitted JAX m
    (EMA_ULPS: XLA's CPU exp is another polynomial than numpy's). m is
    read from the jitted update itself: ema 0 moved towards 1 is m."""
    port, ref = ExpMomentumEMA(0.0002, 2000), JaxEMA(0.0002, 2000)
    steps = jnp.arange(20000, dtype=jnp.int32)
    exponent = jax.jit(jax.vmap(lambda s: -(1 + s) / ref.gamma))(steps)
    m_jax = jax.jit(jax.vmap(lambda s: ref.update(
        {'m': jnp.float32(0)}, {'m': jnp.float32(1)}, s)['m']))(steps)
    exponent, m_jax = np.asarray(exponent), np.asarray(m_jax)
    assert exponent.dtype == np.float32 and m_jax.dtype == np.float32
    got_t = np.array([port.exponent(s) for s in range(20000)], np.float32)
    got_m = np.array([port.momentum_at(s) for s in range(20000)], np.float32)
    np.testing.assert_array_equal(got_t, exponent)
    ulps = np.abs(got_m - m_jax) / np.spacing(m_jax)
    assert ulps.max() <= EMA_ULPS, (ulps.max(), int(np.argmax(ulps)))


@pytest.mark.parametrize('hooks,match', [
    ([dict(type='CheckpointHook')], 'ExpMomentumEMA hook only'),
    ([dict(type='EMAHook', ema_type='ExponentialMovingAverage')],
     'ExpMomentumEMA hook only'),
    ([dict(type='EMAHook', update_buffers=True)], 'update_buffers'),
    ([dict(type='ExpMomentumEMA')] * 2, 'second EMA hook')])
def test_ema_hook_config_raises(hooks, match):
    with pytest.raises(NotImplementedError, match=match):
        runner_mod.ema_from_hooks(hooks)


def test_runner_trains_validates_on_ema_resumes_and_tests(root, tmp_path,
                                                          caplog):
    cfg = tmp_path / 'mini_cfg.py'
    cfg.write_text(_CFG.replace('{root}', root) + EMA_HOOK)
    work = str(tmp_path / 'work')
    args = [str(cfg), '--device', 'cpu', '--work-dir', work]
    with caplog.at_level(logging.INFO, 'proxytransformation_torch'):
        runner = ttrain.main(args + ['--cfg-options',
                                     'train_cfg.val_interval=1'])
    assert 'validating with EMA-averaged weights' in caplog.text
    assert runner.global_step == 2 and len(runner.train_log) == 2
    results = json.loads((tmp_path / 'work' / 'val_results.json').read_text())
    assert 'Overall@0.25' in results and 'Hard@0.25' in results
    params = dict(runner.model.named_parameters())
    moved = [n for n in params
             if not torch.equal(params[n], runner.ema_state[n])]
    assert moved, 'the EMA weights equal the trained ones'
    path = latest_checkpoint(work)
    saved = load_checkpoint(path)
    for n, e in runner.ema_state.items():
        assert torch.equal(saved['ema'][n], e), n

    # val swaps the EMA weights in, and back out
    seen = {}
    name = moved[0]

    def record(module, args):
        seen.setdefault('p', params[name].detach().clone())

    handle = runner.model.register_forward_pre_hook(record)
    before = params[name].detach().clone()
    runner.val(init_state=False)
    handle.remove()
    assert torch.equal(seen['p'], runner.ema_state[name])
    assert torch.equal(params[name], before)

    # --resume restores the EMA weights bit for bit
    restored = {}
    resume_from = runner_mod.Runner.resume_from

    def checked(self, p):
        out = resume_from(self, p)
        restored.update({k: v.clone() for k, v in self.ema_state.items()})
        return out

    runner_mod.Runner.resume_from = checked
    try:
        ttrain.main(args + ['--resume', 'auto', '--cfg-options',
                            'train_cfg.max_epochs=2'])
    finally:
        runner_mod.Runner.resume_from = resume_from
    for n, e in saved['ema'].items():
        assert torch.equal(restored[n], e), n

    # the test CLI scores the checkpoint on its EMA weights
    (tmp_path / 'work' / 'val_results.json').unlink()
    ckpt = latest_checkpoint(work)
    with caplog.at_level(logging.INFO, 'proxytransformation_torch'):
        ttest.main([str(cfg), ckpt, '--device', 'cpu', '--work-dir', work])
    assert 'validating with EMA-averaged weights' in caplog.text
    assert 'Overall@0.5' in json.loads(
        (tmp_path / 'work' / 'val_results.json').read_text())


def test_ema_hook_on_a_checkpoint_saved_without_it(tmp_path, caplog):
    """Val starts the EMA from such a checkpoint's own weights (with a
    warning); a resume from it refuses, as the state to resume is not
    all there."""
    from proxytransformation_torch.utils.config import Config
    smoke = 'configs/grounding/synthetic_smoke.py'
    opts = ['train_dataloader.dataset.length=2',
            'val_dataloader.dataset.length=2', 'train_cfg.val_interval=99']
    ttrain.main([smoke, '--device', 'cpu', '--work-dir', str(tmp_path / 'a'),
                 '--cfg-options', *opts])
    ckpt = latest_checkpoint(str(tmp_path / 'a'))
    assert load_checkpoint(ckpt)['ema'] is None
    cfg = Config.fromfile(smoke)
    cfg.merge_from_dict(Config.parse_cfg_options(
        opts + ['custom_hooks=[{"type": "ExpMomentumEMA"}]']))
    runner = runner_mod.Runner(cfg, str(tmp_path / 'b'), device='cpu')
    with caplog.at_level(logging.WARNING, 'proxytransformation_torch'):
        runner.val(resume=ckpt)
    assert 'holds no EMA weights' in caplog.text
    saved = load_checkpoint(ckpt)['model']
    for n, e in runner.ema_state.items():
        assert torch.equal(e, saved[n]), n
    with pytest.raises(ValueError, match='no EMA weights'):
        runner.resume_from(ckpt)
