"""The port's `EmbodiedScanExplorer` against the JAX package's, on the CPU.

Both explorers read the mini EmbodiedScan tree of
`test_torch_port_realdata.py::make_dataset` (two ScanNet scans and a
Matterport scan with a rotated axis alignment, three 64x64 RGB-D views
each) through an infos pkl with absolute paths. The port runs with
`device='cpu'` and reads the images with its own decoder; the JAX side
with cv2. Listings, `show_image(render_box=True)` (pixel for pixel),
the continuous renders' paths and states, and `render_occupancy`'s
recorded draw arrays must be equal.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from proxytransformation_tpu.explorer import (
    EmbodiedScanExplorer as JaxExplorer)
from proxytransformation_torch.explorer import EmbodiedScanExplorer

from test_torch_port_realdata import MATTERPORT, make_dataset


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def explorers(tmp_path_factory):
    """(port, jax, save dirs): both explorers on the same infos pkl."""
    tmp = tmp_path_factory.mktemp('explorer')
    root = make_dataset(tmp / 'data', rscan=False)
    with open(os.path.join(root, 'mini_infos_ext.pkl'), 'rb') as f:
        infos = pickle.load(f)
    # the explorer reads absolute paths; the tree holds relative ones
    for d in infos['data_list']:
        for im in d['images']:
            im['img_path'] = os.path.join(root, im['img_path'])
            im['depth_path'] = os.path.join(root, im['depth_path'])
    ann = tmp / 'infos_abs.pkl'
    with open(ann, 'wb') as f:
        pickle.dump(infos, f)
    dirs = {'t': str(tmp / 'viz_t'), 'j': str(tmp / 'viz_j')}
    port = EmbodiedScanExplorer(root, [str(ann)], save_dir=dirs['t'],
                                device='cpu')
    jax_side = JaxExplorer(root, [str(ann)], save_dir=dirs['j'])
    return port, jax_side, dirs


def test_explorer_needs_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        EmbodiedScanExplorer(save_dir=str(tmp_path / 'viz'))
    assert not (tmp_path / 'viz').exists()


def test_listings_equal(explorers):
    port, jax_side, _ = explorers
    assert port.list_scenes() == jax_side.list_scenes()
    assert MATTERPORT in port.list_scenes()
    assert port.count_scenes() == jax_side.count_scenes() == 3
    assert port.category_statistics() == jax_side.category_statistics()
    assert port.list_categories() == jax_side.list_categories()
    for scene in port.list_scenes() + ['scannet/scene9999_00']:
        assert port.scene_info(scene) == jax_side.scene_info(scene)
        assert port.list_cameras(scene) == jax_side.list_cameras(scene)
        got, want = port.list_instances(scene), jax_side.list_instances(scene)
        assert (got is None) == (want is None)
        for g, w in zip(got or [], want or [], strict=True):
            assert g['name'] == w['name']
            assert np.array_equal(g['bbox_3d'], w['bbox_3d'])
    # a label outside the categories reads '?'
    port.data[0]['instances'].append({'bbox_3d': [0] * 9,
                                      'bbox_label_3d': 77})
    jax_side.data[0]['instances'].append({'bbox_3d': [0] * 9,
                                          'bbox_label_3d': 77})
    try:
        assert port.category_statistics() == jax_side.category_statistics()
        assert '?' in port.category_statistics()
    finally:
        port.data[0]['instances'].pop()
        jax_side.data[0]['instances'].pop()


def test_show_image_equal(explorers):
    port, jax_side, _ = explorers
    for scene in port.list_scenes():
        for cam in port.list_cameras(scene):
            for render_box in (False, True):
                got = port.show_image(scene, cam, render_box=render_box)
                want = jax_side.show_image(scene, cam, render_box=render_box)
                assert got.dtype == want.dtype == np.uint8
                assert np.array_equal(got, want), (scene, cam, render_box)
    plain = port.show_image(MATTERPORT, port.list_cameras(MATTERPORT)[0])
    boxed = port.show_image(MATTERPORT, port.list_cameras(MATTERPORT)[0],
                            render_box=True)
    assert (plain != boxed).any()
    assert port.show_image(MATTERPORT, 'nope') is None
    assert port.show_image('scannet/scene9999_00', '00000') is None


def test_render_scene_and_continuous_paths_equal(explorers):
    port, jax_side, dirs = explorers
    pts = np.random.RandomState(0).uniform(-1, 2, (500, 3)).astype(
        np.float32)
    for scene in (MATTERPORT, 'scannet/scene9999_00'):
        got, want = port.render_scene(scene, pts), jax_side.render_scene(
            scene, pts)
        assert (got is None) == (want is None)
        if want is not None:
            assert (os.path.relpath(got, dirs['t'])
                    == os.path.relpath(want, dirs['j']))
            assert os.path.exists(got)
    got = port.render_continuous_scene(MATTERPORT)
    want = jax_side.render_continuous_scene(MATTERPORT)
    assert ([os.path.relpath(p, dirs['t']) for p in got]
            == [os.path.relpath(p, dirs['j']) for p in want])
    assert len(got) == 3 and all(os.path.exists(p) for p in got)
    assert port.render_continuous_scene('scannet/scene9999_00') is None


def test_continuous_occupancy_and_occupancy_render_equal(explorers,
                                                         monkeypatch):
    port, jax_side, _ = explorers
    occ = [np.array([[0, 0, 0, 1], [2, 1, 0, 5]]), np.array([[2, 1, 0, 7]]),
           np.array([[3, 3, 1, 300]])]
    got = port.render_continuous_occupancy(occ, voxel_size=0.1)
    want = jax_side.render_continuous_occupancy(occ, voxel_size=0.1)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ('points', 'labels'):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
        assert g['view_index'] == w['view_index']

    from matplotlib.axes import Axes
    calls = []
    scatter = Axes.scatter

    def record(self, x, y, *a, **kw):
        calls.append((np.stack([x, y]), np.asarray(kw.get('c'))))
        return scatter(self, x, y, *a, **kw)

    monkeypatch.setattr(Axes, 'scatter', record)
    rng = np.random.RandomState(1)
    grid = np.where(rng.rand(6, 5, 4) < 0.3, rng.randint(1, 12, (6, 5, 4)),
                    0)
    grid[0, 0, 0], grid[5, 4, 3] = 9, 250
    draws = {}
    for side, ex in (('t', port), ('j', jax_side)):
        del calls[:]
        out = ex.render_occupancy(grid, name='occ')
        assert out.endswith('occ.png') and os.path.exists(out)
        draws[side] = list(calls)
    assert len(draws['t']) == len(draws['j']) == 3
    for (ga, gc), (wa, wc) in zip(draws['t'], draws['j']):
        assert np.array_equal(ga, wa) and np.array_equal(gc, wc)
    assert port.render_occupancy(np.zeros((2, 2, 2))) is None
