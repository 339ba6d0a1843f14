"""The port's visualization/ (`proxytransformation_torch/visualization/`)
against the JAX package's, on the CPU.

The same seeded numpy inputs go through both sides (the port with
`device='cpu'`, the JAX side eagerly as its own tests call it):

- box corners and wireframe segments within GEO_TOL · (1 + max|ref|)
  (float32 rotations by torch here, XLA there), `ColorMap` equal;
- `raster.line` against `cv2.line` itself, pixel for pixel, on 2000
  seeded segments at thickness 1 and 2 (all octants, lengths 0-300 px,
  endpoints inside, on the border, far outside and at the int32 limits,
  1- and 3-channel images), and an endpoint outside int32 raising on
  both sides;
- `ImgDrawer.draw_boxes` against the JAX drawer under three projections:
  equal integer endpoints and equal images; an endpoint whose JAX uv lies
  within HALF_PX of a half-integer may round the other way after a
  one-ulp corner difference, and is counted; the port's image is held
  against cv2.line at the port's own endpoints in every case;
- `LineMesh`, `export_ply`, the continuous drawers' states and the NMS
  filter equal (the back-projected clouds within one float32 ulp: the
  float64 pose product may sum in another order);
- the matplotlib render's recorded arrays within GEO_TOL, its colours
  equal, its PNG decoded to the same size and byte-equal when the arrays
  are bit-equal;
- open3d through a recording stub: the same calls with the same arrays
  (the box rotation within GEO_TOL).
"""
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from proxytransformation_tpu.visualization import base_visualizer as jbase
from proxytransformation_tpu.visualization import color_selector as jcolor
from proxytransformation_tpu.visualization import continuous_drawer as jcont
from proxytransformation_tpu.visualization import img_drawer as jimg
from proxytransformation_tpu.visualization import line_mesh as jmesh
from proxytransformation_tpu.visualization import utils as jutils
from proxytransformation_torch.data.image_io import decode_png
from proxytransformation_torch.visualization import base_visualizer as tbase
from proxytransformation_torch.visualization import color_selector as tcolor
from proxytransformation_torch.visualization import continuous_drawer as tcont
from proxytransformation_torch.visualization import img_drawer as timg
from proxytransformation_torch.visualization import line_mesh as tmesh
from proxytransformation_torch.visualization import raster
from proxytransformation_torch.visualization import utils as tutils

GEO_TOL = 1e-6
HALF_PX = 1e-3
CLASSES = ['chair', 'table', 'bed', 'sofa']


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, rel=GEO_TOL, what=''):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:
        err = np.abs(got - want).max()
        assert err <= rel * (1 + np.abs(want).max()), (what, err)


def seeded_boxes(n, seed=0, center=(0.0, 0.0, 0.0), spread=3.0):
    rng = np.random.RandomState(seed)
    return np.concatenate([
        np.asarray(center) + rng.uniform(-spread, spread, (n, 3)),
        rng.uniform(0.2, 2.0, (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 3))], 1).astype(np.float32)


# --------------------------------------------------------------------------
# corners, segments, colours
# --------------------------------------------------------------------------
@pytest.mark.parametrize('batched', [False, True], ids=['(9,)', '(N,9)'])
def test_corners_and_segments(batched):
    boxes = seeded_boxes(64)
    for b in ([boxes] if batched else list(boxes)):
        close(tutils.nine_dof_to_corners(b, 'cpu'),
              jutils.nine_dof_to_corners(b), what='corners')
        got, want = tutils.box_lines(b, 'cpu'), jutils.box_lines(b)
        assert got.dtype == want.dtype == np.float32
        close(got, want, what='segments')
    pts = boxes[:, :3]
    lines = [(0, 1), (5, 2), (3, 3)]
    for g, w in zip(tutils.line_mesh_segments(pts, lines),
                    jutils.line_mesh_segments(pts, lines)):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    # (N, 7) boxes are refused by both reshapes
    with pytest.raises(ValueError):
        jutils.nine_dof_to_corners(boxes[:2, :7])
    with pytest.raises(ValueError):
        tutils.nine_dof_to_corners(boxes[:2, :7], 'cpu')


ENTRY_POINTS = {
    'nine_dof_to_corners': lambda d: tutils.nine_dof_to_corners(
        seeded_boxes(2)),
    'box_lines': lambda d: tutils.box_lines(seeded_boxes(2)),
    'ImgDrawer': lambda d: timg.ImgDrawer(CLASSES),
    'EmbodiedScanBaseVisualizer': lambda d: tbase.EmbodiedScanBaseVisualizer(
        CLASSES, str(d / 'viz')),
    'ContinuousDrawer': lambda d: tcont.ContinuousDrawer(
        [], save_dir=str(d / 'viz')),
    'ContinuousOccupancyDrawer': lambda d: tcont.ContinuousOccupancyDrawer(
        [], save_dir=str(d / 'viz')),
    '_backproject': lambda d: tcont._backproject(
        None, np.ones((4, 4), np.uint16), np.eye(3), np.eye(4)),
}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_or_device_cpu(name, tmp_path):
    """`device=None` means the card: without one each entry point raises
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path)
    assert not (tmp_path / 'viz').exists()


def test_color_map_equal():
    tm, jm = tcolor.ColorMap(CLASSES), jcolor.ColorMap(CLASSES)
    for key in CLASSES + ['lamp', '', 'ünïcode'] + list(range(-3, 9)):
        assert tm[key] == jm[key], key
    assert tm.get_color('bed') == jm.get_color('bed')


# --------------------------------------------------------------------------
# the raster against cv2.line
# --------------------------------------------------------------------------
H, W = 48, 64
I32 = 2**31 - 1


def raster_segments(n=2000, seed=0):
    """Seeded segments: from inside the image in every octant (lengths
    0-300 px), on the border, far outside, and at the int32 limits."""
    rng = np.random.RandomState(seed)
    segs = []
    for i in range(n):
        kind = i % 5
        if kind in (0, 1):          # inside start, octant i % 8, any length
            x0, y0 = rng.randint(0, W), rng.randint(0, H)
            ang = (i % 8 + rng.uniform(0, 1)) * np.pi / 4
            length = 0.0 if i % 40 == 0 else rng.uniform(0, 300)
            seg = (x0, y0, x0 + int(round(length * np.cos(ang))),
                   y0 + int(round(length * np.sin(ang))))
        elif kind == 2:             # endpoints on the border
            def border():
                t = rng.randint(4)
                return ((rng.randint(W), 0), (rng.randint(W), H - 1),
                        (0, rng.randint(H)), (W - 1, rng.randint(H)))[t]
            seg = border() + border()
        elif kind == 3:             # far outside
            seg = tuple(rng.randint(-100000, 100000, 4))
            if i % 2:
                seg = (rng.randint(0, W), rng.randint(0, H)) + seg[2:]
        else:                       # at the int32 limits
            seg = list(rng.randint(-30, 90, 4))
            for j in rng.choice(4, rng.randint(1, 3), replace=False):
                seg[j] = rng.choice([I32, -I32, -2**31, I32 - 7])
            seg = tuple(seg)
        segs.append(tuple(int(v) for v in seg))
    return segs


def test_raster_line_equals_cv2():
    segs = raster_segments()
    octants, lengths, drawn = set(), [], 0
    for i, (x0, y0, x1, y1) in enumerate(segs):
        dx, dy = x1 - x0, y1 - y0
        if dx or dy:
            octants.add(int(np.floor(np.arctan2(dy, dx) / (np.pi / 4))) % 8)
        lengths.append(np.hypot(dx, dy))
        shape = (H, W) if i % 2 else (H, W, 3)
        color = (37, 250, 119)
        for thickness in (1, 2):
            bg = np.random.RandomState(i).randint(0, 50, shape, np.uint8)
            want = cv2.line(bg.copy(), (x0, y0), (x1, y1), color, thickness)
            got = raster.line(bg.copy(), (x0, y0), (x1, y1), color,
                              thickness)
            assert np.array_equal(got, want), (i, segs[i], thickness, shape)
            drawn += int((want != bg).any())
    assert octants == set(range(8))
    assert min(lengths) == 0 and max(lengths) > 280
    assert drawn > len(segs)           # most segments reach the image


def test_raster_line_refuses_what_cv2_refuses():
    img = np.zeros((H, W, 3), np.uint8)
    for pt in ((2**31, 5), (3, -2**31 - 1), (np.int64(2**40), 0)):
        with pytest.raises(cv2.error):
            cv2.line(img, (0, 0), pt, (255, 0, 0), 2)
        with pytest.raises(OverflowError):
            raster.line(img, (0, 0), pt, (255, 0, 0), 2)
    with pytest.raises(cv2.error):
        cv2.line(img, (0.5, 0), (3, 3), (255, 0, 0), 1)
    with pytest.raises(TypeError):
        raster.line(img, (0.5, 0), (3, 3), (255, 0, 0), 1)
    assert not img.any()


# --------------------------------------------------------------------------
# ImgDrawer
# --------------------------------------------------------------------------
def projections():
    """(name, boxes, 4x4 projection, image shape): boxes in front of the
    camera, boxes crossing its plane, boxes clipped by the image edge."""
    K = np.array([[120, 0, 80, 0], [0, 120, 60, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float64)
    c, s = np.cos(0.3), np.sin(0.3)
    pose = np.array([[c, 0, s, 0.2], [0, 1, 0, -0.1], [-s, 0, c, 0.4],
                     [0, 0, 0, 1]])
    front = seeded_boxes(32, 1, center=(0, 0, 6), spread=2.0)
    crossing = seeded_boxes(32, 2, center=(0, 0, 0.3), spread=1.5)
    edge = seeded_boxes(32, 3, center=(0, 0, 3), spread=3.0)
    return [('front', front, K, (120, 160, 3)),
            ('crossing', crossing, K @ pose, (120, 160, 3)),
            ('edge', edge, K @ np.linalg.inv(pose), (96, 128, 3))]


def drawn_endpoints(corners, proj_mat):
    """The JAX drawer's edge endpoints: {(m, a, b): (pa, pb)}, and the
    float uv of each."""
    ones = np.ones((*corners.shape[:2], 1), np.float32)
    proj = np.concatenate([corners, ones], -1) @ np.asarray(
        proj_mat, np.float32).T
    depth = proj[..., 2]
    uv = proj[..., :2] / np.clip(depth[..., None], 1e-6, None)
    out = {}
    for m in range(len(corners)):
        for a, b in jutils._EDGES:
            if depth[m, a] > 0 and depth[m, b] > 0:
                out[m, a, b] = (tuple(np.round(uv[m, a]).astype(int)),
                                tuple(np.round(uv[m, b]).astype(int)))
    return out, uv


@pytest.mark.parametrize('case', range(3), ids=['front', 'crossing', 'edge'])
def test_draw_boxes_equals_jax_drawer(case):
    name, boxes, proj, shape = projections()[case]
    proj = proj.astype(np.float32)
    labels = np.arange(32) % 6 - 1         # -1 and 4, 5: outside CLASSES
    img = np.random.RandomState(case).randint(0, 255, shape, np.uint8)
    want = jimg.ImgDrawer(CLASSES).draw_boxes(img, boxes, proj, labels)
    drawer = timg.ImgDrawer(CLASSES, device='cpu')
    got = drawer.draw_boxes(img, boxes, proj, labels)
    assert got.dtype == np.uint8 and not np.shares_memory(got, img)

    jend, juv = drawn_endpoints(jutils.nine_dof_to_corners(boxes), proj)
    tend, _ = drawn_endpoints(tutils.nine_dof_to_corners(boxes, 'cpu'), proj)
    assert set(tend) == set(jend), name
    near_half = np.abs(np.abs(juv - np.floor(juv)) - 0.5) < HALF_PX
    rounded_apart = [k for k in jend if tend[k] != jend[k]]
    for m, a, b in rounded_apart:
        assert near_half[m, [a, b]].any(), (name, m, a, b)
    print(f'[{name}] {len(jend)} edges drawn, {int(near_half.sum())} '
          f'corners within {HALF_PX} px of a half-integer, '
          f'{len(rounded_apart)} edges rounded apart')
    # the port's image is cv2.line at the port's endpoints
    ref = np.ascontiguousarray(img.copy())
    for (m, a, b), (pa, pb) in sorted(tend.items()):
        col = tuple(int(c) for c in np.array(drawer.colors[int(labels[m])])
                    * 255)
        cv2.line(ref, pa, pb, col, 2)
    assert np.array_equal(got, ref), name
    if not rounded_apart:
        assert np.array_equal(got, want), name
    assert (got != img).any(), name


def test_draw_boxes_without_labels_and_draw_text_refused():
    boxes = seeded_boxes(4, 5, center=(0, 0, 4), spread=1.0)
    proj = projections()[0][2].astype(np.float32)
    img = np.zeros((120, 160, 3), np.uint8)
    got = timg.ImgDrawer(device='cpu').draw_boxes(img, boxes, proj,
                                                  thickness=1)
    want = jimg.ImgDrawer().draw_boxes(img, boxes, proj, thickness=1)
    assert np.array_equal(got, want)
    with pytest.raises(NotImplementedError, match='Hershey simplex'):
        timg.ImgDrawer(device='cpu').draw_text(img, 'chair')


# --------------------------------------------------------------------------
# LineMesh, PLY, NMS
# --------------------------------------------------------------------------
def test_line_mesh_equal(tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-2, 2, (7, 3)).astype(np.float32)
    pts[4] = pts[3]                             # a zero-length segment
    pts[6] = pts[5] + np.float32([0, 0, 1.5])   # parallel to +z
    lines = [[0, 1], [3, 4], [2, 5], [5, 6], [6, 5], [1, 0]]
    colors = rng.uniform(-0.2, 1.2, (len(lines), 3))
    for kw in ({}, {'lines': lines, 'colors': colors, 'radius': 0.05,
                    'sides': 6}):
        got, want = tmesh.LineMesh(pts, **kw), jmesh.LineMesh(pts, **kw)
        for attr in ('vertices', 'triangles', 'vertex_colors'):
            g, w = getattr(got, attr), getattr(want, attr)
            assert g.dtype == w.dtype and np.array_equal(g, w), attr
        got.save_ply(str(tmp_path / 'port.ply'))
        want.save_ply(str(tmp_path / 'jax.ply'))
        assert ((tmp_path / 'port.ply').read_bytes()
                == (tmp_path / 'jax.ply').read_bytes())
    empty = tmesh.LineMesh(pts[:2] * 0)
    assert empty.vertices.shape == (0, 3)


def test_export_ply_equal(tmp_path):
    rng = np.random.RandomState(5)
    xyz = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    rgb = rng.randint(0, 256, (300, 3)).astype(np.float32)
    tv = tbase.EmbodiedScanBaseVisualizer(CLASSES, str(tmp_path / 't'),
                                          device='cpu')
    jv = jbase.EmbodiedScanBaseVisualizer(CLASSES, str(tmp_path / 'j'))
    for name, pts in (('xyz', xyz), ('xyzrgb', np.concatenate([xyz, rgb],
                                                             1))):
        got, want = tv.export_ply(pts, name), jv.export_ply(pts, name)
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, 'rb').read() == open(want, 'rb').read()


def test_nms_filter_equal(tmp_path):
    rng = np.random.RandomState(6)
    centers = rng.uniform(-4, 4, (16, 3))
    boxes = np.concatenate([
        np.repeat(centers, 8, 0) + rng.normal(0, 0.15, (128, 3)),
        rng.uniform(0.5, 1.5, (128, 3)),
        rng.uniform(-0.4, 0.4, (128, 3))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, 128).astype(np.float32)
    tv = tbase.EmbodiedScanBaseVisualizer(save_dir=str(tmp_path / 't'),
                                          device='cpu')
    jv = jbase.EmbodiedScanBaseVisualizer(save_dir=str(tmp_path / 'j'))
    got = tv._nms_filter(boxes, scores, 0.15)
    want = jv._nms_filter(boxes, scores, 0.15)
    assert 16 <= len(want) < 100        # clusters were suppressed
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tv._nms_filter(boxes, None, 0.15) is boxes
    assert tv._nms_filter(boxes[:0], scores[:0], 0.15).shape == (0, 9)


# --------------------------------------------------------------------------
# the matplotlib render
# --------------------------------------------------------------------------
@pytest.fixture
def recorded_axes(monkeypatch):
    """Record every Axes.scatter / Axes.plot call: (kind, arrays,
    colour) in order."""
    from matplotlib.axes import Axes
    calls = []
    scatter, plot = Axes.scatter, Axes.plot

    def rec_scatter(self, x, y, *a, **kw):
        c = kw.get('c')
        calls.append(('scatter', np.stack([x, y]),
                      c if isinstance(c, str) else np.asarray(c)))
        return scatter(self, x, y, *a, **kw)

    def rec_plot(self, x, y, *a, **kw):
        calls.append(('plot', np.asarray([x, y]), kw.get('c')))
        return plot(self, x, y, *a, **kw)

    monkeypatch.setattr(Axes, 'scatter', rec_scatter)
    monkeypatch.setattr(Axes, 'plot', rec_plot)
    return calls


def same_draws(got, want):
    """Recorded draws: the same kinds and colours, arrays within GEO_TOL;
    True when the arrays are bit-equal too."""
    assert [c[0] for c in got] == [c[0] for c in want]
    exact = True
    for (_, ga, gc), (_, wa, wc) in zip(got, want):
        close(ga, wa, what='draw arrays')
        exact &= bool(np.array_equal(ga, wa))
        if isinstance(wc, np.ndarray):
            assert np.array_equal(gc, wc)
        else:
            assert gc == wc
    return exact


def test_matplotlib_render_equal(tmp_path, recorded_axes):
    rng = np.random.RandomState(7)
    pts = np.concatenate([rng.uniform(0, 4, (2000, 3)),
                          rng.randint(0, 256, (2000, 3))], 1)
    boxes = np.array([[1, 1, 1, 0.5, 0.5, 0.5, 0.3, 0, 0],
                      [1.05, 1, 1, 0.5, 0.5, 0.5, 0.3, 0, 0],
                      [3, 3, 1, 0.8, 0.4, 0.6, 0, 0.2, 0.1]], np.float32)
    labels, scores = np.array([0, 0, 3]), np.array([0.9, 0.8, 0.7])
    outs, draws = {}, {}
    for side, cls, kw in (('jax', jbase.EmbodiedScanBaseVisualizer, {}),
                          ('port', tbase.EmbodiedScanBaseVisualizer,
                           {'device': 'cpu'})):
        viz = cls(CLASSES, save_dir=str(tmp_path / side), **kw)
        del recorded_axes[:]
        outs[side] = viz.visualize_scene(pts, boxes, labels, scores,
                                         name='scene')
        draws[side] = list(recorded_axes)
    assert (os.path.relpath(outs['port'], tmp_path / 'port')
            == os.path.relpath(outs['jax'], tmp_path / 'jax') == 'scene.png')
    assert len(draws['jax']) == 3 * (1 + 2 * 12)   # NMS dropped one box
    exact = same_draws(draws['port'], draws['jax'])
    png = {k: open(v, 'rb').read() for k, v in outs.items()}
    assert decode_png(png['port']).shape == decode_png(png['jax']).shape
    if exact:
        assert png['port'] == png['jax']


# --------------------------------------------------------------------------
# the continuous drawers
# --------------------------------------------------------------------------
def rgbd_views(seed=8):
    rng = np.random.RandomState(seed)
    h, w = 48, 64
    views = []
    for i in range(3):
        depth = rng.randint(0, 14000, (h, w)).astype(np.uint16)
        depth[rng.rand(h, w) < 0.1] = 0
        c, s = np.cos(0.4 * i + 0.1), np.sin(0.4 * i + 0.1)
        pose = np.array([[c, -s, 0, 0.3 * i], [s, c, 0.1, -0.2],
                         [0, -0.1, 1, 1.1], [0, 0, 0, 1]], np.float64)
        img = (None, rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
               rng.uniform(0, 1, (h, w, 3)))[i]
        view = {'depth': depth, 'img': img, 'cam2global': pose,
                'intrinsic': np.array([[52.5, 0, 31.7, 0],
                                       [0, 51.2, 23.9, 0], [0, 0, 1, 0],
                                       [0, 0, 0, 1]])[:3 + i % 2, :3 + i % 2],
                'visible_instance_ids': [i, i + 1][:1 + i % 2]}
        if i == 1:
            view['depth_shift'] = 4000.0
            del view['visible_instance_ids']
        views.append(view)
    return views


def ulps_apart(got, want):
    """The largest |got - want| in float32 steps of the larger value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if not want.size:
        return 0.0
    step = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got.astype(np.float64) - want) / step).max())


def test_continuous_drawer_states_equal(tmp_path):
    boxes = seeded_boxes(4, 9, center=(0, 0, 2), spread=1.0)
    labels = [0, 2, 1, 3]
    kw = dict(boxes=boxes, labels=labels, classes=CLASSES)
    jd = jcont.ContinuousDrawer(rgbd_views(), save_dir=str(tmp_path / 'j'),
                                **kw)
    td = tcont.ContinuousDrawer(rgbd_views(), save_dir=str(tmp_path / 't'),
                                device='cpu', **kw)
    while True:
        want, got = jd.step(), td.step()
        if want is None:
            assert got is None
            break
        assert got['points'].dtype == want['points'].dtype == np.float32
        assert got['points'].shape == want['points'].shape
        assert ulps_apart(got['points'], want['points']) <= 1
        assert got['view_index'] == want['view_index']
        for k in ('boxes', 'labels'):
            assert (got[k] is None) == (want[k] is None)
            if want[k] is not None:
                assert np.array_equal(got[k], want[k]), k
    # a view without valid depth and an image: both raise
    view = dict(rgbd_views()[1], depth=np.zeros((48, 64), np.uint16))
    with pytest.raises(ValueError):
        jcont._backproject(view['img'], view['depth'],
                           np.eye(3, dtype=np.float32),
                           np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError):
        tcont._backproject(view['img'], view['depth'],
                           np.eye(3, dtype=np.float32),
                           np.eye(4, dtype=np.float32), device='cpu')


def test_continuous_drawer_run_headless_equal(tmp_path):
    outs = {}
    for side, cls, kw in (('j', jcont.ContinuousDrawer, {}),
                          ('t', tcont.ContinuousDrawer, {'device': 'cpu'})):
        d = cls(rgbd_views(), boxes=seeded_boxes(4, 9, (0, 0, 2), 1.0),
                labels=[0, 1, 2, 3], classes=CLASSES,
                save_dir=str(tmp_path / side), downsample=3, **kw)
        outs[side] = [os.path.relpath(p, tmp_path / side)
                      for p in d.run_headless('scan')]
        assert all(os.path.exists(tmp_path / side / p) for p in outs[side])
    assert outs['t'] == outs['j'] == [f'scan_{i:04d}.png' for i in range(3)]


def test_continuous_occupancy_drawer_states_equal(tmp_path):
    rng = np.random.RandomState(10)
    views = [{'occupancy': np.concatenate([rng.randint(0, 6, (20, 3)),
                                           rng.randint(0, 9, (20, 1))], 1)}
             for _ in range(3)] + [{'occupancy': np.zeros((0, 4))}]
    kw = dict(voxel_size=0.2, origin=(-1.0, 0.5, 0.0), classes=CLASSES)
    jd = jcont.ContinuousOccupancyDrawer(views, save_dir=str(tmp_path / 'j'),
                                         **kw)
    td = tcont.ContinuousOccupancyDrawer(views, save_dir=str(tmp_path / 't'),
                                         device='cpu', **kw)
    while (want := jd.step()) is not None:
        got = td.step()
        for k in ('points', 'labels'):
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        assert got['boxes'] is want['boxes'] is None
        assert got['view_index'] == want['view_index']
    assert td.step() is None
    empty = tcont.ContinuousOccupancyDrawer(views[3:], save_dir=str(
        tmp_path / 'e'), device='cpu').step()
    assert empty['points'].dtype == np.float32 and len(empty['points']) == 0


# --------------------------------------------------------------------------
# open3d through a recording stub
# --------------------------------------------------------------------------
def open3d_stub(calls):
    """A module standing in for open3d that records what it is given."""

    class Geometry:
        def __init__(self, kind, *args):
            object.__setattr__(self, 'kind', kind)
            calls.append((kind, args))

        def __setattr__(self, key, value):
            calls.append((f'{self.kind}.{key}', (value, )))
            object.__setattr__(self, key, value)

        def __getattr__(self, key):
            return lambda *a: calls.append((f'{self.kind}.{key}()', a))

    class Window(Geometry):
        def register_key_callback(self, key, fn):
            calls.append(('register_key_callback', (key, )))
            object.__setattr__(self, 'fn', fn)

        def close(self):
            calls.append(('close', ()))

        def run(self):
            while self.fn(self):
                pass

    def kind(name):
        return lambda *a: Geometry(name, *a)

    o3d = types.ModuleType('open3d')
    o3d.geometry = types.SimpleNamespace(
        OrientedBoundingBox=kind('OrientedBoundingBox'),
        TriangleMesh=kind('TriangleMesh'), PointCloud=kind('PointCloud'),
        LineSet=kind('LineSet'))
    o3d.utility = types.SimpleNamespace(**{
        n: (lambda n: lambda a: (n, np.asarray(a)))(n)
        for n in ('Vector3dVector', 'Vector3iVector', 'Vector2iVector')})
    o3d.visualization = types.SimpleNamespace(
        draw_geometries=lambda g: calls.append(('draw_geometries',
                                                (len(g), ))),
        VisualizerWithKeyCallback=lambda: Window('Window'))
    o3d.io = types.SimpleNamespace(
        write_point_cloud=lambda path, pcd: calls.append(
            ('write_point_cloud', (os.path.basename(path), ))))
    return o3d


def flatten(obj):
    """The arrays and values inside nested call arguments."""
    if isinstance(obj, (tuple, list)):
        return [v for o in obj for v in flatten(o)]
    if hasattr(obj, 'kind'):
        return [obj.kind]
    return [obj]


def same_calls(got, want):
    """The same calls; a box's rotation and corners within GEO_TOL, a
    back-projected float32 cloud within one ulp, the rest equal."""
    assert [c[0] for c in got] == [c[0] for c in want]
    for (kind, ga), (_, wa) in zip(got, want):
        for g, w in zip(flatten(ga), flatten(wa), strict=True):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.shape == w.shape, kind
                if kind in ('OrientedBoundingBox', 'LineSet.points'):
                    close(g, w, what=kind)
                elif kind.startswith('PointCloud') and w.dtype == np.float32:
                    assert ulps_apart(g, w) <= 1, kind
                else:
                    assert np.array_equal(g, w), kind
            else:
                assert g == w, kind


def test_open3d_calls_equal(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, 'open3d', open3d_stub(calls))
    boxes = seeded_boxes(3, 11, center=(1, 1, 1), spread=2.0)
    pts = np.concatenate([np.random.RandomState(11).uniform(0, 3, (50, 3)),
                          np.full((50, 3), 128.0)], 1)
    mesh_pts = boxes[:, :3].copy()
    recorded = {}
    for side, utils, mesh, base, cont, kw in (
            ('j', jutils, jmesh, jbase, jcont, {}),
            ('t', tutils, tmesh, tbase, tcont, {'device': 'cpu'})):
        del calls[:]
        utils.to_open3d_box(boxes[0], (0.2, 0.4, 0.6), **kw)
        mesh.LineMesh(mesh_pts, colors=(1.0, 0.0, 0.5)).to_open3d()
        viz = base.EmbodiedScanBaseVisualizer(
            CLASSES, str(tmp_path / side), **kw)
        out = viz.visualize_scene(pts, boxes, [0, 1, 2], [0.9, 0.5, 0.7],
                                  name='scene', show=True)
        assert os.path.relpath(out, tmp_path / side) == 'scene.ply'
        d = cont.ContinuousDrawer(rgbd_views()[1:], boxes=boxes,
                                  labels=[0, 1, 2], classes=CLASSES,
                                  save_dir=str(tmp_path / side), **kw)
        d.run_interactive()
        recorded[side] = list(calls)
    kinds = [c[0] for c in recorded['j']]
    assert kinds.count('OrientedBoundingBox') == 4    # NMS kept three
    assert kinds.count('close') == 1 and 'LineSet' in kinds
    same_calls(recorded['t'], recorded['j'])
