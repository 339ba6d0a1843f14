"""The port's structures (`proxytransformation_torch/structures/`) against
the JAX package's, on the CPU.

The same inputs, made from a seed with numpy, go through both sides (the
JAX functions eagerly, as the package calls them; torch with two
threads). Tolerances:

- integer and boolean outputs bit for bit: `points_in_boxes` masks (also
  for points 1e-6 outside and inside a face), the mode and frame round
  trips' enums and `in_range_3d`, `box_np_ops`' masks, the IoU modes'
  comparisons with 0;
- floats within GEO_TOL · (1 + max|ref|) in float32; the exact IoU of
  `EulerBoxes.overlaps` within IOU_ATOL (an IoU lies in [0, 1]);
- `box_np_ops` is numpy on both sides (the port keeps its own copy):
  every one of its 21 functions equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proxytransformation_tpu.structures import box_np_ops as jnpops
from proxytransformation_tpu.structures import boxes as jboxes
from proxytransformation_tpu.structures import iou3d_calculator as jiou3d
from proxytransformation_tpu.structures import modes as jmodes
from proxytransformation_tpu.structures import points as jpoints
from proxytransformation_tpu.structures import projection as jproj
from proxytransformation_tpu.structures import rotation as jrot
from proxytransformation_tpu.structures import transforms as jtrans
from proxytransformation_torch.structures import box_np_ops as tnpops
from proxytransformation_torch.structures import boxes as tboxes
from proxytransformation_torch.structures import iou3d_calculator as tiou3d
from proxytransformation_torch.structures import modes as tmodes
from proxytransformation_torch.structures import points as tpoints
from proxytransformation_torch.structures import projection as tproj
from proxytransformation_torch.structures import rotation as trot
from proxytransformation_torch.structures import transforms as ttrans

GEO_TOL = 1e-6
IOU_ATOL = 1e-5


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
    if not want.size:
        return
    err = np.abs(got - want).max()
    tol = rel * (1 + np.abs(want).max())
    assert err <= tol, (what, err, tol)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def random_boxes(rng, n, angles=3):
    """(n, 9) float32 boxes: centres in ±4 m, sizes 0.2-2 m, ZXY angles
    (the first `angles` of them nonzero)."""
    b = np.zeros((n, 9), np.float32)
    b[:, :3] = rng.uniform(-4, 4, (n, 3))
    b[:, 3:6] = rng.uniform(0.2, 2.0, (n, 3))
    b[:, 6:6 + angles] = rng.uniform(-np.pi, np.pi, (n, angles))
    return b


# --------------------------------------------------------------------------
# rotation, corners, the point-in-box test
# --------------------------------------------------------------------------
@pytest.mark.parametrize('axis', [0, 1, 2, -1, -2, -3])
@pytest.mark.parametrize('batched', [True, False])
def test_rotation_3d_in_axis_matches_jax(axis, batched):
    rng = np.random.RandomState(axis + 10)
    pts = rng.uniform(-5, 5, (4, 50, 3) if batched else (50, 3)).astype(
        np.float32)
    ang = (rng.uniform(-np.pi, np.pi, 4).astype(np.float32) if batched
           else np.float32(0.7))
    got, got_m = trot.rotation_3d_in_axis(t(pts), t(np.asarray(ang)), axis,
                                          return_mat=True)
    want, want_m = jrot.rotation_3d_in_axis(jnp.asarray(pts),
                                            jnp.asarray(ang), axis,
                                            return_mat=True)
    close(got, want)
    close(got_m, want_m)


def test_rotation_3d_in_axis_refuses_a_bad_axis():
    with pytest.raises(ValueError, match='axis'):
        trot.rotation_3d_in_axis(torch.zeros(2, 3), torch.tensor(0.1), 3)


@pytest.mark.parametrize('dim', [6, 7, 9])
def test_box_corners_match_jax(dim):
    b = random_boxes(np.random.RandomState(dim), 32)[:, :dim]
    close(tboxes.box_corners(t(b)), jboxes.box_corners(jnp.asarray(b)))


def _face_points(boxes, rng, offset):
    """Points on the middle of each box face pushed `offset` (metres,
    signed: > 0 outward) along its normal, in world coordinates."""
    rot = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(boxes[:, 6:9])))
    pts = []
    for b, r in zip(boxes, rot):
        for axis in range(3):
            for sign in (-1.0, 1.0):
                local = rng.uniform(-0.3, 0.3, 3) * b[3:6]
                local[axis] = sign * (b[3 + axis] / 2 + offset)
                pts.append(b[:3] + r @ local)
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize('eps', [0.0, 0.05])
def test_points_in_boxes_matches_jax_bit_for_bit(eps):
    """Random points, and points 1e-6 m outside and inside every face:
    the same masks on both sides."""
    rng = np.random.RandomState(3)
    boxes = random_boxes(rng, 16)
    pts = np.concatenate([
        rng.uniform(-5, 5, (3000, 3)).astype(np.float32),
        _face_points(boxes, rng, 1e-6), _face_points(boxes, rng, -1e-6)])
    got = tboxes.points_in_boxes(t(pts), t(boxes), eps).numpy()
    want = np.asarray(jboxes.points_in_boxes(jnp.asarray(pts),
                                             jnp.asarray(boxes), eps))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_points_in_boxes_of_seven_dof_boxes():
    rng = np.random.RandomState(4)
    boxes = random_boxes(rng, 8, angles=1)[:, :7]
    pts = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.points_in_boxes(t(pts), t(boxes)).numpy(),
        np.asarray(jboxes.points_in_boxes(jnp.asarray(pts),
                                          jnp.asarray(boxes))))


# --------------------------------------------------------------------------
# EulerBoxes
# --------------------------------------------------------------------------
def _pair(b):
    return tboxes.EulerBoxes(b, device='cpu'), jboxes.EulerBoxes(
        jnp.asarray(b))


def test_euler_boxes_properties_and_transforms_match_jax():
    rng = np.random.RandomState(5)
    tb, jb = _pair(random_boxes(rng, 12))
    assert len(tb) == len(jb) == 12
    assert tb.tensor.dtype == torch.float32 and tb.tensor.device.type == 'cpu'
    for name in ('gravity_center', 'dims', 'corners', 'volume'):
        close(getattr(tb, name), getattr(jb, name), what=name)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = np.asarray(jrot.euler_angles_to_matrix(
        jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    mat[:3, 3] = [0.5, -1.0, 0.25]
    cases = [('transform', (mat, )), ('scale', (1.3, )),
             ('rotate', (0.4, )),
             ('rotate', (np.asarray([0.1, 0.2, -0.3], np.float32), )),
             ('rotate', (mat[:3, :3], )),
             ('flip', ('X', )), ('flip', ('Y', )), ('flip', ('Z', ))]
    for name, args in cases:
        got = getattr(tb, name)(*args)
        want = getattr(jb, name)(*args)
        assert isinstance(got, tboxes.EulerBoxes)
        assert got.tensor.device.type == 'cpu'
        close(got.tensor, want.tensor, what=(name, args))
    with pytest.raises(ValueError, match='bad rotation'):
        tb.rotate(np.zeros(2, np.float32))


def test_euler_boxes_pad_six_and_seven_dof():
    b = random_boxes(np.random.RandomState(6), 5)
    for dim in (6, 7):
        tb, jb = _pair(b[:, :dim])
        assert tuple(tb.tensor.shape) == (5, 9)
        close(tb.tensor, jb.tensor)


def test_euler_boxes_overlaps_match_jax():
    """The exact oriented IoU, every pair of 24 × 20 boxes (some identical,
    some nested, most apart)."""
    rng = np.random.RandomState(7)
    a = random_boxes(rng, 24)
    a[:, :3] *= 0.3
    b = np.concatenate([a[:6], random_boxes(rng, 14)])
    b[6:10] = a[6:10]
    b[6:10, 3:6] *= 0.5
    got = _pair(a)[0].overlaps(_pair(b)[0]).numpy()
    want = np.asarray(_pair(a)[1].overlaps(_pair(b)[1]))
    assert got.shape == (24, 20)
    assert np.abs(got - want).max() <= IOU_ATOL
    assert np.all(np.abs(np.diagonal(got[:6, :6]) - 1) <= IOU_ATOL)
    assert (got > 0).sum() > 6 and (got == 0).sum() > 0


def test_euler_boxes_default_to_the_card(monkeypatch):
    """Without a device the wrapper goes to the card, and raises when
    there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tboxes.EulerBoxes(np.zeros((1, 9), np.float32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpoints.DepthPoints(np.zeros((1, 3), np.float32))


# --------------------------------------------------------------------------
# projection
# --------------------------------------------------------------------------
@pytest.mark.parametrize('shape', [(3, 3), (3, 4), (4, 4)])
@pytest.mark.parametrize('with_depth', [False, True])
def test_batch_points_cam2img_matches_jax(shape, with_depth):
    rng = np.random.RandomState(8)
    V, N = 3, 200
    pts = rng.uniform(-2, 2, (V, N, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(0.1, 6, (V, N))
    pts[0, :4, 2] = [0.0, 5e-7, -5e-7, -2.0]   # near-zero and behind
    proj = np.zeros((V, 4, 4), np.float32)
    proj[:, 0, 0], proj[:, 1, 1] = 577.5, 578.7
    proj[:, 0, 2], proj[:, 1, 2] = 319.5, 239.5
    proj[:, 2, 2] = proj[:, 3, 3] = 1
    proj[:, :3, 3] = rng.uniform(-0.1, 0.1, (V, 3))
    proj = proj[:, :shape[0], :shape[1]]
    got = tproj.batch_points_cam2img(t(pts), t(proj), with_depth)
    want = jproj.batch_points_cam2img(jnp.asarray(pts), jnp.asarray(proj),
                                      with_depth)
    close(got, want)


def test_points_cam2img_with_a_batched_expand_matches_jax():
    rng = np.random.RandomState(9)
    pts = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    pts[:, 2] += 3
    k = np.asarray([[500, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32)
    close(tproj.points_cam2img(t(pts), t(k), True),
          jproj.points_cam2img(jnp.asarray(pts), jnp.asarray(k), True))


@pytest.mark.parametrize('shape', [(3, 3), (4, 4)])
def test_points_img2cam_matches_jax_and_inverts_the_projection(shape):
    rng = np.random.RandomState(10)
    uvd = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 480, 300),
                    rng.uniform(0.2, 8, 300)], -1).astype(np.float32)
    k = np.eye(4, dtype=np.float32)
    k[:3, :3] = [[577.5, 0, 319.5], [0, 578.7, 239.5], [0, 0, 1]]
    k = k[:shape[0], :shape[1]]
    got = tproj.points_img2cam(t(uvd), t(k))
    close(got, jproj.points_img2cam(jnp.asarray(uvd), jnp.asarray(k)))
    back = tproj.points_cam2img(got, t(k), with_depth=True)
    close(back, uvd, rel=1e-5)


# --------------------------------------------------------------------------
# modes and points
# --------------------------------------------------------------------------
MODES = list(tmodes.Box3DMode)


def test_mode_enums_equal_jax():
    for tm, jm in ((tmodes.Box3DMode, jmodes.Box3DMode),
                   (tmodes.Coord3DMode, jmodes.Coord3DMode)):
        assert [(m.name, int(m)) for m in tm] == [(m.name, int(m))
                                                  for m in jm]


@pytest.mark.parametrize('src', MODES)
@pytest.mark.parametrize('dst', MODES)
def test_convert_point_and_box_match_jax_and_round_trip(src, dst):
    rng = np.random.RandomState(11 + 3 * int(src) + int(dst))
    pts = rng.uniform(-5, 5, (64, 5)).astype(np.float32)
    boxes = random_boxes(rng, 16)
    boxes[:, 7:9] *= 0.3       # away from the ZXY gimbal lock
    got = tmodes.convert_point(t(pts), tmodes.Coord3DMode(int(src)),
                               tmodes.Coord3DMode(int(dst)))
    close(got, jmodes.convert_point(jnp.asarray(pts),
                                    jmodes.Coord3DMode(int(src)),
                                    jmodes.Coord3DMode(int(dst))))
    np.testing.assert_array_equal(got[:, 3:].numpy(), pts[:, 3:])
    back = tmodes.convert_point(got, tmodes.Coord3DMode(int(dst)),
                                tmodes.Coord3DMode(int(src)))
    close(back, pts)
    gb = tmodes.convert_box(t(boxes), src, dst)
    close(gb, jmodes.convert_box(jnp.asarray(boxes), jmodes.Box3DMode(
        int(src)), jmodes.Box3DMode(int(dst))))
    close(tboxes.box_corners(tmodes.convert_box(gb, dst, src)),
          tboxes.box_corners(t(boxes)))


@pytest.mark.parametrize('frame', ['CAMERA', 'DEPTH', 'LIDAR'])
def test_points_classes_match_jax(frame):
    rng = np.random.RandomState(12)
    raw = rng.uniform(-3, 3, (40, 4)).astype(np.float32)
    tp = tpoints.get_points_type(frame)(raw, points_dim=4, device='cpu')
    jp = jpoints.get_points_type(frame)(jnp.asarray(raw), points_dim=4)
    assert type(tp).__name__ == type(jp).__name__
    assert tp.coord_frame == jp.coord_frame == frame
    assert len(tp) == len(jp) and tuple(tp.shape) == tuple(jp.shape)
    rot = np.array(jrot.rotation_3d_in_axis(
        jnp.zeros((1, 3)), jnp.asarray([0.6], jnp.float32), 2,
        return_mat=True)[1])
    for name, args in (('translate', ([0.5, -1.0, 2.0], )),
                       ('rotate', (rot, )), ('scale', (1.7, )),
                       ('flip', ('horizontal', )), ('flip', ('vertical', )),
                       ('convert_to', ('CAMERA', )),
                       ('convert_to', ('DEPTH', )),
                       ('convert_to', ('LIDAR', ))):
        got, want = getattr(tp, name)(*args), getattr(jp, name)(*args)
        assert type(got) is type(tp) and got.coord_frame == want.coord_frame
        assert got.tensor.device.type == 'cpu'
        close(got.tensor, want.tensor, what=(name, args))
    rng_box = [-1, -1, -1, 2, 2, 2]
    np.testing.assert_array_equal(tp.in_range_3d(rng_box).numpy(),
                                  np.asarray(jp.in_range_3d(rng_box)))
    back = tp.convert_to('CAMERA' if frame != 'CAMERA' else 'LIDAR') \
        .convert_to(frame)
    close(back.tensor, raw)


# --------------------------------------------------------------------------
# IoU calculators
# --------------------------------------------------------------------------
def _aabbs(rng, n):
    lo = rng.uniform(-3, 3, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(0.1, 2, (n, 3))],
                          -1).astype(np.float32)


@pytest.mark.parametrize('mode', ['iou', 'iof', 'giou'])
def test_axis_aligned_overlaps_match_jax(mode):
    rng = np.random.RandomState(13)
    a, b = _aabbs(rng, 30), _aabbs(rng, 25)
    b[:5] = a[:5]
    got = tiou3d.axis_aligned_bbox_overlaps_3d(t(a), t(b), mode).numpy()
    want = np.asarray(jiou3d.axis_aligned_bbox_overlaps_3d(
        jnp.asarray(a), jnp.asarray(b), mode))
    close(got, want)
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize('mode', ['iou', 'giou'])
@pytest.mark.parametrize('aligned', [False, True])
def test_nearest_3d_calculator_matches_jax(mode, aligned):
    rng = np.random.RandomState(14)
    a, b = random_boxes(rng, 20, 1), random_boxes(rng, 20, 1)
    got = tiou3d.BboxOverlapsNearest3D('depth')(t(a), t(b), mode, aligned)
    want = jiou3d.BboxOverlapsNearest3D('depth')(jnp.asarray(a),
                                                 jnp.asarray(b), mode,
                                                 aligned)
    close(got, want)


# --------------------------------------------------------------------------
# box_np_ops: the port's numpy copy, all 21 functions
# --------------------------------------------------------------------------
def _np_ops_cases():
    rng = np.random.RandomState(15)
    c3, d3, yaw = (rng.uniform(-3, 3, (6, 3)), rng.uniform(0.3, 2, (6, 3)),
                   rng.uniform(-3, 3, 6))
    boxes7 = np.concatenate([c3, d3, yaw[:, None]], 1)
    pts = rng.uniform(-4, 4, (500, 3))
    corners = jnpops.center_to_corner_box3d(c3, d3, yaw)
    depth = rng.randint(0, 3, (7, 9)).astype(np.float32)
    proj = np.asarray([[600, 0, 320, 10], [0, 600, 240, 2], [0, 0, 1, 0.1],
                       [0, 0, 0, 1]], np.float64)
    rect, velo2cam = np.eye(4), np.eye(4)
    velo2cam[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    velo2cam[:3, 3] = [0.1, -0.2, 0.3]
    lidar = rng.uniform(-30, 30, (400, 4))
    rb = np.concatenate([rng.uniform(-3, 3, (8, 2)),
                         rng.uniform(0.2, 2, (8, 2)),
                         rng.uniform(-3, 3, (8, 1))], 1)
    poly = jnpops.center_to_corner_box2d(rb[:, :2], rb[:, 2:4], rb[:, 4])
    return {
        'corners_nd': (d3, ), 'rotation_2d': (rng.randn(6, 4, 2), yaw),
        'center_to_corner_box2d': (rb[:, :2], rb[:, 2:4], rb[:, 4]),
        'center_to_corner_box3d': (c3, d3, yaw, 0.5, 1),
        'points_in_convex_polygon_2d': (pts[:, :2], poly),
        'points_in_rbbox': (pts, boxes7),
        'iou_jit': (_aabbs(rng, 9)[:, [0, 1, 3, 4]] * 50,
                    _aabbs(rng, 7)[:, [0, 1, 3, 4]] * 50),
        'camera_to_lidar': (pts, rect, velo2cam),
        'box_camera_to_lidar': (boxes7, rect, velo2cam),
        'depth_to_points': (depth, 2),
        'corner_to_standup_nd': (corners, ),
        'corner_to_surfaces_3d': (corners, ),
        'surface_equ_3d': (jnpops.corner_to_surfaces_3d(corners), ),
        'points_in_convex_polygon_3d': (
            pts, jnpops.corner_to_surfaces_3d(corners)),
        'box3d_to_bbox': (boxes7 + [0, 0, 8, 0, 0, 0, 0], proj),
        'minmax_to_corner_2d': (_aabbs(rng, 5)[:, [0, 1, 3, 4]], ),
        'center_to_minmax_2d': (rb[:, :2], rb[:, 2:4], 0.3),
        'rbbox2d_to_near_bbox': (rb, ),
        'projection_matrix_to_CRT_kitti': (proj, ),
        'get_frustum': ([10, 20, 300, 200], proj[:3, :3]),
        'remove_outside_points': (lidar, rect, velo2cam, proj, (480, 640)),
    }


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize('name', sorted(_np_ops_cases()))
def test_box_np_ops_equal_jax(name):
    args = _np_ops_cases()[name]
    got, want = (_flat(getattr(m, name)(*args)) for m in (tnpops, jnpops))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_box_np_ops_has_the_21_functions_of_jax():
    names = {n for n in dir(jnpops) if callable(getattr(jnpops, n))
             and getattr(getattr(jnpops, n), '__module__', '') ==
             jnpops.__name__}
    assert len(names) == 21 and names == set(_np_ops_cases())
    assert all(callable(getattr(tnpops, n)) for n in names)


def test_points_in_rbbox_has_hits():
    args = _np_ops_cases()['points_in_rbbox']
    assert tnpops.points_in_rbbox(*args).sum() > 0


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------
@pytest.mark.parametrize('flips', [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_bbox3d_mapping_back_matches_jax(flips):
    b = random_boxes(np.random.RandomState(16), 10)
    got = ttrans.bbox3d_mapping_back(b, 1.25, *flips)
    want = jtrans.bbox3d_mapping_back(b, 1.25, *flips)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    close(got, want)


def test_bbox3d2roi_and_result_equal_jax():
    rng = np.random.RandomState(17)
    lists = [random_boxes(rng, n) for n in (3, 1, 5)]
    np.testing.assert_array_equal(ttrans.bbox3d2roi(lists),
                                  jtrans.bbox3d2roi(lists))
    np.testing.assert_array_equal(ttrans.bbox3d2roi([]),
                                  jtrans.bbox3d2roi([]))
    # a sample without boxes cannot take reshape(0, -1) on either side
    for m in (ttrans, jtrans):
        with pytest.raises(ValueError, match='reshape'):
            m.bbox3d2roi([lists[0], lists[0][:0]])
    args = (lists[0], rng.rand(3).astype(np.float32), np.arange(3),
            np.ones(3, np.int64))
    for attrs in (None, args[3]):
        got = ttrans.bbox3d2result(*args[:3], attrs)
        want = jtrans.bbox3d2result(*args[:3], attrs)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
