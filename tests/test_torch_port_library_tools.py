"""The port's raw-data readers, utilities, PNG encoder and offline scorer
against the JAX package's, on the CPU.

- `converter/scannet_sens.py`: a fake version-4 `.sens` file (the layout
  of tests/test_secondary.py::_write_fake_sens, copied: cv2's JPEGs,
  zlib depth) read by both `SensReader`s: the header and every frame's
  pose, JPEG bytes and depth array equal; `extract_scannet_images` on
  both sides: the same files, the JPEGs, poses and intrinsics byte-equal
  and the depth PNGs equal as pixels (decoded by cv2 and by the port's
  decoder; the port writes them with its own encoder, the JAX package
  with cv2);
- `converter/rscan.py`: `extract_3rscan_images` (in a spawned pool of
  two and in one process) and `main` extract the same trees as the JAX
  function from zips made here;
- `data/image_io.py::write_png`: 16-bit and 8-bit gray and BGR images
  back through the port's decoder and cv2, pixel for pixel;
- `utils/timing.py::chained_ms_per_iter`: a positive finite figure on
  the CPU, each chain rerun from `init_state` without `donate` and from
  the last output with it; `utils/cache.py` keyed like the JAX one;
- `tools/eval_script.py` prints what the root tools/eval_script.py
  prints on the same pair of files.
"""
import contextlib
import io
import json
import os
import runpy
import struct
import sys
import zipfile
import zlib
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from proxytransformation_tpu.converter import rscan as jrscan
from proxytransformation_tpu.converter import scannet_sens as jsens
from proxytransformation_tpu.utils import cache as jcache
from proxytransformation_torch.converter import rscan as trscan
from proxytransformation_torch.converter import scannet_sens as tsens
from proxytransformation_torch.data import image_io
from proxytransformation_torch.tools import eval_script as teval_script
from proxytransformation_torch.utils import cache as tcache
from proxytransformation_torch.utils.timing import chained_ms_per_iter

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_fake_sens(path, n_frames=3):
    """tests/test_secondary.py::_write_fake_sens: a version-4 .sens file
    of `n_frames` 8x6 frames (cv2's JPEG colour, zlib ushort depth)."""
    with open(path, 'wb') as f:
        f.write(struct.pack('I', 4))
        name = b'fake'
        f.write(struct.pack('Q', len(name)))
        f.write(name)
        for _ in range(4):
            f.write(struct.pack('f' * 16, *np.eye(4).ravel()))
        f.write(struct.pack('i', 2))  # jpeg
        f.write(struct.pack('i', 1))  # zlib_ushort
        f.write(struct.pack('I', 8))   # color w
        f.write(struct.pack('I', 6))   # color h
        f.write(struct.pack('I', 8))   # depth w
        f.write(struct.pack('I', 6))   # depth h
        f.write(struct.pack('f', 1000.0))
        f.write(struct.pack('Q', n_frames))
        rng = np.random.RandomState(0)
        for i in range(n_frames):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = i
            f.write(struct.pack('f' * 16, *pose.ravel()))
            f.write(struct.pack('Q', i))
            f.write(struct.pack('Q', i))
            img = rng.randint(0, 255, (6, 8, 3), np.uint8)
            ok, jpg = cv2.imencode('.jpg', img)
            depth = (rng.randint(0, 5000, (6, 8))).astype(np.uint16)
            dz = zlib.compress(depth.tobytes())
            f.write(struct.pack('Q', len(jpg.tobytes())))
            f.write(struct.pack('Q', len(dz)))
            f.write(jpg.tobytes())
            f.write(dz)
    return path


# --------------------------------------------------------------------------
# the .sens reader
# --------------------------------------------------------------------------
HEADER = ('sensor_name', 'intrinsic_color', 'extrinsic_color',
          'intrinsic_depth', 'extrinsic_depth', 'color_compression',
          'depth_compression', 'color_width', 'color_height', 'depth_width',
          'depth_height', 'depth_shift', 'num_frames')


def test_sens_reader_equals_jax(tmp_path):
    path = _write_fake_sens(str(tmp_path / 'scene.sens'), n_frames=4)
    got, want = tsens.SensReader(path), jsens.SensReader(path)
    for k in HEADER:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    frames = list(zip(got.frames(), want.frames()))
    assert len(frames) == 4
    for (gp, gc, gd), (wp, wc, wd) in frames:
        np.testing.assert_array_equal(gp, wp)
        assert gc == wc and gc.startswith(b'\xff\xd8')
        assert gd.dtype == wd.dtype == np.uint16
        np.testing.assert_array_equal(gd, wd)


def test_sens_reader_refuses_another_version(tmp_path):
    path = tmp_path / 'v3.sens'
    data = bytearray(Path(_write_fake_sens(str(path))).read_bytes())
    data[:4] = struct.pack('I', 3)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match='version 3'):
        tsens.SensReader(str(path))


@pytest.mark.parametrize('skip,limit', [(1, None), (2, 1)])
def test_extract_scannet_images_equals_jax(tmp_path, skip, limit):
    path = _write_fake_sens(str(tmp_path / 'scene.sens'), n_frames=5)
    n_got = tsens.extract_scannet_images(path, str(tmp_path / 'port'),
                                         skip, limit)
    n_want = jsens.extract_scannet_images(path, str(tmp_path / 'jax'),
                                          skip, limit)
    assert n_got == n_want == (5 if limit is None else 1)
    files = sorted(p.relative_to(tmp_path / 'jax')
                   for p in (tmp_path / 'jax').rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / 'port')
                           for p in (tmp_path / 'port').rglob('*')
                           if p.is_file())
    assert sum(f.parts[0] == 'depth' for f in files) == n_want
    for f in files:
        got, want = tmp_path / 'port' / f, tmp_path / 'jax' / f
        if f.suffix == '.png':
            ref = cv2.imread(str(want), cv2.IMREAD_UNCHANGED)
            assert ref.dtype == np.uint16
            for decoded in (cv2.imread(str(got), cv2.IMREAD_UNCHANGED),
                            image_io.imread(str(got), -1),
                            image_io.imread(str(want), -1)):
                np.testing.assert_array_equal(decoded, ref)
        else:
            assert got.read_bytes() == want.read_bytes(), f


# --------------------------------------------------------------------------
# 3RScan
# --------------------------------------------------------------------------
def _rscan_tree(root, rng):
    for k in range(3):
        scene = root / f'scene-{k}'
        scene.mkdir(parents=True)
        with zipfile.ZipFile(scene / 'sequence.zip', 'w') as zf:
            for i in range(2):
                zf.writestr(f'frame-{i:06d}.color.jpg',
                            rng.bytes(int(rng.randint(10, 200))))
                zf.writestr(f'frame-{i:06d}.pose.txt',
                            ' '.join(map(str, rng.rand(16))))
    (root / 'scene-nozip').mkdir()


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def test_extract_3rscan_images_equals_jax(tmp_path, monkeypatch, capsys):
    roots = {}
    for side in ('jax', 'port_pool', 'port_one', 'port_main'):
        roots[side] = tmp_path / side
        _rscan_tree(roots[side], np.random.RandomState(0))
    want = jrscan.extract_3rscan_images(str(roots['jax']), nproc=1)
    pool = trscan.extract_3rscan_images(str(roots['port_pool']), nproc=2)
    one = trscan.extract_3rscan_images(str(roots['port_one']), nproc=1)
    assert len(want) == 3
    for side, got in (('port_pool', pool), ('port_one', one)):
        assert [Path(p).relative_to(roots[side]) for p in got] == [
            Path(p).relative_to(roots['jax']) for p in want]
        assert _tree(roots[side]) == _tree(roots['jax'])
    monkeypatch.setattr(sys, 'argv', ['rscan', '--dataset_folder',
                                      str(roots['port_main']), '--nproc',
                                      '1'])
    trscan.main()
    assert capsys.readouterr().out.strip() == 'extracted 3 scenes'
    assert _tree(roots['port_main']) == _tree(roots['jax'])


# --------------------------------------------------------------------------
# the PNG encoder
# --------------------------------------------------------------------------
@pytest.mark.parametrize('kind', ['u16', 'u8', 'bgr'])
def test_write_png_round_trips_through_both_decoders(tmp_path, kind):
    rng = np.random.RandomState(1)
    img = {'u16': rng.randint(0, 65536, (31, 17)).astype(np.uint16),
           'u8': rng.randint(0, 256, (9, 40)).astype(np.uint8),
           'bgr': rng.randint(0, 256, (12, 7, 3)).astype(np.uint8)}[kind]
    path = tmp_path / 'x.png'
    image_io.write_png(path, img)
    for decoded in (image_io.imread(str(path), -1),
                    cv2.imread(str(path), cv2.IMREAD_UNCHANGED)):
        assert decoded.dtype == img.dtype
        np.testing.assert_array_equal(decoded, img)


def test_write_png_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError, match='uint8'):
            image_io.write_png(tmp_path / 'bad.png', bad)


# --------------------------------------------------------------------------
# timing and cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize('donate', [False, True])
def test_chained_ms_per_iter_on_the_cpu(donate):
    """Each chain's first input: `init_state` every time without
    `donate`, the previous chain's output with it."""
    firsts = []
    w = torch.randn(64, 64) / 8

    def step(i, state):
        if i == 0:
            firsts.append(int(state['n']))
        return {'x': torch.tanh(state['x'] @ w), 'n': state['n'] + 1}

    init = {'x': torch.randn(16, 64), 'n': torch.tensor(0)}
    ms = chained_ms_per_iter(step, init, n_short=2, n_long=5, donate=donate)
    assert np.isfinite(ms) and ms > 0
    # a warmup and two timed chains of 2, then of 5 steps
    assert len(firsts) == 6
    if donate:
        assert firsts == [0, 2, 4, 6, 11, 16]
    else:
        assert firsts == [0, 0, 0, 2, 0, 0]


def test_machine_keyed_cache_dir_is_keyed_like_jax():
    want = jcache.machine_keyed_cache_dir('some_prefix')
    got = tcache.machine_keyed_cache_dir('some_prefix')
    assert want.endswith('_' + jax.__version__)
    assert got == want[:-len(jax.__version__)] + torch.__version__
    assert tcache.machine_keyed_cache_dir().startswith(
        os.path.expanduser('~/.cache/pt_torch_cpu_v2_'))


# --------------------------------------------------------------------------
# the offline scorer
# --------------------------------------------------------------------------
def _scorer_files(tmp_path):
    rng = np.random.RandomState(3)
    results, gt = [], []
    for i in range(8):
        boxes = np.concatenate([
            rng.uniform(-1, 1, (12, 3)), rng.uniform(0.4, 1.2, (12, 3)),
            rng.uniform(-1, 1, (12, 3))], -1).astype(np.float32)
        scores = rng.rand(12).astype(np.float32)
        g = boxes[np.argmax(scores)][None] + rng.uniform(
            -0.05, 0.05, (1, 9)).astype(np.float32)
        if i % 3 == 2:   # a target no prediction finds
            g[0, :3] += 5
        results.append({'bboxes_3d': boxes.tolist(),
                        'scores_3d': scores.tolist()})
        gt.append({'gt_bboxes_3d': g.tolist(), 'is_hard': bool(i % 2),
                   'is_view_dep': bool(i % 3 == 0),
                   'is_unique': bool(i % 4 == 0)})
    r, g = tmp_path / 'results.json', tmp_path / 'gt.json'
    r.write_text(json.dumps(results))
    g.write_text(json.dumps(gt))
    return str(r), str(g)


@pytest.mark.parametrize('top_k', [None, 3])
def test_eval_script_prints_what_the_root_script_prints(tmp_path,
                                                        monkeypatch, top_k):
    files = _scorer_files(tmp_path)
    extra = [] if top_k is None else ['--top-k', str(top_k)]
    out = io.StringIO()
    monkeypatch.setattr(sys, 'argv', ['eval_script.py', *files, *extra])
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / 'tools/eval_script.py'),
                       run_name='__main__')
    want = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        teval_script.main([*files, *extra])
    assert out.getvalue() == want
    # the summary table's lines, then the JSON of the scores
    scores = json.loads(want[want.index('{'):])
    assert 0 < scores['Overall@0.25'] < 1
