"""The port's image decoders and resize against cv2, byte for byte.

`proxytransformation_torch.data.image_io` (host C++ JPEG decoder, PNG
through zlib and a C++ unfilter) must give the arrays `cv2.imread` /
`cv2.imdecode` give, and `data.resize.resize_bilinear_u8` the bytes of
`cv2.resize(..., INTER_LINEAR)`: the JAX package reads and resizes its
views with cv2, and the port's batches must equal its batches. Fixtures:
`tests/torch_port_images/` (written by
`proxytransformation_torch/tools/make_image_fixtures.py`), plus images
these tests encode with cv2 or write by hand.
"""
import hashlib
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from proxytransformation_torch.data import image_io
from proxytransformation_torch.data.resize import resize_bilinear_u8
from proxytransformation_torch.tools.make_image_fixtures import png_bytes

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / 'tests' / 'torch_port_images'
MANIFEST = json.loads((FIXTURES / 'manifest.json').read_text())
FLAGS = {'IMREAD_COLOR': cv2.IMREAD_COLOR,
         'IMREAD_UNCHANGED': cv2.IMREAD_UNCHANGED}


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def assert_same(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    diff = np.flatnonzero(got != want)
    assert diff.size == 0, f'{diff.size} values differ, first at {diff[:5]}'


def textured(h, w, seed, channels=3):
    """Gradients with noise: JPEG blocks with many AC coefficients."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x * 3 + y) % 64 * 4], -1) + rng.normal(0, 25, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


# --------------------------------------------------------------------------
# the committed fixtures
# --------------------------------------------------------------------------
@pytest.mark.parametrize('entry', MANIFEST['files'],
                         ids=[f['name'] for f in MANIFEST['files']])
def test_fixture_decodes_to_manifest_and_cv2(entry):
    path = str(FIXTURES / entry['name'])
    flag = FLAGS[entry['flags']]
    want = cv2.imread(path, flag)
    # the manifest holds cv2's digest (a fixture regenerated by another
    # OpenCV would show here first)
    assert digest(want) == entry['sha256']
    assert list(want.shape) == entry['shape']
    got = image_io.imread(path, flag)
    assert_same(got, want)
    assert digest(got) == entry['sha256']


def test_fixture_budget_and_views():
    """The fixtures stay small, and the two RGB-D views are full-size."""
    total = sum((FIXTURES / f['name']).stat().st_size
                for f in MANIFEST['files'])
    assert total < 1.5e6, total
    shapes = {f['name']: (f['shape'], f['dtype']) for f in MANIFEST['files']}
    for i in range(2):
        assert shapes[f'view{i}_640x480.jpg'] == ([480, 640, 3], 'uint8')
        assert shapes[f'depth{i}_640x480.png'] == ([480, 640], 'uint16')


# --------------------------------------------------------------------------
# JPEGs encoded here
# --------------------------------------------------------------------------
SAMPLING = {'420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# sizes around the edge cases: one sample, components two samples wide
# (box upsampling), partial MCUs at the right and bottom edges
SIZES = ((1, 1), (2, 2), (3, 3), (2, 5), (5, 2), (7, 9), (16, 16),
         (17, 33), (1, 17), (9, 1), (97, 131))


@pytest.mark.parametrize('rst', [0, 3])
@pytest.mark.parametrize('quality', [50, 95, 100])
@pytest.mark.parametrize('sampling', sorted(SAMPLING))
def test_jpeg_matches_cv2(sampling, quality, rst):
    for i, (h, w) in enumerate(SIZES):
        img = textured(h, w, seed=i)
        ok, enc = cv2.imencode('.jpg', img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
            cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        assert ok
        assert_same(image_io.decode(enc.tobytes(), cv2.IMREAD_COLOR),
                    cv2.imdecode(enc, cv2.IMREAD_COLOR))


@pytest.mark.parametrize('flag', [cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED])
def test_jpeg_gray_and_color_match_cv2_under_each_flag(flag):
    for i, (h, w) in enumerate(SIZES):
        for img in (textured(h, w, i, channels=1), textured(h, w, i)):
            ok, enc = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY,
                                                 90])
            assert_same(image_io.decode(enc.tobytes(), flag),
                        cv2.imdecode(enc, flag))


def test_format_by_magic_bytes(tmp_path):
    ok, enc = cv2.imencode('.jpg', textured(24, 40, 3))
    path = tmp_path / 'view.png'     # a JPEG under a PNG name
    path.write_bytes(enc.tobytes())
    assert_same(image_io.imread(str(path)), cv2.imread(str(path)))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / 'missing.jpg'))
    with pytest.raises(ValueError, match='IMREAD_COLOR'):
        image_io.imread(str(path), cv2.IMREAD_GRAYSCALE)
    path.write_bytes(b'GIF89a' + bytes(20))
    with pytest.raises(ValueError, match='unknown image format'):
        image_io.imread(str(path))


def _exif_tiff(orientation: int) -> bytes:
    """A big-endian TIFF block holding one tag: the orientation."""
    return (b'MM\x00\x2a' + struct.pack('>I', 8) + struct.pack('>H', 1)
            + struct.pack('>HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack('>I', 0))


def _with_exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """A JPEG with an APP1 EXIF block holding the orientation tag."""
    payload = b'Exif\x00\x00' + _exif_tiff(orientation)
    app1 = b'\xff\xe1' + struct.pack('>H', len(payload) + 2) + payload
    return jpeg[:2] + app1 + jpeg[2:]


def test_jpeg_refuses_what_it_does_not_decode():
    """A lossless frame raises naming itself, and bytes that are no JPEG
    raise. A progressive JPEG and an EXIF orientation, refused before,
    now decode as cv2 decodes them: under IMREAD_COLOR cv2 turns the
    image by its orientation, and so does the port; under
    IMREAD_UNCHANGED both ignore the tag (the other refused forms:
    tests/test_torch_port_image_formats.py)."""
    img = textured(40, 56, 4)
    ok, prog = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert_same(image_io.decode(prog.tobytes()),
                cv2.imdecode(prog, cv2.IMREAD_COLOR))
    ok, enc = cv2.imencode('.jpg', img)
    rotated = _with_exif_orientation(enc.tobytes(), 6)
    assert cv2.imdecode(np.frombuffer(rotated, np.uint8),
                        cv2.IMREAD_COLOR).shape == (56, 40, 3)
    assert_same(image_io.decode(rotated),
                cv2.imdecode(np.frombuffer(rotated, np.uint8),
                             cv2.IMREAD_COLOR))
    assert_same(image_io.decode(rotated, cv2.IMREAD_UNCHANGED),
                cv2.imdecode(np.frombuffer(rotated, np.uint8),
                             cv2.IMREAD_UNCHANGED))
    upright = _with_exif_orientation(enc.tobytes(), 1)
    assert_same(image_io.decode(upright),
                cv2.imdecode(np.frombuffer(upright, np.uint8),
                             cv2.IMREAD_COLOR))
    sof = enc.tobytes().index(b'\xff\xc0')
    lossless = enc.tobytes()[:sof + 1] + b'\xc3' + enc.tobytes()[sof + 2:]
    with pytest.raises(ValueError, match='lossless'):
        image_io.decode(lossless)
    with pytest.raises(ValueError, match='not a JPEG'):
        image_io.decode_jpeg(b'\x89PNG')


# --------------------------------------------------------------------------
# PNGs
# --------------------------------------------------------------------------
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def png_by_hand(arr: np.ndarray, color: int, depth: int, filt: int,
                interlace: int = 0) -> bytes:
    """A PNG whose every row uses filter type `filt` (PNG spec 9.2)."""
    h, w = arr.shape[:2]
    raw = arr.astype('>u2').tobytes() if depth == 16 else arr.tobytes()
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    rows = np.frombuffer(raw, np.uint8).reshape(h, -1).astype(np.int32)
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int32)
    for cur in rows:
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        pred = [0, a, b, (a + b) // 2, None][filt]
        if filt == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out += bytes([filt]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    ihdr = struct.pack('>IIBBBBB', w, h, depth, color, 0, 0, interlace)
    return (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', ihdr)
            + _chunk(b'IDAT', zlib.compress(bytes(out))) + _chunk(b'IEND', b''))


PNG_KINDS = {  # color type, bit depth, array shape
    'gray16': (0, 16, (13, 17)), 'gray8': (0, 8, (13, 17)),
    'gray_alpha8': (4, 8, (13, 17, 2)), 'rgb8': (2, 8, (13, 17, 3)),
    'rgba8': (6, 8, (13, 17, 4)), 'rgb16': (2, 16, (5, 6, 3))}


@pytest.mark.parametrize('filt', range(5),
                         ids=['none', 'sub', 'up', 'average', 'paeth'])
def test_png_filters_match_cv2(filt):
    rng = np.random.RandomState(filt)
    for kind, (color, depth, shape) in PNG_KINDS.items():
        arr = rng.randint(0, 2 ** depth, shape).astype(
            np.uint16 if depth == 16 else np.uint8)
        data = png_by_hand(arr, color, depth, filt)
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            assert_same(image_io.decode(data, flag),
                        cv2.imdecode(np.frombuffer(data, np.uint8), flag))


@pytest.mark.parametrize('level', [1, 9])
def test_png_written_by_cv2_matches(level):
    rng = np.random.RandomState(level)
    for shape, dtype in (((480, 640), np.uint16), ((7, 9), np.uint8),
                         ((7, 9, 3), np.uint8), ((7, 9, 4), np.uint8),
                         ((7, 9, 3), np.uint16), ((1, 1), np.uint16)):
        arr = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        ok, enc = cv2.imencode('.png', arr, [cv2.IMWRITE_PNG_COMPRESSION,
                                             level])
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
            assert_same(image_io.decode(enc.tobytes(), flag),
                        cv2.imdecode(enc, flag))


def test_png_refuses_interlaced_palette_and_rotation():
    """Interlaced, palette and rotated PNGs, refused before, now decode as
    cv2 decodes them (a palette is expanded to its colors, Adam7 is
    deinterlaced, an eXIf orientation turns the image under
    IMREAD_COLOR only); an unknown interlace method still raises (every
    form: tests/test_torch_port_image_formats.py)."""
    arr = np.arange(60, dtype=np.uint8).reshape(6, 10)
    interlaced = png_bytes(arr[..., None], 8, 0, adam7=True)
    plain = png_by_hand(arr, 0, 8, 0)
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(image_io.decode(interlaced, flag),
                    cv2.imdecode(np.frombuffer(interlaced, np.uint8), flag))
    with pytest.raises(ValueError, match='interlace method 2'):
        image_io.decode(png_by_hand(arr, 0, 8, 0, interlace=2))
    cut = 8 + 25    # chunks after IHDR
    ihdr = plain[:cut].replace(
        struct.pack('>BB', 8, 0), struct.pack('>BB', 8, 3), 1)
    ihdr = ihdr[:cut - 4] + struct.pack('>I', zlib.crc32(ihdr[12:cut - 4]))
    palette = (ihdr + _chunk(b'PLTE', bytes(range(180)))
               + _chunk(b'tRNS', bytes(range(0, 250, 25))) + plain[cut:])
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(image_io.decode(palette, flag),
                    cv2.imdecode(np.frombuffer(palette, np.uint8), flag))
    rotated = plain[:cut] + _chunk(b'eXIf', _exif_tiff(6)) + plain[cut:]
    buf = np.frombuffer(rotated, np.uint8)
    assert cv2.imdecode(buf, cv2.IMREAD_COLOR).shape == (10, 6, 3)
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        assert_same(image_io.decode(rotated, flag), cv2.imdecode(buf, flag))


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------
RESIZE_SHAPES = [((480, 640), (480, 480)),   # the flagship's views
                 ((480, 640), (240, 320)), ((97, 131), (64, 80)),
                 ((64, 64), (48, 48)), ((30, 40), (77, 91)),
                 ((33, 47), (101, 99)), ((7, 9), (13, 5)), ((2, 2), (9, 9)),
                 ((13, 17), (13, 40)), ((1, 1), (3, 4)), ((5, 3), (1, 1)),
                 ((64, 64), (64, 64)), ((100, 100), (50, 50))]


@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('src,dst', RESIZE_SHAPES,
                         ids=[f'{s[1]}x{s[0]}-{d[1]}x{d[0]}'
                              for s, d in RESIZE_SHAPES])
def test_resize_matches_cv2(src, dst, channels):
    rng = np.random.RandomState(src[0] * 7 + dst[1])
    img = rng.randint(0, 256, src + ((channels, ) if channels > 1 else ())
                      ).astype(np.uint8)
    size = (dst[1], dst[0])
    assert_same(resize_bilinear_u8(img, size),
                cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))


def test_resize_refuses_other_dtypes():
    with pytest.raises(TypeError):
        resize_bilinear_u8(np.zeros((4, 4), np.float32), (2, 2))


# --------------------------------------------------------------------------
# the host library's build
# --------------------------------------------------------------------------
_BUILD = '''
import sys
from pathlib import Path
from proxytransformation_torch.data import image_io
image_io.BUILD_DIR = Path(sys.argv[1])
path = image_io.build()
img = image_io.imread(sys.argv[2])
print(path, img.shape)
'''


def test_two_processes_build_the_library_at_once(tmp_path):
    view = str(FIXTURES / 'view0_640x480.jpg')
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD, str(tmp_path),
                               view], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [out.strip().splitlines()[-1] for out, _ in outs]
    assert lines[0] == lines[1] and lines[0].endswith('(480, 640, 3)')
    built = sorted(q.name for q in tmp_path.iterdir())
    assert built == [Path(lines[0].split()[0]).name], built  # no leftovers


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(image_io, 'BUILD_DIR', tmp_path)
    monkeypatch.setenv('CXX', 'no-such-compiler')
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='no host C\\+\\+ compiler'):
        image_io.build()
