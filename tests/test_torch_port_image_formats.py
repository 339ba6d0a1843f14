"""The image forms the JAX package reads through cv2 beyond baseline JPEG
and plain PNG, against cv2 byte for byte: Netpbm (3RScan's depth frames
are 16-bit PGMs), progressive JPEG, Adobe RGB / CMYK / YCCK JPEG, the
EXIF orientations under IMREAD_COLOR, palette / tRNS / low-bit / Adam7
PNG; and the forms still refused, each naming itself.

The committed fixtures (`tests/torch_port_images/`, from
`proxytransformation_torch/tools/make_image_fixtures.py`) are decoded
from bytes here (`decode` against `cv2.imdecode`; `imread` against
`cv2.imread` is test_torch_port_image_io.py's); the other cases are
written here, with the tool's writers for what cv2 does not write.
"""
import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from proxytransformation_torch.data import image_io
from proxytransformation_torch.tools.make_image_fixtures import (
    RSCAN_COLOR, RSCAN_DEPTH, adobe_segment, baseline_jpeg, exif_tiff,
    png_bytes, small, with_exif)

FIXTURES = Path(__file__).resolve().parents[1] / 'tests' / 'torch_port_images'
MANIFEST = json.loads((FIXTURES / 'manifest.json').read_text())
FLAGS = {'IMREAD_COLOR': cv2.IMREAD_COLOR,
         'IMREAD_UNCHANGED': cv2.IMREAD_UNCHANGED}
# the fixtures of the forms this file covers (the rest are baseline JPEG
# and plain PNG)
NEW = [f for f in MANIFEST['files']
       if f['name'].split('.')[-1] in ('pgm', 'ppm')
       or f['name'].startswith(('rscan_', 'progressive_', 'exif_', 'adobe_',
                                'cmyk', 'ycck', 'palette', 'gray1', 'gray2',
                                'gray4', 'adam7', 'rgb8_trns'))]
BOTH = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def same_as_cv2(data: bytes, flags=BOTH):
    """`decode` equals `cv2.imdecode` (dtype, shape, bytes) under each
    flag."""
    for flag in flags:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        assert want is not None, flag
        got = image_io.decode(data, flag)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), flag
        assert np.array_equal(got, want), (flag, int((got != want).sum()))


@pytest.mark.parametrize('entry', NEW, ids=[
    f"{f['name']}-{f['flags']}" for f in NEW])
def test_fixture_decodes_from_bytes_to_cv2_and_the_manifest(entry):
    data = (FIXTURES / entry['name']).read_bytes()
    flag = FLAGS[entry['flags']]
    want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    assert digest(want) == entry['sha256']
    got = image_io.decode(data, flag)
    assert (got.dtype, list(got.shape)) == (want.dtype, entry['shape'])
    assert digest(got) == entry['sha256']


def test_the_rscan_frame_has_3rscan_sizes_and_two_cameras():
    shapes = {(f['name'], f['flags']): (f['shape'], f['dtype'])
              for f in MANIFEST['files']}
    assert shapes['rscan_frame.color.jpg', 'IMREAD_COLOR'] == (
        [540, 960, 3], 'uint8')
    assert shapes['rscan_frame.depth.pgm', 'IMREAD_UNCHANGED'] == (
        [172, 224], 'uint16')
    rscan = MANIFEST['rscan']
    for key, camera in (('cam2img', RSCAN_COLOR),
                        ('depth_cam2img', RSCAN_DEPTH)):
        k = np.asarray(rscan[key])
        assert k.shape == (4, 4)
        assert (k[0, 0], k[1, 1], k[0, 2], k[1, 2]) == camera[2:]
    raw = (FIXTURES / 'rscan_frame.depth.pgm').read_bytes()
    assert raw.startswith(b'P5\n224 172\n65535\n')


# --------------------------------------------------------------------------
# Netpbm
# --------------------------------------------------------------------------
def pnm(magic, w, h, maxval=None, comment=False):
    head = magic + '\n' + ('# a comment\n' if comment else '') + f'{w} {h}\n'
    return (head + (f'{maxval}\n' if maxval is not None else '')).encode()


@pytest.mark.parametrize('maxval', [1, 7, 100, 255, 256, 1000, 4095, 65535])
def test_pnm_gray_and_color_match_cv2(maxval):
    """P2 / P5 / P3 / P6 at each maxval: binary samples as stored (16-bit
    big-endian above 255), ASCII samples clamped and, at 8 bits, scaled."""
    rng = np.random.RandomState(maxval)
    for w, h in ((5, 3), (17, 2)):
        wide = maxval > 255
        gray = rng.randint(0, maxval + 1, w * h)
        color = rng.randint(0, maxval + 1, 3 * w * h)

        def binary(a):
            return a.astype('>u2' if wide else np.uint8).tobytes()

        same_as_cv2(pnm('P5', w, h, maxval, True) + binary(gray))
        same_as_cv2(pnm('P6', w, h, maxval, True) + binary(color))
        above = rng.randint(0, maxval + 3, w * h)   # ASCII: clamped
        same_as_cv2(pnm('P2', w, h, maxval)
                    + ' '.join(map(str, above)).encode() + b'\n')
        same_as_cv2(pnm('P3', w, h, maxval)
                    + ' '.join(map(str, color)).encode() + b'\n')


def test_pnm_bitmaps_and_header_forms_match_cv2():
    rng = np.random.RandomState(0)
    for w, h in ((5, 3), (9, 4), (17, 2)):
        bits = rng.randint(0, 2, (h, w))
        same_as_cv2(pnm('P1', w, h) + b'\n'.join(
            b''.join(b'%d' % v for v in row) for row in bits) + b'\n')
        same_as_cv2(pnm('P4', w, h) + np.packbits(bits, axis=1).tobytes())
    same_as_cv2(b'P5 4 2 255 ' + bytes(range(8)))
    same_as_cv2(b'P2\n#c1\n#c2\r3 1 #x\n9\n1 #y\n 5 12\n')
    # a 16-bit map at maxval 4095 reads big-endian, as at 65535
    big = np.array([300, 0, 1, 4095, 256, 1000, 4095, 7], '>u2')
    data = pnm('P5', 4, 2, 4095, True) + big.tobytes()
    same_as_cv2(data)
    assert image_io.decode(data, -1).ravel().tolist() == big.tolist()


@pytest.mark.parametrize('data,message', [
    (pnm('P5', 4, 2, 255) + bytes(5), 'truncated'),
    (pnm('P2', 4, 2, 255) + b'1 2 3', 'truncated'),
    (pnm('P5', 4, 2, 70000) + bytes(16), 'maxval 70000'),
    (pnm('P5', 0, 2, 255), 'corrupt PNM'),
    (b'P5 4 x 255 ' + bytes(8), 'unexpected byte'),
    (b'P2 2 1 9 12#c\n3\n', 'unexpected byte')])
def test_pnm_refuses_what_cv2_cannot_read(data, message):
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match=message):
        image_io.decode(data, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize('magic', [b'P7\n', b'PF\n', b'Pf\n', b'P5x'])
def test_other_netpbm_magics_are_unknown(magic):
    with pytest.raises(ValueError, match='unknown image format'):
        image_io.decode(magic + b'4 2 255\n' + bytes(8))


# --------------------------------------------------------------------------
# JPEG
# --------------------------------------------------------------------------
def scene(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 7 + y * 3) % 256, np.sin(x / 5.0) * 100 + 128,
                    (y * 11) % 256], -1) + rng.randint(-30, 30, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


SAMPLING = {'420': 0x221111, '422': 0x211111, '440': 0x121111,
            '444': 0x111111, '411': 0x411111}


@pytest.mark.parametrize('sampling', SAMPLING)
@pytest.mark.parametrize('rst', [0, 1, 3])
def test_progressive_jpeg_matches_cv2(sampling, rst):
    """libjpeg's progression (DC first and refine, AC spectral selection
    with successive approximation and EOB runs) at each sampling, with
    restart markers inside the scans; two qualities, four sizes."""
    for i, (h, w) in enumerate(((8, 8), (13, 21), (64, 48), (75, 130))):
        for quality in (35, 95):
            ok, enc = cv2.imencode('.jpg', scene(h, w, i), [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            assert enc.tobytes()[:200].find(b'\xff\xc2') > 0
            same_as_cv2(enc.tobytes())
    ok, gray = cv2.imencode('.jpg', scene(40, 56, 9)[..., 0],
                            [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    same_as_cv2(gray.tobytes())


def jfif_segment():
    return (b'\xff\xe0' + struct.pack('>H', 16) + b'JFIF\x00\x01\x01\x00'
            + struct.pack('>HHBB', 1, 1, 0, 0))


@pytest.mark.parametrize('form', ['cmyk_adobe0', 'cmyk_plain', 'ycck',
                                  'ycck_adobe1', 'rgb_adobe0', 'rgb_ids',
                                  'ycc_adobe1', 'jfif_and_adobe0'])
def test_adobe_cmyk_ycck_and_rgb_jpegs_match_cv2(form):
    """The color space as libjpeg guesses it from the markers and the
    component ids, and cv2's CMYK → BGR."""
    planes = scene(24, 40, 5)
    ink = np.concatenate([planes, planes[..., :1] // 2 + 60], -1)
    data = {
        'cmyk_adobe0': lambda: baseline_jpeg(ink, adobe_segment(0)),
        'cmyk_plain': lambda: baseline_jpeg(ink),
        'ycck': lambda: baseline_jpeg(ink, adobe_segment(2)),
        'ycck_adobe1': lambda: baseline_jpeg(ink, adobe_segment(1)),
        'rgb_adobe0': lambda: baseline_jpeg(planes, adobe_segment(0)),
        'rgb_ids': lambda: baseline_jpeg(planes).replace(
            b'\x01\x11\x00\x02\x11\x00\x03\x11\x00',
            b'R\x11\x00G\x11\x00B\x11\x00').replace(
            b'\x01\x00\x02\x00\x03\x00\x00\x3f', b'R\x00G\x00B\x00\x00\x3f'),
        'ycc_adobe1': lambda: baseline_jpeg(planes, adobe_segment(1)),
        'jfif_and_adobe0': lambda: baseline_jpeg(
            planes, jfif_segment() + adobe_segment(0))}[form]()
    same_as_cv2(data)


@pytest.mark.parametrize('orientation', range(10))
def test_exif_orientation_turns_as_cv2_under_imread_color(orientation):
    """JPEG (baseline and progressive, little- and big-endian EXIF) and PNG
    (eXIf before or after the image data): upright under IMREAD_COLOR as
    cv2 turns it, as stored under IMREAD_UNCHANGED; 0 and 9 are no
    orientation."""
    img = small(24, 40, orientation)
    for params in ([], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]):
        jpeg = cv2.imencode('.jpg', img, params)[1].tobytes()
        same_as_cv2(with_exif(jpeg, orientation))
    tiff = exif_tiff(orientation)
    big = (b'MM' + struct.pack('>HI', 42, 8) + struct.pack('>H', 1)
           + struct.pack('>HHIHH', 0x0112, 3, 1, orientation, 0)
           + struct.pack('>I', 0))
    jpeg = cv2.imencode('.jpg', img)[1].tobytes()
    same_as_cv2(jpeg[:2] + b'\xff\xe1' + struct.pack('>H', len(big) + 8)
                + b'Exif\0\0' + big + jpeg[2:])
    for exif in (tiff, big):
        same_as_cv2(png_bytes(img, 8, 2, exif=exif))
    after = png_bytes(img[..., :1], 8, 0)
    chunk = png_bytes(img[:1, :1, :1], 8, 0, exif=tiff)
    exif_chunk = chunk[chunk.index(b'eXIf') - 4:chunk.index(b'PLTE')
                       if b'PLTE' in chunk else chunk.index(b'IDAT') - 4]
    same_as_cv2(after[:-12] + exif_chunk + after[-12:])


def _with_sof(jpeg: bytes, marker: int) -> bytes:
    at = jpeg.index(b'\xff\xc0')
    return jpeg[:at + 1] + bytes([marker]) + jpeg[at + 2:]


def test_jpeg_refuses_lossless_hierarchical_arithmetic_12bit_dnl_smoothing():
    """What libjpeg-turbo decodes and the port does not raises naming the
    feature: lossless, hierarchical and arithmetic-coded frames, 12-bit
    samples, a height defined by DNL, and a progressive file whose scans
    leave low frequencies unrefined (libjpeg would smooth its blocks).
    What was refused before and is read now (progressive, an EXIF
    orientation) is in the tests above."""
    enc = cv2.imencode('.jpg', scene(40, 56, 4))[1].tobytes()
    for marker, feature in ((0xC3, 'lossless'), (0xC5, 'hierarchical'),
                            (0xC6, 'hierarchical'), (0xC9, 'arithmetic'),
                            (0xCA, 'arithmetic')):
        with pytest.raises(ValueError, match=feature):
            image_io.decode(_with_sof(enc, marker))
    sof = enc.index(b'\xff\xc0')
    twelve = enc[:sof + 4] + b'\x0c' + enc[sof + 5:]
    with pytest.raises(ValueError, match='12-bit'):
        image_io.decode(twelve)
    dnl = enc[:sof + 5] + b'\x00\x00' + enc[sof + 7:]
    with pytest.raises(ValueError, match='DNL'):
        image_io.decode(dnl)
    prog = cv2.imencode('.jpg', scene(40, 56, 4),
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    scans = [i for i in range(len(prog) - 1)
             if prog[i:i + 2] == b'\xff\xda']
    cut = prog[:scans[2]] + b'\xff\xd9'   # the DC scan and one AC band
    with pytest.raises(ValueError, match='block smoothing'):
        image_io.decode(cut)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------
PNG_FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]


@pytest.mark.parametrize('color,depth', PNG_FORMS,
                         ids=[f'type{c}-{d}bit' for c, d in PNG_FORMS])
def test_png_forms_match_cv2(color, depth):
    """Every color type at every bit depth, plain and Adam7 (sizes from 1x1,
    where passes are empty, to 17x10), with a tRNS chunk where the type
    takes one (palette alphas, a gray or RGB key) and palette indices past
    the palette's end."""
    rng = np.random.RandomState(color * 100 + depth)
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = 1 << depth
    for w, h in ((1, 1), (3, 2), (9, 7), (17, 10)):
        px = rng.randint(0, top, (h, w, samples))
        for adam7 in (False, True):
            if color == 3:
                palette = rng.randint(0, 256, (min(top, 5 + depth) - 1, 3))
                same_as_cv2(png_bytes(px, depth, 3, palette, adam7=adam7))
                alphas = bytes(rng.randint(0, 256, min(top, 3)).tolist())
                same_as_cv2(png_bytes(px, depth, 3, palette, alphas,
                                      adam7=adam7))
                continue
            same_as_cv2(png_bytes(px, depth, color, adam7=adam7))
            if color in (0, 2):
                key = struct.pack(f'>{samples}H', *map(int, px[0, 0]))
                same_as_cv2(png_bytes(px, depth, color, trns=key,
                                      adam7=adam7))


def test_png_refuses_other_interlaces_and_depths():
    img = np.arange(60, dtype=np.uint8).reshape(6, 10, 1)
    data = png_bytes(img, 8, 0)
    ihdr = data.index(b'IHDR') + 4
    bad = data[:ihdr + 12] + b'\x02' + data[ihdr + 13:]
    with pytest.raises(ValueError, match='interlace method 2'):
        image_io.decode(bad)
    bad = data[:ihdr + 8] + b'\x10\x03' + data[ihdr + 10:]
    with pytest.raises(ValueError, match='16-bit PNG of color type 3'):
        image_io.decode(bad)
    bad = data[:ihdr + 8] + b'\x08\x03' + data[ihdr + 10:]
    with pytest.raises(ValueError, match='without PLTE'):
        image_io.decode(bad)
