"""Write the image fixtures of the decoder tests and of chip_smoke.py.

    python -m proxytransformation_torch.tools.make_image_fixtures

writes `tests/torch_port_images/`: two 640x480 RGB-D views of a
ray-cast room (a JPEG at cv2's default 4:2:0 and quality 95, and a 16-bit
PNG depth map in millimetres, 0 where the ray leaves the room), small
JPEGs at 4:2:2, 4:4:4, 4:4:0, grayscale, quality 50 and 100, one with
restart markers and odd sizes (1x1, 7x9, 97x131), 8-bit gray and RGB PNGs,
and `manifest.json`: for each file its kind, the cv2 flag it is read with,
the shape and dtype of `cv2.imread`'s array and the sha256 of that
array's bytes (the decoder must reproduce those digests wherever it
runs); and for the two views their camera-to-world poses, the intrinsics
and the room's boxes (center, size, zero euler angles), from which
chip_smoke.py writes an EmbodiedScan-style scan.

Then the forms the reference reads beyond those (each digest under both
read flags where they differ): a 3RScan-sized view of the same room
(`rscan_frame.color.jpg` at 960x540 and `rscan_frame.depth.pgm`, a 16-bit
binary PGM at 224x172, each with its own intrinsics, in the manifest's
`rscan` entry); Netpbm gray maps at maxval 255, 4095 and 65535 with a
header comment and a P6 pixmap; progressive JPEGs (4:2:0, 4:4:4, one
with restart markers); a JPEG for each of the 8 EXIF orientations (an
APP1 block spliced in) and a PNG with an eXIf chunk; Adobe RGB, CMYK and
YCCK JPEGs (`baseline_jpeg`, a small encoder here, since cv2 writes
none); palette PNGs with and without tRNS, an RGB PNG with a tRNS key,
1-, 2- and 4-bit gray PNGs and an Adam7 PNG (`png_bytes`, with zlib,
since cv2 writes none either).

This tool needs cv2 (OpenCV's encoders and decoders are the reference);
the port itself never imports it. The fixtures are drawn from a fixed
seed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

OUT_DIR = Path(__file__).resolve().parents[2] / 'tests' / 'torch_port_images'
H, W = 480, 640
# ScanNet-style pinhole intrinsics of a 640x480 view
FX = FY = 577.87
CX, CY = 319.5, 239.5
ROOM = np.array([[-2.5, -2.0, 0.0], [3.0, 2.5, 2.8]])   # min / max corners
ORIGIN = np.array([0.2, 0.1, 1.5])                       # the camera
BOXES = (((1.0, -1.2, 0.0), (1.9, -0.3, 0.75)),
         ((-1.8, 1.0, 0.0), (-0.9, 2.0, 1.1)),
         ((1.6, 1.2, 0.0), (2.4, 2.2, 0.45)))
POSES = ((0.35, 0.25), (2.2, 0.35))                      # yaw, pitch
# (h, w, fx, fy, cx, cy) of the views above, and of a 3RScan frame's color
# and depth cameras (3RScan's frame sizes; intrinsics of its order)
CAMERA = (H, W, FX, FY, CX, CY)
RSCAN_COLOR = (540, 960, 756.83, 756.03, 492.89, 270.42)
RSCAN_DEPTH = (172, 224, 177.91, 178.30, 111.98, 86.53)
RSCAN_POSE = (1.2, 0.3)


def cam2global(yaw: float, pitch: float) -> np.ndarray:
    """4x4 camera-to-world pose of a camera at ORIGIN looking along `yaw`,
    tilted down by `pitch` (camera: x right, y down, z forward)."""
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    fwd = np.array([cy * cp, sy * cp, -sp])
    right = np.array([sy, -cy, 0.0])
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
    pose[:3, 3] = ORIGIN
    return pose


def cam_rays(yaw: float, pitch: float, camera=CAMERA):
    """World-frame unit rays of every pixel, and their camera-frame z."""
    h, w, fx, fy, cx, cy = camera
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d @ cam2global(yaw, pitch)[:3, :3].T, d[..., 2]


def render(yaw: float, pitch: float, boxes, seed: int, camera=CAMERA):
    """Depth (mm, uint16) and BGR color of the room and its boxes."""
    rng = np.random.RandomState(seed)
    origin = ORIGIN
    h, w = camera[:2]
    rays, cos_z = cam_rays(yaw, pitch, camera)
    t_best = np.full((h, w), np.inf)
    surf = np.zeros((h, w), np.int64)
    safe = np.where(np.abs(rays) < 1e-9, 1e-9, rays)
    for axis in range(3):     # the room's six inner faces
        for side in range(2):
            t = (ROOM[side, axis] - origin[axis]) / safe[..., axis]
            ok = (t > 0) & (t < t_best)
            t_best = np.where(ok, t, t_best)
            surf = np.where(ok, 1 + axis * 2 + side, surf)
    for i, (lo, hi) in enumerate(boxes):  # slab test against each box
        t0 = (np.asarray(lo) - origin) / safe
        t1 = (np.asarray(hi) - origin) / safe
        near = np.minimum(t0, t1).max(-1)
        far = np.maximum(t0, t1).min(-1)
        ok = (near < far) & (near > 0) & (near < t_best)
        t_best = np.where(ok, near, t_best)
        surf = np.where(ok, 10 + i, surf)
    depth_m = t_best * cos_z             # distance along the optical axis
    depth_m += rng.normal(0, 0.004, depth_m.shape)
    depth = np.clip(depth_m * 1000, 0, 65535).astype(np.uint16)
    depth[rng.rand(h, w) < 0.03] = 0     # dropouts, as in sensor data
    depth[:, :6] = 0                     # an invalid border column band
    palette = rng.randint(40, 230, (32, 3))
    hit = origin + rays * t_best[..., None]
    texture = (np.sin(hit[..., 0] * 7) + np.sin(hit[..., 1] * 5)
               + np.sin(hit[..., 2] * 9)) * 12
    shade = 0.55 + 0.45 * np.clip(1.5 / np.maximum(depth_m, 0.3), 0, 1)
    color = palette[surf] * shade[..., None] + texture[..., None]
    color += rng.normal(0, 6, color.shape)   # sensor noise: photo-like entropy
    return depth, np.clip(color, 0, 255).astype(np.uint8)


def intrinsics(camera) -> list:
    """The 4x4 cam2img of a (h, w, fx, fy, cx, cy) camera."""
    _, _, fx, fy, cx, cy = camera
    return [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]


def small(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) % 32 * 8], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# writers of the forms cv2 does not write
# --------------------------------------------------------------------------
def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack('>H', len(body) + 2) + body


def _huffman(bits, values):
    """value → (code, length) of a JPEG Huffman table (Annex C)."""
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[values[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


# the example tables of the JPEG specification (Annex K: K.1, K.3, K.5)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13,
    16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56,
    68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103,
    121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d)
_AC_VALUES = bytes.fromhex(
    '01020300041105122131410613516107227114328191a1082342b1c11552d1f0'
    '2433627282090a161718191a25262728292a3435363738393a43444546474849'
    '4a535455565758595a636465666768696a737475767778797a83848586878889'
    '8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
    'c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
    'f9fa')


def baseline_jpeg(planes: np.ndarray, app: bytes = b'') -> bytes:
    """(H, W, N) uint8 planes as a baseline JPEG, every component at full
    resolution in one interleaved scan, component ids 1..N, the
    specification's example luminance quantization and Huffman tables,
    and `app` (marker segments) after SOI: the decoder's color space comes
    from those markers alone."""
    h, w, n = planes.shape
    dct = np.array([[np.sqrt((1 if k == 0 else 2) / 8)
                     * np.cos((2 * x + 1) * k * np.pi / 16)
                     for x in range(8)] for k in range(8)])
    dc = _huffman(_DC_BITS, range(12))
    ac = _huffman(_AC_BITS, _AC_VALUES)
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    padded = np.pad(planes.astype(np.float64) - 128,
                    ((0, hp - h), (0, wp - w), (0, 0)), mode='edge')
    bits = []

    def put(value, length):
        bits.extend((value >> i) & 1 for i in range(length - 1, -1, -1))

    def magnitude(v):
        size = int(abs(v)).bit_length()
        return size, v if v >= 0 else v + (1 << size) - 1

    pred = [0] * n
    for by in range(0, hp, 8):
        for bx in range(0, wp, 8):
            for c in range(n):
                block = dct @ padded[by:by + 8, bx:bx + 8, c] @ dct.T
                q = np.round(block.reshape(-1) / _QUANT).astype(int)[_ZIGZAG]
                size, v = magnitude(q[0] - pred[c])
                pred[c] = q[0]
                put(*dc[size])
                put(v, size)
                run = 0
                for k in range(1, 64):
                    if q[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(*ac[0xF0])
                        run -= 16
                    size, v = magnitude(q[k])
                    put(*ac[(run << 4) | size])
                    put(v, size)
                    run = 0
                if run:
                    put(*ac[0])
    bits.extend([1] * (-len(bits) % 8))
    data = np.packbits(np.array(bits, np.uint8)).tobytes()
    data = data.replace(b'\xff', b'\xff\x00')
    ids = range(1, n + 1)
    return (b'\xff\xd8' + app
            + _segment(0xDB, bytes([0]) + bytes(_QUANT[_ZIGZAG].tolist()))
            + _segment(0xC0, struct.pack('>BHHB', 8, h, w, n)
                       + b''.join(bytes([i, 0x11, 0]) for i in ids))
            + _segment(0xC4, bytes([0x00, *_DC_BITS, *range(12)]))
            + _segment(0xC4, bytes([0x10, *_AC_BITS]) + _AC_VALUES)
            + _segment(0xDA, bytes([n]) + b''.join(bytes([i, 0]) for i in ids)
                       + bytes([0, 63, 0]))
            + data + b'\xff\xd9')


def adobe_segment(transform: int) -> bytes:
    """An APP14 'Adobe' segment (transform 0: RGB / CMYK, 2: YCCK)."""
    return _segment(0xEE, b'Adobe' + struct.pack('>HHHB', 100, 0, 0,
                                                 transform))


def exif_tiff(orientation: int) -> bytes:
    """A little-endian TIFF block of two tags (a Make, the orientation)."""
    return (b'II' + struct.pack('<HI', 42, 8) + struct.pack('<H', 2)
            + struct.pack('<HHIHH', 0x010F, 2, 1, 0, 0)
            + struct.pack('<HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack('<I', 0))


def with_exif(jpeg: bytes, orientation: int) -> bytes:
    """`jpeg` with an APP1 EXIF segment after SOI."""
    return (jpeg[:2] + _segment(0xE1, b'Exif\0\0' + exif_tiff(orientation))
            + jpeg[2:])


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(px: np.ndarray, depth: int) -> bytes:
    """(h, w, samples) samples as PNG rows, filter types 0-4 in turn."""
    h, w, n = px.shape
    if depth == 16:
        rows = px.astype('>u2').view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        bits = (px.reshape(h, w * n, 1) >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    bpp = max(1, n * depth // 8)
    out, prev = b'', np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) // 2, paeth)[y % 5]
        out += bytes([y % 5]) + ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    return out


def png_bytes(px: np.ndarray, depth: int, color: int, palette=None,
              trns: bytes = None, adam7: bool = False,
              exif: bytes = None) -> bytes:
    """A PNG of (h, w, samples) samples: any bit depth and color type, a
    PLTE, tRNS and eXIf chunk, Adam7 interlace; rows filtered by each of
    the five filter types in turn."""
    h, w = px.shape[:2]
    if adam7:
        raw = b''.join(_png_rows(px[y0::dy, x0::dx], depth)
                       for x0, y0, dx, dy in _ADAM7
                       if w > x0 and h > y0)
    else:
        raw = _png_rows(px, depth)
    out = b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, color, 0, 0, int(adam7)))
    if exif is not None:
        out += _png_chunk(b'eXIf', exif)
    if palette is not None:
        out += _png_chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b'tRNS', trns)
    return (out + _png_chunk(b'IDAT', zlib.compress(raw, 9))
            + _png_chunk(b'IEND', b''))


def pgm_bytes(img: np.ndarray, maxval: int, comment: str) -> bytes:
    """A binary PGM (P5) with a comment line in its header; 16-bit samples
    big-endian when maxval > 255."""
    h, w = img.shape
    body = (img.astype('>u2') if maxval > 255 else img.astype(np.uint8))
    return (f'P5\n# {comment}\n{w} {h}\n{maxval}\n'.encode()
            + body.tobytes())


def main(argv=None) -> None:
    import cv2   # the fixture tool only: OpenCV is the reference

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=str(OUT_DIR))
    args = parser.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sampling = {'420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
    files = []   # (name, array, encode params, read flag)
    for i, (yaw, pitch) in enumerate(POSES):
        depth, color = render(yaw, pitch, BOXES, seed=i)
        files.append((f'view{i}_640x480.jpg', color,
                      [cv2.IMWRITE_JPEG_QUALITY, 95], cv2.IMREAD_COLOR))
        files.append((f'depth{i}_640x480.png', depth, [],
                      cv2.IMREAD_UNCHANGED))
    base = small(48, 64, 10)
    for name, samp in sampling.items():
        if name != '420':
            files.append((f'small_{name}_q90.jpg', base,
                          [cv2.IMWRITE_JPEG_QUALITY, 90,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp],
                          cv2.IMREAD_COLOR))
    files += [
        ('small_gray_q90.jpg', base[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90],
         cv2.IMREAD_COLOR),
        ('small_q50.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 50],
         cv2.IMREAD_COLOR),
        ('small_q100.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 100],
         cv2.IMREAD_COLOR),
        ('small_rst2.jpg', base, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
         cv2.IMREAD_COLOR),
        ('odd_1x1.jpg', small(1, 1, 11), [], cv2.IMREAD_COLOR),
        ('odd_7x9.jpg', small(7, 9, 12), [], cv2.IMREAD_COLOR),
        ('odd_97x131.jpg', small(97, 131, 13), [], cv2.IMREAD_COLOR),
        ('gray8_37x29.png', small(29, 37, 14)[..., 0], [],
         cv2.IMREAD_UNCHANGED),
        ('rgb8_37x29.png', small(29, 37, 15), [], cv2.IMREAD_UNCHANGED),
    ]
    files = [(name, arr, params, (flag, )) for name, arr, params, flag
             in files]
    both = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR)
    # a 3RScan frame: 960x540 color and 224x172 depth from one pose, each
    # camera with its own intrinsics
    _, rscan_color = render(*RSCAN_POSE, BOXES, seed=2, camera=RSCAN_COLOR)
    rscan_depth, _ = render(*RSCAN_POSE, BOXES, seed=3, camera=RSCAN_DEPTH)
    files += [('rscan_frame.color.jpg', rscan_color,
               [cv2.IMWRITE_JPEG_QUALITY, 90], (cv2.IMREAD_COLOR, )),
              ('rscan_frame.depth.pgm', rscan_depth, [], both)]
    # Netpbm: 8- and 16-bit gray maps with a header comment, a pixmap
    gray = small(29, 37, 16)[..., 0]
    files += [
        ('gray_maxval255.pgm', pgm_bytes(gray, 255, 'maxval 255'), [],
         both),
        ('gray_maxval4095.pgm', pgm_bytes(gray.astype(np.uint16) * 16 + 7,
                                          4095, 'maxval 4095'), [], both),
        ('gray_maxval65535.pgm', pgm_bytes(
            gray.astype(np.uint16) * 257 + 3, 65535, 'maxval 65535'), [],
         both),
        ('rgb_37x29.ppm', small(29, 37, 17), [], both)]
    # progressive JPEGs
    files += [(f'progressive_{name}.jpg', base,
               [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[name]]
               + ([cv2.IMWRITE_JPEG_RST_INTERVAL, 3] if rst else []),
               (cv2.IMREAD_COLOR, )) for name, rst in
              (('420', False), ('444', False), ('420', True))]
    files[-1] = ('progressive_420_rst3.jpg', *files[-1][1:])
    # the 8 EXIF orientations (a non-square view, so transposes show)
    upright = cv2.imencode('.jpg', small(24, 40, 18))[1].tobytes()
    files += [(f'exif_orientation{o}.jpg', with_exif(upright, o), [], both)
              for o in range(1, 9)]
    # Adobe RGB, CMYK and YCCK (4 components at full resolution)
    planes = small(24, 40, 19)
    ink = np.concatenate([planes, planes[..., :1] // 2 + 40], -1)
    files += [('adobe_rgb.jpg', baseline_jpeg(planes, adobe_segment(0)), [],
               both),
              ('cmyk.jpg', baseline_jpeg(ink, adobe_segment(0)), [], both),
              ('ycck.jpg', baseline_jpeg(ink, adobe_segment(2)), [], both)]
    # PNG forms: palette with and without tRNS, an RGB tRNS key, gray at
    # 1, 2 and 4 bits, Adam7, an eXIf orientation
    rng = np.random.RandomState(20)
    palette = rng.randint(0, 256, (12, 3))
    index = (small(21, 27, 21)[..., :1] // 22).astype(np.uint8)
    rgb = small(21, 27, 22)
    rgb[::3, ::4] = (10, 20, 30)
    files += [
        ('palette8.png', png_bytes(index, 8, 3, palette), [], both),
        ('palette8_trns.png', png_bytes(index, 8, 3, palette,
                                        bytes(range(0, 250, 40))), [], both),
        ('palette4_trns.png', png_bytes(index, 4, 3, palette, b'\x00\x80'),
         [], both),
        ('rgb8_trns.png', png_bytes(rgb[..., ::-1], 8, 2,
                                    trns=struct.pack('>3H', 30, 20, 10)), [],
         both),
        *[(f'gray{d}.png', png_bytes(index % (1 << d), d, 0), [], both)
          for d in (1, 2, 4)],
        ('adam7_rgb8.png', png_bytes(rgb, 8, 2, adam7=True), [], both),
        ('exif_orientation6.png', png_bytes(rgb, 8, 2, exif=exif_tiff(6)),
         [], both)]
    manifest = []
    for name, payload, params, flags in files:
        path = out / name
        if isinstance(payload, bytes):
            path.write_bytes(payload)
        elif not cv2.imwrite(str(path), payload, params):
            raise RuntimeError(f'cv2 could not write {path}')
        for flag in flags:
            got = cv2.imread(str(path), flag)
            if got is None:
                raise RuntimeError(f'cv2 could not read {path}')
            manifest.append({
                'name': name,
                'kind': path.suffix[1:].replace('jpg', 'jpeg'),
                'flags': 'IMREAD_COLOR' if flag == cv2.IMREAD_COLOR
                else 'IMREAD_UNCHANGED',
                'shape': list(got.shape), 'dtype': str(got.dtype),
                'sha256': hashlib.sha256(
                    np.ascontiguousarray(got).tobytes()).hexdigest()})
    meta = {'generator': 'proxytransformation_torch/tools/'
                         'make_image_fixtures.py',
            'cv2': cv2.__version__,
            'cam2img': [[FX, 0, CX, 0], [0, FY, CY, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1]],
            'depth_shift': 1000,
            'views': [{'image': f'view{i}_640x480.jpg',
                       'depth': f'depth{i}_640x480.png',
                       'cam2global': cam2global(*p).round(12).tolist()}
                      for i, p in enumerate(POSES)],
            'rscan': {
                'image': 'rscan_frame.color.jpg',
                'depth': 'rscan_frame.depth.pgm',
                'cam2img': intrinsics(RSCAN_COLOR),
                'depth_cam2img': intrinsics(RSCAN_DEPTH),
                'depth_shift': 1000,
                'cam2global': cam2global(*RSCAN_POSE).round(12).tolist()},
            'boxes': [[round(float(v), 6) for v in (
                *np.add(lo, hi) / 2, *np.subtract(hi, lo), 0, 0, 0)]
                for lo, hi in BOXES],
            'files': manifest}
    (out / 'manifest.json').write_text(json.dumps(meta, indent=1) + '\n')
    total = sum((out / name).stat().st_size
                for name in {f['name'] for f in manifest})
    print(f'{len(manifest)} fixtures, {total / 1e6:.2f} MB, in {out}')


if __name__ == '__main__':
    main()
