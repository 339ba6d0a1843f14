"""Image files → numpy arrays without cv2 or PIL, byte-equal with cv2.

`imread(path, flags)` stands in for `cv2.imread` where the JAX package
calls it (data/transforms.py: `LoadImageFromFile`, IMREAD_COLOR → BGR
uint8 H×W×3; `LoadDepthFromFile`, IMREAD_UNCHANGED → uint16 H×W for a
16-bit PNG). The format is chosen by the file's magic bytes, not its
extension. `write_png(path, img)` stands in for `cv2.imwrite` of a PNG
(converter/scannet_sens.py's 16-bit depth dump).

JPEG decodes in host C++ (`csrc/image_decode.cpp`: libjpeg-turbo's
default decode — islow IDCT, fancy upsampling, jdcolor.c's YCbCr → BGR).
PNG chunks are parsed here and the IDATs inflated with the standard
library's zlib; the row filters are undone in the same C++ library. Both
release the GIL (ctypes and zlib), so a loader thread overlaps the train
step.

The library is compiled at first use with the host C++ compiler
(`$CXX`, else `c++`, else `g++`; `-O2 -fPIC -shared -std=c++17`, nothing
tuned to the building machine) into `build/torch_host/lib<name>-<key>.so`
beside the package, the key hashing the flags and the source, so a change
to either builds a new library. Processes that build at once (test
workers) each write to a private temporary name and rename it. A missing
compiler or a failed build raises; there is no slower fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / 'csrc' / 'image_decode.cpp'
BUILD_DIR = PKG_DIR.parent / 'build' / 'torch_host'
CXX_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17')

# cv2's flag values (the JAX package passes these two)
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_ERR_LEN = 256


def _compiler() -> str:
    for name in (os.environ.get('CXX'), 'c++', 'g++'):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError('no host C++ compiler: set CXX or put c++ / g++ on '
                       'PATH (the image decoder is built from '
                       f'{SOURCE.name} at first use)')


def library_path() -> Path:
    key = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    key.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libimage_decode-{key.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the decoder library unless it exists; return its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.'
                         f'{threading.get_ident()}.tmp')
    cmd = [_compiler(), *CXX_FLAGS, '-o', str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'building {SOURCE.name} failed ({" ".join(cmd)}):'
                           f'\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.c_void_p
            i32p = ctypes.POINTER(ctypes.c_int)
            lib.ptt_jpeg_info.restype = ctypes.c_int
            lib.ptt_jpeg_info.argtypes = [u8p, ctypes.c_int64, i32p, i32p,
                                          i32p, i32p, ctypes.c_char_p,
                                          ctypes.c_int]
            lib.ptt_jpeg_decode.restype = ctypes.c_int
            lib.ptt_jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int]
            lib.ptt_png_unfilter.restype = ctypes.c_int
            lib.ptt_png_unfilter.argtypes = [u8p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_int, u8p]
            _lib = lib
        return _lib


# --------------------------------------------------------------------------
# JPEG
# --------------------------------------------------------------------------
def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` turned upright by its EXIF orientation as cv2.imread does
    under IMREAD_COLOR (loadsave.cpp's ApplyExifOrientation: 2 mirrors, 3
    turns half round, 4 flips, 5-8 transpose first and then do nothing,
    mirror, turn half round or flip); a value outside 2-8 leaves it."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
        orientation -= 4
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """JPEG bytes → BGR uint8 (H, W, 3), turned upright by the EXIF
    orientation under IMREAD_COLOR; under IMREAD_UNCHANGED a one-component
    image stays (H, W) and nothing turns."""
    lib = _library()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c, orient = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                       ctypes.c_int())
    if lib.ptt_jpeg_info(buf.ctypes.data, len(buf), ctypes.byref(h),
                         ctypes.byref(w), ctypes.byref(c),
                         ctypes.byref(orient), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    gray = flags == IMREAD_UNCHANGED and c.value == 1
    channels = 1 if gray else 3
    out = np.empty((h.value, w.value, channels), np.uint8)
    if lib.ptt_jpeg_decode(buf.ctypes.data, len(buf), out.ctypes.data,
                           h.value, w.value, channels, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    if gray:
        return out[..., 0]
    if flags == IMREAD_COLOR:
        return apply_orientation(out, orient.value)
    return out


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------
_PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
# color type → samples a pixel
_PNG_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def _exif_orientation(payload: bytes) -> int:
    """The orientation tag (0x0112) of a TIFF-structured EXIF block, 1 if
    it has none."""
    if payload.startswith(b'Exif\0\0'):
        payload = payload[6:]
    if len(payload) < 8:
        return 1
    end = '<' if payload[:2] == b'II' else '>'
    try:
        ifd = struct.unpack_from(end + 'I', payload, 4)[0]
        count = struct.unpack_from(end + 'H', payload, ifd)[0]
        for i in range(count):
            tag, _, _, value = struct.unpack_from(end + 'HHIH', payload,
                                                  ifd + 2 + 12 * i)
            if tag == 0x0112:
                return value
    except struct.error:
        raise ValueError('corrupt PNG: truncated eXIf chunk') from None
    return 1


# (x0, y0, dx, dy) of the seven Adam7 passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the bit depths the PNG specification allows for each color type
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_samples(raw: np.ndarray, pos: int, width: int, height: int,
                 samples: int, depth: int) -> tuple:
    """Unfilter one image (or Adam7 pass) of `height` rows starting at
    `raw[pos]`: (H, W, samples) samples (uint8, or uint16 at depth 16) and
    the position after it."""
    bits = samples * depth
    rowbytes = (width * bits + 7) // 8
    end = pos + height * (rowbytes + 1)
    if end > raw.size:
        raise ValueError('corrupt PNG: image data too short')
    rows = np.empty(height * rowbytes, np.uint8)
    part = np.ascontiguousarray(raw[pos:end])
    if _library().ptt_png_unfilter(part.ctypes.data, height, rowbytes,
                                   max(1, bits // 8), rows.ctypes.data):
        raise ValueError('corrupt PNG: unknown filter type')
    rows = rows.reshape(height, rowbytes)
    if depth == 16:
        img = rows.view('>u2').astype(np.uint16)
    elif depth == 8:
        img = rows
    else:   # 1, 2, 4 bits, most significant first, rows padded to bytes
        flat = np.unpackbits(rows, axis=1)[:, :width * samples * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (flat.reshape(height, width * samples, depth)
               * weights).sum(-1, dtype=np.uint8)
    return img.reshape(height, width, samples), end


def decode_png(data: bytes, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """PNG bytes → the array cv2.imread gives (libpng with OpenCV's
    transforms).

    16-bit samples come as native uint16, color as BGR(A); gray of 1, 2 or
    4 bits is scaled to 8 (× 255, 85, 17); a palette image is its colors;
    Adam7 is deinterlaced. IMREAD_UNCHANGED keeps the file's channels, with
    an alpha channel where the file has one or where a tRNS chunk gives a
    palette or RGB image one (the palette's alphas, 255 past them; 0 on the
    RGB key color, else the maximum); a gray image's tRNS is ignored, as
    cv2 ignores it, and gray + alpha comes as BGRA. IMREAD_COLOR gives 3
    channels: gray replicated, alpha dropped, 16-bit samples cut to their
    high byte, turned upright by the eXIf chunk's orientation."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError('not a PNG file')
    pos, header, idat = len(_PNG_MAGIC), None, []
    palette = trns = None
    orientation = 1
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from('>I4s', data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'PLTE':
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
        elif ctype == b'tRNS':
            trns = body
        elif ctype == b'eXIf':
            orientation = _exif_orientation(body)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ValueError('corrupt PNG: no IHDR')
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_DEPTHS:
        raise ValueError(f'PNG color type {color} is not supported')
    if depth not in _PNG_DEPTHS[color]:
        raise ValueError(f'{depth}-bit PNG of color type {color} is not '
                         'supported')
    if interlace > 1:
        raise ValueError(f'PNG interlace method {interlace} is not supported')
    if color == 3 and palette is None:
        raise ValueError('corrupt PNG: palette image without PLTE')
    # libpng drops a tRNS chunk of the wrong size (png_handle_tRNS): a gray
    # or RGB key is one 16-bit sample a channel, a palette's alphas are at
    # most one an entry
    if trns is not None and not (
            len(trns) == 2 if color == 0 else len(trns) == 6 if color == 2
            else color == 3 and 0 < len(trns) <= palette.size // 3):
        trns = None
    samples = 1 if color == 3 else _PNG_SAMPLES[color]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if not interlace:
        img, _ = _png_samples(raw, 0, width, height, samples, depth)
    else:
        img = np.empty((height, width, samples),
                       np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:
                img[y0::dy, x0::dx], at = _png_samples(raw, at, pw, ph,
                                                       samples, depth)
    if color == 3:   # palette: colors (and alphas) of the indices
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[:palette.size // 3, :3] = palette.reshape(-1, 3)
        alpha = trns is not None
        if alpha:
            lut[:len(trns), 3] = np.frombuffer(trns, np.uint8)
        img = lut[img[..., 0], :4 if alpha else 3]
    elif color == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    elif color == 2 and trns is not None:
        key = np.frombuffer(trns, '>u2').astype(img.dtype)
        top = 65535 if depth == 16 else 255
        img = np.concatenate([img, np.where(
            (img == key).all(-1, keepdims=True), 0, top).astype(img.dtype)],
            -1)
    channels = img.shape[-1]
    if flags == IMREAD_COLOR:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        img = (np.repeat(img[..., :1], 3, axis=2) if channels <= 2
               else img[..., 2::-1])
        return apply_orientation(img, orientation)
    if channels == 1:
        return img[..., 0]
    if channels == 2:   # gray + alpha → BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0] if channels == 3 else [2, 1, 0, 3]
    return np.ascontiguousarray(img[..., order])


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data)))


def write_png(path, img: np.ndarray) -> None:
    """`img` written to `path` as cv2.imwrite writes a PNG: (H, W) uint8 or
    uint16 gray, or (H, W, 3) uint8 in cv2's BGR order (stored as RGB);
    filter type 0 on every row, zlib level 6. `decode_png` and cv2.imread
    give `img` back."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color, samples = 16, 0, img.astype('>u2').view(np.uint8)
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, color, samples = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color, samples = 8, 2, img[..., ::-1]
    else:
        raise ValueError(f'a PNG of a {img.dtype} array of shape '
                         f'{img.shape}: (H, W) uint8 / uint16 or (H, W, 3) '
                         'uint8 only')
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + samples[0].size), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(samples).reshape(h, -1)
    Path(path).write_bytes(
        _PNG_MAGIC
        + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, color, 0,
                                          0, 0))
        + _png_chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b'IEND', b''))


# --------------------------------------------------------------------------
# Netpbm (PBM / PGM / PPM)
# --------------------------------------------------------------------------
_PNM_SPACE = frozenset(b' \t\n\v\f\r')


class _PnmReader:
    """cv2's PxM byte stream: `number` is grfmt_pxm.cpp's ReadNumber
    (comments to the end of the line and whitespace skipped, anything
    else refused; the byte after the digits is consumed unless `digits`
    stopped it)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError('corrupt PNM: truncated')
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, digits: int = 0) -> int:
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:   # '#': a comment to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _PNM_SPACE:
                while code in _PNM_SPACE:
                    code = self.byte()
            else:
                raise ValueError(f'corrupt PNM: unexpected byte {code:#x}')
        val, n = 0, 0
        while True:
            val = val * 10 + code - 48
            if val > 2**31 - 1:
                raise ValueError('corrupt PNM: number too large')
            n += 1
            if digits and n >= digits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError('corrupt PNM: truncated')
        self.pos += n
        return self.data[self.pos - n:self.pos]


def decode_pnm(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """P1-P6 bytes → the array cv2.imdecode gives (grfmt_pxm.cpp).

    IMREAD_UNCHANGED: bitmaps (P1 / P4) as uint8 gray, 0 → 255 and 1 → 0;
    gray maps (P2 / P5) and pixmaps (P3 / P6) as uint8 when maxval ≤ 255,
    else uint16 (big-endian samples, whatever the maxval), pixmaps in BGR
    order. Binary samples are taken as stored; ASCII samples are clamped to
    maxval, and 8-bit ones scaled to 255 (`v * 255 // maxval`).
    IMREAD_COLOR: 3 channels of uint8, 16-bit samples cut to their high
    byte, gray replicated."""
    if len(data) < 2 or data[0] != 0x50 or not 0x31 <= data[1] <= 0x36:
        raise ValueError('not a PNM file')
    kind = data[1] - 0x30
    binary = kind >= 4
    bits = {1: 1, 2: 8, 3: 24}[kind - 3 if binary else kind]
    r = _PnmReader(data, 2)
    width, height = r.number(), r.number()
    maxval = r.number() if bits > 1 else 1
    if maxval > 65535:
        raise ValueError(f'corrupt PNM: maxval {maxval} above 65535')
    if width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError(f'corrupt PNM: {width}x{height}, maxval {maxval}')
    channels = 3 if bits == 24 else 1
    count = width * height * channels
    if bits == 1:
        if binary:
            pitch = (width + 7) // 8
            raw = np.frombuffer(r.take(pitch * height), np.uint8)
            ones = np.unpackbits(raw.reshape(height, pitch), axis=1,
                                 count=width)
        else:
            ones = np.array([r.number(1) != 0 for _ in range(count)],
                            np.uint8).reshape(height, width)
        img = np.where(ones != 0, 0, 255).astype(np.uint8)
    else:
        wide = maxval > 255
        if binary:
            size = 2 if wide else 1
            raw = r.take(count * size)
            img = (np.frombuffer(raw, '>u2').astype(np.uint16) if wide
                   else np.frombuffer(raw, np.uint8).copy())
        else:
            img = np.minimum([r.number() for _ in range(count)], maxval)
            img = (img.astype(np.uint16) if wide
                   else (img * 255 // maxval).astype(np.uint8))
        img = img.reshape(height, width, channels)
        if channels == 3:
            img = np.ascontiguousarray(img[..., ::-1])
        if flags == IMREAD_COLOR and wide:
            img = (img >> 8).astype(np.uint8)
        if channels == 1:
            img = img[..., 0]
    if flags == IMREAD_COLOR and img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img


# --------------------------------------------------------------------------
def decode(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Image bytes → array, by the magic bytes (cv2.imdecode), for
    IMREAD_COLOR or IMREAD_UNCHANGED."""
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED):
        raise ValueError(f'flags {flags}: IMREAD_COLOR (1) or '
                         'IMREAD_UNCHANGED (-1) only')
    if data.startswith(b'\xff\xd8'):
        return decode_jpeg(data, flags)
    if data.startswith(_PNG_MAGIC):
        return decode_png(data, flags)
    if (len(data) > 2 and data[0] == 0x50 and 0x31 <= data[1] <= 0x36
            and data[2] in _PNM_SPACE):
        return decode_pnm(data, flags)
    raise ValueError('unknown image format (not JPEG, PNG or PNM)')


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """cv2.imread for the port's formats; raises FileNotFoundError where
    cv2 would return None for a missing file."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(path) from None
    try:
        return decode(data, flags)
    except ValueError as e:
        raise ValueError(f'{path}: {e}') from None
