"""Image files → numpy arrays without cv2 or PIL, byte-equal with cv2.

`imread(path, flags)` stands in for `cv2.imread` where the JAX package
calls it (data/transforms.py: `LoadImageFromFile`, IMREAD_COLOR → BGR
uint8 H×W×3; `LoadDepthFromFile`, IMREAD_UNCHANGED → uint16 H×W for a
16-bit PNG). The format is chosen by the file's magic bytes, not its
extension.

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
def _check_orientation(orientation: int, flags: int) -> None:
    """cv2 rotates an image by its EXIF orientation under IMREAD_COLOR
    (not under IMREAD_UNCHANGED); the port refuses to differ silently."""
    if flags == IMREAD_COLOR and orientation not in (0, 1):
        raise ValueError(f'EXIF orientation {orientation} is not supported '
                         'under IMREAD_COLOR (cv2 would rotate the image)')


def decode_jpeg(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """JPEG bytes → BGR uint8 (H, W, 3); under IMREAD_UNCHANGED a
    one-component image stays (H, W)."""
    lib = _library()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c, orient = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
                       ctypes.c_int())
    if lib.ptt_jpeg_info(buf.ctypes.data, len(buf), ctypes.byref(h),
                         ctypes.byref(w), ctypes.byref(c),
                         ctypes.byref(orient), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    _check_orientation(orient.value, flags)
    gray = flags == IMREAD_UNCHANGED and c.value == 1
    channels = 1 if gray else 3
    out = np.empty((h.value, w.value, channels), np.uint8)
    if lib.ptt_jpeg_decode(buf.ctypes.data, len(buf), out.ctypes.data,
                           h.value, w.value, channels, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out[..., 0] if gray else out


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


def decode_png(data: bytes, flags: int = IMREAD_UNCHANGED) -> np.ndarray:
    """PNG bytes → the array cv2.imread gives: 16-bit samples as native
    uint16, color as BGR(A). IMREAD_COLOR gives 3 channels (gray
    replicated, alpha dropped, 16-bit samples cut to their high byte);
    IMREAD_UNCHANGED keeps the file's channels (gray + alpha as BGRA)."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError('not a PNG file')
    pos, header, idat = len(_PNG_MAGIC), None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from('>I4s', data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'PLTE':
            raise ValueError('palette PNG is not supported')
        elif ctype == b'tRNS':
            raise ValueError('PNG with a tRNS chunk is not supported')
        elif ctype == b'eXIf':
            _check_orientation(_exif_orientation(body), flags)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ValueError('corrupt PNG: no IHDR')
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError('interlaced PNG is not supported')
    if color not in _PNG_SAMPLES:
        raise ValueError(f'PNG color type {color} is not supported')
    if depth not in (8, 16):
        raise ValueError(f'{depth}-bit PNG is not supported')
    samples = _PNG_SAMPLES[color]
    bpp = samples * depth // 8
    rowbytes = width * bpp
    raw = zlib.decompress(b''.join(idat))
    if len(raw) < height * (rowbytes + 1):
        raise ValueError('corrupt PNG: image data too short')
    raw = np.frombuffer(raw, np.uint8)
    out = np.empty(height * rowbytes, np.uint8)
    if _library().ptt_png_unfilter(raw.ctypes.data, height, rowbytes, bpp,
                                   out.ctypes.data):
        raise ValueError('corrupt PNG: unknown filter type')
    if depth == 16:
        img = out.view('>u2').astype(np.uint16)
    else:
        img = out
    img = img.reshape(height, width, samples)
    if flags == IMREAD_COLOR:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        if samples <= 2:
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., 2::-1])
    if samples == 1:
        return img[..., 0]
    if samples == 2:   # gray + alpha → BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0] if samples == 3 else [2, 1, 0, 3]
    return np.ascontiguousarray(img[..., order])


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
    raise ValueError('unknown image format (neither JPEG nor PNG)')


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
