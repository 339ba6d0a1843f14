"""`cv2.resize(img, (w, h), interpolation=INTER_LINEAR)` for uint8, in numpy.

The JAX package resizes each view with cv2 (data/transforms.py::Resize),
so this reproduces OpenCV's fixed-point bilinear path (imgproc/src/
resize.cpp, `resizeGeneric_` with `HResizeLinear` and `VResizeLinear`)
bit for bit:

- per destination column and row, `f = (float)((d + 0.5) * scale - 0.5)`
  with `scale = 1 / (dst / src)` in double, `s = floor(f)`, `f -= s`; the
  weights are `rint((1 - f) * 2048)` and `rint(f * 2048)` (int16);
- a column whose source index is below 0 or at `src - 1` or above takes
  `f = 0` on the clamped index; a row keeps its weights and reads the
  clamped rows `s` and `s + 1` (OpenCV clamps the two differently, which
  shows when upscaling: the first and last rows then sum two truncated
  products of one source row);
- the horizontal pass sums `src[s] * a0 + src[s + 1] * a1` in int32;
- the vertical pass is OpenCV's SIMD form
  `(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2` on
  every element, a row's tail included (its scalar form,
  `(S0 * b0 + S1 * b1 + 2**21) >> 22`, rounds once and differs);
- an exact 2x downscale in both directions takes OpenCV's area path,
  which gives the same bytes as the formula above; equal sizes copy.
"""
from __future__ import annotations

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _coefficients(src: int, dst: int, clamp_weights: bool):
    """Clamped source indices (s, s + 1) and int16 weights per output;
    `clamp_weights` sets f = 0 where s is clamped (columns only)."""
    scale = 1.0 / (dst / src)
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        f[(s < 0) | (s >= src - 1)] = 0
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            w0.astype(np.int32), w1.astype(np.int32))


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) image → (h, w[, C]) for `size=(w, h)`,
    as `cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`."""
    if img.dtype != np.uint8:
        raise TypeError(f'resize_bilinear_u8 takes uint8, got {img.dtype}')
    if img.ndim not in (2, 3):
        raise ValueError(f'expected (H, W) or (H, W, C), got {img.shape}')
    dst_w, dst_h = int(size[0]), int(size[1])
    src_h, src_w = img.shape[:2]
    if (dst_w, dst_h) == (src_w, src_h):
        return img.copy()
    x0, x1, a0, a1 = _coefficients(src_w, dst_w, True)
    y0, y1, b0, b1 = _coefficients(src_h, dst_h, False)
    cn = 1 if img.ndim == 2 else img.shape[2]
    src = img.reshape(src_h, src_w * cn)
    # per element of a row: source elements and weights
    lane = np.arange(cn)
    e0 = (x0[:, None] * cn + lane).ravel()
    e1 = (x1[:, None] * cn + lane).ravel()
    w0 = np.repeat(a0, cn)
    w1 = np.repeat(a1, cn)
    # horizontal pass over the source rows the vertical pass reads
    rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    part = src[rows]
    hor = part[:, e0].astype(np.int32) * w0
    hor += part[:, e1].astype(np.int32) * w1
    s0 = hor[inv[:dst_h]]
    if not b1.any():
        # every row on a source row: b0 = 2048, b1 = 0, and
        # (2048 * (S >> 4)) >> 16 == S >> 9
        out = ((s0 >> 9) + 2) >> 2
    else:
        s1 = hor[inv[dst_h:]]
        out = (((b0[:, None] * (s0 >> 4)) >> 16)
               + ((b1[:, None] * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (dst_h, dst_w) + img.shape[2:])
