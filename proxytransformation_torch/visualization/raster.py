"""8-connected line drawing without OpenCV.

The JAX package's `ImgDrawer` draws each box edge with `cv2.line(img,
pt1, pt2, color, thickness)` (LINE_8, shift 0). This module replays that
call in integer arithmetic, pixel for pixel (OpenCV's
imgproc/src/drawing.cpp: `ThickLine`, `Line` through `LineIterator`,
`Line2`, `FillConvexPoly`, `Circle`, `clipLine`):

- thickness 1: a Bresenham line between the two endpoints, drawn left to
  right after both are clipped to the image;
- thickness > 1: the segment clipped to the image grown by the
  thickness on every side, then offset by the rounded unit normal
  (16-bit fixed point) on both sides: a convex quadrilateral whose
  outline is traced in fixed point and whose interior is filled
  scanline by scanline, and a filled disc of radius (thickness + 1) // 2
  at each end.

Endpoints far outside the image are clipped as OpenCV clips them (in 64
bits, the intercepts in double), so every coordinate past the clip is
small; endpoints outside int32 raise, as cv2's argument parser does.
"""
from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
MAX_THICKNESS = 32767
_INV_XY_ONE = 1.0 / XY_ONE
_DBL_EPSILON = 2.220446049250313e-16
_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _point(pt) -> Tuple[int, int]:
    """An endpoint as cv2 parses it: two integers inside int32."""
    if len(pt) != 2:
        raise ValueError(f'a point has two coordinates, got {pt!r}')
    out = []
    for v in pt:
        if isinstance(v, (bool, np.bool_)) or not isinstance(
                v, numbers.Integral):
            raise TypeError(f'point coordinates are integers, got {pt!r}')
        if not _INT32_MIN <= int(v) <= _INT32_MAX:
            raise OverflowError(f'point coordinate {int(v)} is outside '
                                'int32')
        out.append(int(v))
    return out[0], out[1]


def _pixel(img: np.ndarray, color) -> np.ndarray:
    """The color as one pixel of `img` (cv2's `scalarToRawData`: four
    channels at most, missing ones 0, integer depths rounded half to
    even and saturated)."""
    cn = 1 if img.ndim == 2 else img.shape[2]
    if cn > 4:
        raise ValueError(f'{cn} channels: at most 4')
    vals = list(color) if isinstance(color, (tuple, list, np.ndarray)) \
        else [color]
    vals = [float(v) for v in vals][:4] + [0.0] * (4 - min(len(vals), 4))
    vals = np.asarray(vals[:cn], np.float64)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        vals = np.clip(np.rint(vals), info.min, info.max)
    return vals.astype(img.dtype)


class _Canvas:
    """Collects the pixels a call sets, then writes them at once."""

    def __init__(self, img: np.ndarray):
        self.h, self.w = img.shape[:2]
        self.ys, self.xs = [], []

    def put(self, ys: np.ndarray, xs: np.ndarray) -> None:
        keep = (ys >= 0) & (ys < self.h) & (xs >= 0) & (xs < self.w)
        self.ys.append(ys[keep])
        self.xs.append(xs[keep])

    def hline(self, y: int, x1: int, x2: int) -> None:
        """Pixels x1..x2 of row y (both inside the image)."""
        if x1 <= x2:
            xs = np.arange(x1, x2 + 1, dtype=np.int64)
            self.ys.append(np.full(len(xs), y, np.int64))
            self.xs.append(xs)

    def flush(self, img: np.ndarray, pix: np.ndarray) -> None:
        if self.ys:
            ys = np.concatenate(self.ys).astype(np.intp)
            xs = np.concatenate(self.xs).astype(np.intp)
            img[ys, xs] = pix


def _clip_line(width: int, height: int, x1: int, y1: int, x2: int,
               y2: int) -> Optional[Tuple[int, int, int, int]]:
    """OpenCV's `clipLine(Size2l, Point2l&, Point2l&)`: the segment
    clipped to [0, width) x [0, height), or None when it misses the
    rectangle (64-bit integers, the intercepts in double and truncated;
    the second endpoint's intercept uses the first's clipped value, as
    OpenCV's does)."""
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return None

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
        if not ((c1 & c2) != 0 or min(x1, y1, x2, y2) >= 0):
            raise RuntimeError('a clipped endpoint lies outside the image '
                               '(OpenCV asserts here)')
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _bresenham(canvas: _Canvas, x1: int, y1: int, x2: int, y2: int) -> None:
    """`Line` through `LineIterator` (8-connected, left to right): the
    minor coordinate of step k is ceil((2·d_minor·k − d_major) /
    (2·d_major)), which is where the iterator's error term goes
    negative."""
    w, h = canvas.w, canvas.h
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    k = np.arange(max(dx, dy) + 1, dtype=np.int64)
    if dy > dx:
        minor = (2 * dx * k + dy - 1) // (2 * dy)
        canvas.put(y1 + sy * k, x1 + minor)
    else:
        minor = (2 * dy * k + dx - 1) // (2 * dx) if dx else k * 0
        canvas.put(y1 + sy * minor, x1 + k)


def _line_fixed(canvas: _Canvas, x1: int, y1: int, x2: int, y2: int) -> None:
    """`Line2`: a line between 16-bit fixed-point endpoints, one pixel a
    step along the major axis, the minor coordinate advanced by the
    truncated fixed-point slope."""
    clipped = _clip_line(canvas.w << XY_SHIFT, canvas.h << XY_SHIFT,
                         x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = XY_ONE
        y_step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _tdiv(dx << XY_SHIFT, ay | 1)
        y_step = XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    k = np.arange(max(ecount, -1) + 1, dtype=np.int64)
    xs = np.concatenate([[x2 + half], x1 + half + k * x_step])
    ys = np.concatenate([[y2 + half], y1 + half + k * y_step])
    canvas.put(ys >> XY_SHIFT, xs >> XY_SHIFT)


def _fill_convex_poly(canvas: _Canvas, v: Sequence[Tuple[int, int]]
                      ) -> None:
    """`FillConvexPoly` (LINE_8, shift XY_SHIFT) of fixed-point vertices:
    the outline by `_line_fixed`, then the rows between its two edge
    chains, each edge's x advanced by its rounded fixed-point slope a
    row."""
    npts = len(v)
    half = XY_ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line_fixed(canvas, p0[0], p0[1], p[0], p[1])
        p0 = p
    xmin, xmax = (xmin + half) >> XY_SHIFT, (xmax + half) >> XY_SHIFT
    ymin, ymax = (ymin + half) >> XY_SHIFT, (ymax + half) >> XY_SHIFT
    if (npts < 3 or xmax < 0 or ymax < 0 or xmin >= canvas.w
            or ymin >= canvas.h):
        return
    ymax = min(ymax, canvas.h - 1)
    y = ymin
    # per edge chain: vertex index, direction, x, dx and the row it ends
    idx = [imin, imin]
    di = [1, npts - 1]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    ye = [y, y]
    edges = npts
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                nxt = idx0 + di[i]
                if nxt >= npts:
                    nxt -= npts
                while True:
                    edges -= 1
                    if edges + 1 <= 0:
                        break
                    ty = (v[nxt][1] + half) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[nxt][0]
                        ye[i] = ty
                        edx[i] = _tdiv((xe - xs) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs
                        idx[i] = nxt
                        break
                    idx0 = nxt
                    nxt += di[i]
                    if nxt >= npts:
                        nxt -= npts
        if edges < 0:
            break
        # rows y .. stop-1 see no change of edge
        stop = min(ye[0], ye[1], ymax + 1)
        lo = max(y, 0)
        if lo < stop:
            r = np.arange(lo - y, stop - y, dtype=np.int64)
            x0, x1 = ex[0] + edx[0] * r, ex[1] + edx[1] * r
            left, right = np.minimum(x0, x1), np.maximum(x0, x1)
            xx1 = (left + half) >> XY_SHIFT
            xx2 = (right + half) >> XY_SHIFT
            for row, a, b in zip(range(lo, stop), xx1.tolist(),
                                 xx2.tolist()):
                if b >= 0 and a < canvas.w:
                    canvas.hline(row, max(a, 0), min(b, canvas.w - 1))
        ex = [ex[0] + edx[0] * (stop - y), ex[1] + edx[1] * (stop - y)]
        y = stop
        if y > ymax:
            break


def _circle(canvas: _Canvas, cx: int, cy: int, radius: int) -> None:
    """`Circle` with `fill`: the midpoint circle's rows, clipped."""
    w, h = canvas.w, canvas.h
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    canvas.hline(yy, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        canvas.hline(yy, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, pt1, pt2, color, thickness)` (LINE_8, shift 0) on a
    2-D or (H, W, C) array, in place; returns `img`."""
    if not isinstance(img, np.ndarray) or img.ndim not in (2, 3):
        raise TypeError('img is a 2-D or 3-D numpy array')
    if not img.flags.writeable:
        raise ValueError('img is read-only')
    x0, y0 = _point(pt1)
    x1, y1 = _point(pt2)
    thickness = int(thickness)
    if not 0 < thickness <= MAX_THICKNESS:
        raise ValueError(f'thickness {thickness}: 1..{MAX_THICKNESS} '
                         '(a filled shape is not a line)')
    pix = _pixel(img, color)
    canvas = _Canvas(img)
    if thickness > 1:
        # the segment first clipped, in 64 bits, to the image grown by
        # the thickness on every side
        t = thickness
        clipped = _clip_line(canvas.w + 2 * t, canvas.h + 2 * t, x0 + t,
                             y0 + t, x1 + t, y1 + t)
        if clipped is None:
            return img
        x0, y0, x1, y1 = (v - t for v in clipped)
    if thickness <= 1:
        _bresenham(canvas, x0, y0, x1, y1)
        canvas.flush(img, pix)
        return img
    p0 = (x0 << XY_SHIFT, y0 << XY_SHIFT)
    p1 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    dx = float(p0[0] - p1[0]) * _INV_XY_ONE
    dy = float(p1[1] - p0[1]) * _INV_XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > _DBL_EPSILON:
        r = (th + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex_poly(canvas, [(p0[0] + dpx, p0[1] + dpy),
                                   (p0[0] - dpx, p0[1] - dpy),
                                   (p1[0] - dpx, p1[1] - dpy),
                                   (p1[0] + dpx, p1[1] + dpy)])
    radius = (th + (XY_ONE >> 1)) >> XY_SHIFT
    for p in (p0, p1):
        _circle(canvas, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                (p[1] + (XY_ONE >> 1)) >> XY_SHIFT, radius)
    canvas.flush(img, pix)
    return img
