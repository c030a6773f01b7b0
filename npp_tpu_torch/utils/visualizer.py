"""2-D lattice visualiser (reference: utils/periodicity_visualizer.py:5-71).

A copy of `npp_tpu/utils/visualizer.py` whose lines are drawn by a numpy
rasterizer (`line_mask`) instead of cv2.line, which the card's machine
lacks. Draws the detected lattice (base point + two displacement vectors)
over an image by solving for the lattice extents that cover the canvas.
The picture is an artefact of the search's save=True that nothing reads
back; `line_mask_of` follows OpenCV's thick-line drawing step by step,
and tests/test_torch_png.py holds its mask to cv2.line's (IoU >= 0.95).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class GridProgram:
    def __init__(self, resolution, base_point, first_shift, second_shift):
        self.resolution = tuple(resolution)
        self.base_point = np.asarray(base_point, np.float64)   # (x, y)
        self.first_shift = np.asarray(first_shift, np.float64)  # (dx, dy)
        self.second_shift = np.asarray(second_shift, np.float64)

    def _fit_resolution(self, target_hw):
        old_h, old_w = self.resolution
        new_h, new_w = target_hw
        ratio = np.array([new_w / old_w, new_h / old_h])
        self.base_point = np.round(self.base_point * ratio).astype(np.int64)
        self.first_shift = self.first_shift * ratio
        self.second_shift = self.second_shift * ratio

    def _gen_ij(self, canvas_hw):
        corners = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float64)
        vecs = corners * np.array(canvas_hw[::-1]) - self.base_point
        m = np.stack([self.first_shift, self.second_shift], axis=1)
        coords = np.linalg.inv(m) @ vecs.T
        i_min, j_min = np.floor(coords.min(axis=1)).astype(int)
        i_max, j_max = np.ceil(coords.max(axis=1)).astype(int)
        return i_min, i_max, j_min, j_max

    def draw(self, image: np.ndarray, color=(255, 255, 0), thickness=2
             ) -> Tuple[np.ndarray, np.ndarray]:
        """image: (H, W, 3) uint8 RGB -> (drawn image, line mask)."""
        self._fit_resolution(image.shape[:2])
        canvas = image.copy()
        i_min, i_max, j_min, j_max = self._gen_ij(canvas.shape[:2])

        i_base = self.base_point + np.arange(i_min, i_max)[:, None] * self.first_shift
        i_lines = np.concatenate([i_base + j_min * self.second_shift,
                                  i_base + j_max * self.second_shift], axis=1)
        j_base = self.base_point + np.arange(j_min, j_max)[:, None] * self.second_shift
        j_lines = np.concatenate([j_base + i_min * self.first_shift,
                                  j_base + i_max * self.first_shift], axis=1)

        lines = np.round(np.concatenate([i_lines, j_lines])).astype(np.int32)
        line_mask = np.zeros(canvas.shape[:2], np.int32)
        for ln in lines:
            line_mask += line_mask_of(canvas.shape[:2], ln[:2], ln[2:],
                                      thickness)
        canvas[line_mask > 0] = color
        return canvas, line_mask


XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine in integers: the segment clipped to the image, or
    None where none of it is inside."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line_fixed(out: np.ndarray, p1, p2) -> None:
    """OpenCV's Line2: a one-pixel line between XY_SHIFT fixed-point
    points, clipped to the image in fixed point, stepping a pixel along
    the longer axis and rounding the other."""
    h, w = out.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1],
                         p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        x_step, y_step = _tdiv(dx << XY_SHIFT, abs(dy) | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            out[y, x] = 1

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    k = np.arange(count + 1)
    if x_step == XY_ONE:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * y_step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * x_step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out[ys[ok], xs[ok]] = 1


def _fill_convex_poly(out: np.ndarray, v) -> None:
    """OpenCV's FillConvexPoly (LINE_8, corners in XY_SHIFT fixed point):
    the outline's fixed-point lines, then each row from the left edge to
    the right edge, both rounded, the edges walked by a per-row step."""
    h, w = out.shape
    n = len(v)
    delta = XY_ONE >> 1
    for i in range(n):
        _line_fixed(out, v[i - 1], v[i])
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin = (min(p[0] for p in v) + delta) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + delta) >> XY_SHIFT
    ymin = (min(ys) + delta) >> XY_SHIFT
    ymax = (max(ys) + delta) >> XY_SHIFT
    if xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = [{'idx': imin, 'di': 1, 'ye': ymin, 'x': -XY_ONE, 'dx': 0},
             {'idx': imin, 'di': n - 1, 'ye': ymin, 'x': -XY_ONE, 'dx': 0}]
    remain = n
    y = ymin
    while True:
        for e in edges:
            if y >= e['ye']:
                idx0 = e['idx']
                idx = (idx0 + e['di']) % n
                while remain > 0:
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e.update(ye=ty, x=xs, idx=idx, dx=_tdiv(
                            (xe - xs) * 2 + (ty - y), 2 * (ty - y)))
                        break
                    idx0, idx = idx, (idx + e['di']) % n
                    remain -= 1
        if remain < 0:
            break
        if y >= 0:
            xl, xr = sorted((edges[0]['x'], edges[1]['x']))
            x1, x2 = (xl + delta) >> XY_SHIFT, (xr + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                out[y, max(x1, 0):min(x2, w - 1) + 1] = 1
        for e in edges:
            e['x'] += e['dx']
        y += 1
        if y > ymax:
            break


def _disc(out: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled Circle: its midpoint walk, a row span per step."""
    h, w = out.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1

    def span(y, xa, xb):
        if 0 <= y < h and xb >= 0 and xa < w:
            out[y, max(xa, 0):min(xb, w - 1) + 1] = 1

    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line_mask_of(hw, p0, p1, thickness: int = 2) -> np.ndarray:
    """(H, W) uint8 mask of what cv2.line(img, p0, p1, thickness) paints
    for thickness > 1 ((x, y) integer points): OpenCV's ThickLine, the
    segment widened to a four-corner polygon in 16-bit fixed point, filled,
    and a disc at each end, after clipping the segment to the image grown
    by `thickness` on every side (as OpenCV 5 does: its lines then match
    pixel for pixel)."""
    out = np.zeros(tuple(hw), np.uint8)
    m = int(thickness)
    clipped = _clip_line(hw[1] + 2 * m, hw[0] + 2 * m, int(p0[0]) + m,
                         int(p0[1]) + m, int(p1[0]) + m, int(p1[1]) + m)
    if clipped is None:
        return out
    (x0, y0), (x1, y1) = ((clipped[0] - m) << XY_SHIFT,
                          (clipped[1] - m) << XY_SHIFT), \
        ((clipped[2] - m) << XY_SHIFT, (clipped[3] - m) << XY_SHIFT)
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r2 = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if r2 > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / np.sqrt(r2)
        # cvRound: round half to even
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(out, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)])
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _disc(out, (x + (XY_ONE >> 1)) >> XY_SHIFT,
              (y + (XY_ONE >> 1)) >> XY_SHIFT, radius)
    return out


def mask2ltrb(mask: np.ndarray) -> np.ndarray:
    """(left, top, right, bottom) of the mask's bounding box
    (reference: utils/miscs.py:17-20)."""
    ys, xs = np.nonzero(np.asarray(mask).squeeze())
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()])
