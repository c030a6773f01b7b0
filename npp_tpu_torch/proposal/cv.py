"""OpenCV-free versions of the four OpenCV calls that periodicity detection
makes (`npp_tpu/proposal/features.py:34-56, 93-114`), in numpy on the host.

Each gives the same uint8 bits as the OpenCV call it replaces, because the
candidates come from an argsort over a loss grid built from these edges:
one flipped edge pixel can change a candidate.

 - `rgb2gray`: cv2.cvtColor(RGB2GRAY) on uint8, OpenCV's 15-bit fixed-point
   weights 9798, 19235 and 3735, rounded half up.
 - `resize_nearest`: cv2.resize INTER_NEAREST, source index
   floor(x * src/dst) clamped to the last pixel.
 - `resize_linear_u8`: cv2.resize INTER_LINEAR on uint8. An exact 2x
   reduction is OpenCV's fast area path, (a + b + c + d + 2) >> 2; any
   other size is OpenCV's 11-bit fixed-point bilinear with its half-pixel
   source mapping and edge clamps, and the vertical pass's rounding
   through 16-bit high products.
 - `gaussian_blur3`: cv2.GaussianBlur((3, 3), 0) on uint8: the [1, 2, 1]
   kernel in both directions, BORDER_REFLECT_101, (sum + 8) >> 4.
 - `canny`: cv2.Canny(img, low, high) with the 3x3 Sobel on
   BORDER_REPLICATE, the L1 magnitude, OpenCV's tan(22.5 deg) fixed-point
   non-maximum suppression with its asymmetric > / >= tests, magnitude
   zero outside the image, thresholds by `>`, and 8-connected hysteresis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.ndimage as ndimage

_R2Y, _G2Y, _B2Y, _GRAY_SHIFT = 9798, 19235, 3735, 15
_COEF_BITS = 11                   # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 gray."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError('rgb2gray takes an (H, W, 3) uint8 image')
    c = img.astype(np.int32)
    y = c[..., 0] * _R2Y + c[..., 1] * _G2Y + c[..., 2] * _B2Y
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def resize_nearest(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, dsize=(width, height), interpolation=INTER_NEAREST),
    any dtype, 2-D or with trailing channels."""
    dw, dh = dsize
    h, w = img.shape[:2]
    fx, fy = 1.0 / (dw / w), 1.0 / (dh / h)
    xs = np.minimum(np.floor(np.arange(dw) * fx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * fy).astype(np.int64), h - 1)
    return img[ys][:, xs]


def _linear_taps(dst: int, src: int, clamp_weights: bool):
    """Source indices and 11-bit weights of each output pixel along one axis
    (OpenCV's resize: f = (d + 0.5) * scale - 0.5 in float32). Both
    indices are clamped into the image; along x (`clamp_weights`) a source
    position past an edge also takes the edge pixel at full weight, along
    y the weights stay as computed. Returns (s0, s1, w0, w1)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= src - 1
        f[high], s[high] = 0.0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, dsize=(width, height)) (INTER_LINEAR) of a 2-D uint8
    image."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError('resize_linear_u8 takes a 2-D uint8 image')
    dw, dh = dsize
    h, w = img.shape
    if (dw, dh) == (w, h):
        return img.copy()
    src = img.astype(np.int64)
    if w == 2 * dw and h == 2 * dh:       # OpenCV's fast 2x2 area path
        s = src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] + \
            src[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    xs0, xs1, a0, a1 = _linear_taps(dw, w, True)
    ys0, ys1, b0, b1 = _linear_taps(dh, h, False)
    # horizontal pass: exact integers
    rows = src[:, xs0] * a0 + src[:, xs1] * a1
    # vertical pass: 16-bit high products of the rows shifted by 4, then a
    # rounding shift by 2 (OpenCV's vectorised VResizeLinear for uint8)
    hi = ((rows[ys0] >> 4) * b0[:, None] >> 16) + \
        ((rows[ys1] >> 4) * b1[:, None] >> 16)
    return np.clip((hi + 2) >> 2, 0, 255).astype(np.uint8)


def gaussian_blur3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), 0) of a 2-D uint8 image."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError('gaussian_blur3 takes a 2-D uint8 image')
    p = np.pad(img.astype(np.int64), 1, mode='reflect')   # REFLECT_101
    v = p[:-2] + 2 * p[1:-1] + p[2:]
    s = v[:, :-2] + 2 * v[:, 1:-1] + v[:, 2:]
    return ((s + 8) >> 4).astype(np.uint8)


def sobel3(img: np.ndarray):
    """The 3x3 Sobel derivatives (dx, dy) Canny takes, BORDER_REPLICATE,
    as int64."""
    p = np.pad(img.astype(np.int64), 1, mode='edge')
    sy = p[:-2] + 2 * p[1:-1] + p[2:]                 # smooth along y
    dx = sy[:, 2:] - sy[:, :-2]
    sx = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]        # smooth along x
    dy = sx[2:] - sx[:-2]
    return dx, dy


def canny(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """cv2.Canny(img, low, high) (aperture 3, L1 gradient) of a 2-D uint8
    image: 255 on edges, 0 elsewhere."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError('canny takes a 2-D uint8 image')
    if low > high:
        low, high = high, low
    lo, hi = int(np.floor(low)), int(np.floor(high))
    dx, dy = sobel3(img)
    mag = np.abs(dx) + np.abs(dy)
    h, w = img.shape
    m = np.zeros((h + 2, w + 2), np.int64)             # zero outside
    m[1:-1, 1:-1] = mag

    def nb(oy, ox):
        return m[1 + oy:h + 1 + oy, 1 + ox:w + 1 + ox]

    ax = np.abs(dx)
    ay = np.abs(dy) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg67x)
    diagonal = ~horizontal & ~vertical
    same_sign = (dx ^ dy) >= 0          # s = 1: (j-1, i-1) and (j+1, i+1)
    keep = np.where(
        horizontal, (mag > nb(0, -1)) & (mag >= nb(0, 1)),
        np.where(vertical, (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
                 np.where(same_sign,
                          (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                          (mag > nb(-1, 1)) & (mag > nb(1, -1)))))
    candidate = keep & (mag > lo)
    strong = candidate & (mag > hi)
    labels, n = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((h, w), np.uint8)
    hit = np.zeros(n + 1, bool)
    hit[labels[strong]] = True
    hit[0] = False
    return np.where(hit[labels], 255, 0).astype(np.uint8)
