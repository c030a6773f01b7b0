"""PNG reading and writing in numpy and zlib, without OpenCV.

The card's machine has no OpenCV, and the port reads and writes its
example directories and outputs as PNG files. This module gives the same
arrays as `cv2.imread` does for the files the port meets:

 - `read_png(path, 'rgb')` is `cv2.imread(path)` (IMREAD_COLOR) turned to
   RGB: alpha is dropped, gray is repeated into three channels, a palette
   is looked up;
 - `read_png(path, 'gray')` is `cv2.imread(path, 0)`: a gray file as it is,
   a colour file through libpng's rgb_to_gray, which OpenCV's decoder asks
   for with the weights 0.299 and 0.587: 15-bit fixed-point coefficients
   9797, 19234 and 3737, truncated, and a pixel whose three values are
   equal kept as it is.

Only non-interlaced 8-bit files are read (gray, gray + alpha, RGB, RGBA
and palette, with any of the five row filters); others raise. The writer
writes 8-bit gray or RGB with the up filter on every row. Byte
equality with OpenCV's files is not sought: the decoded pixels are equal.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# libpng's rgb_to_gray coefficients for png_set_rgb_to_gray(.., 0.299, 0.587)
_GRAY_R, _GRAY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes) -> List[tuple]:
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    out, pos = [], 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
        if kind == b'IEND':
            break
    return out


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int arrays, element by element."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) uint8 pixels from the decompressed stream of h filtered
    rows, each a filter byte and w * c bytes. Rows filtered by none, sub
    or up are undone a row at a time (sub is a running sum per channel);
    an image with average or Paeth rows is undone along its anti-diagonals,
    whose pixels depend only on the diagonal before (left, up, up-left)."""
    rows = raw[:h * (w * c + 1)].reshape(h, w * c + 1)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f'bad PNG row filter {ftype.max()}')
    line = rows[:, 1:].reshape(h, w, c).astype(np.int64)
    if ftype.max(initial=0) <= 2:
        out = np.zeros((h, w, c), np.int64)
        prev = np.zeros((w, c), np.int64)
        for y in range(h):
            cur = line[y]
            if ftype[y] == 1:
                cur = np.cumsum(cur, axis=0)
            elif ftype[y] == 2:
                cur = cur + prev
            out[y] = prev = cur & 255
        return out.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, c), np.int64)   # a zero row and column
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, cc = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        ft = ftype[ys][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> Dict[str, np.ndarray]:
    """{'pixels': (H, W, C) uint8 as stored (C = 1, 2, 3 or 4; a palette
    image gives its indices, C = 1), 'palette': (N, 3) uint8 or None,
    'color_type': int}."""
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b'IHDR':
        raise ValueError('PNG without IHDR')
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        '>IIBBBBB', chunks[0][1])
    if interlace != 0:
        raise ValueError('interlaced PNG files are not read')
    if depth != 8:
        raise ValueError(f'{depth}-bit PNG files are not read (8-bit only)')
    if ctype not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f'unsupported PNG (colour type {ctype})')
    c = _CHANNELS[ctype]
    idat = b''.join(body for kind, body in chunks if kind == b'IDAT')
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (w * c + 1):
        raise ValueError('truncated PNG image data')
    pix = _unfilter(raw, h, w, c)
    palette = None
    if ctype == 3:
        plte = [body for kind, body in chunks if kind == b'PLTE']
        if not plte:
            raise ValueError('palette PNG without PLTE')
        palette = np.frombuffer(plte[0], np.uint8).reshape(-1, 3)
    return {'pixels': pix, 'palette': palette, 'color_type': ctype}


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    gray = ((_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15).astype(np.uint8)
    return np.where((r == g) & (r == b), rgb[..., 0], gray)


def read_png(path: str, mode: str = 'rgb') -> np.ndarray:
    """(H, W, 3) uint8 RGB (mode 'rgb') or (H, W) uint8 (mode 'gray'), as
    cv2.imread(path) (reversed to RGB) and cv2.imread(path, 0) give them."""
    with open(path, 'rb') as f:
        dec = decode_png(f.read())
    pix, ctype = dec['pixels'], dec['color_type']
    if ctype == 3:
        idx = pix[..., 0]
        if idx.max(initial=0) >= len(dec['palette']):
            raise ValueError('palette index out of range')
        rgb = dec['palette'][idx]
    elif ctype in (2, 6):
        rgb = pix[..., :3]
    else:                              # gray or gray + alpha
        g = pix[..., 0]
        return g.copy() if mode == 'gray' else np.repeat(g[..., None], 3, -1)
    if mode == 'gray':
        return _rgb_to_gray(rgb)
    if mode != 'rgb':
        raise ValueError(f"mode must be 'rgb' or 'gray', not {mode!r}")
    return np.ascontiguousarray(rgb)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of (H, W) or (H, W, 1) gray or (H, W, 3) RGB uint8, every
    row with the up filter."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError('encode_png writes uint8 images')
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2}.get(img.shape[2]) if img.ndim == 3 else None
    if ctype is None:
        raise ValueError(f'encode_png takes gray or RGB, got {img.shape}')
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = np.concatenate([rows[:1], rows[1:] - rows[:-1]])   # uint8 wraps
    scan = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)
    out = SIGNATURE + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype,
                                                  0, 0, 0))
    out += _chunk(b'IDAT', zlib.compress(scan.tobytes(), 6))
    return out + _chunk(b'IEND', b'')


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) gray or (H, W, 3) RGB uint8 to `path`."""
    with open(path, 'wb') as f:
        f.write(encode_png(img))
