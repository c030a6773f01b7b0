"""The port's PNG codec (npp_tpu_torch/utils/png.py) and grid drawing
(utils/visualizer.py) against OpenCV on the CPU host.

Tolerance: pixel equality both ways. cv2 reads the port's files to the
arrays written, and the port reads cv2's files (gray, RGB, RGBA, each row
filter, palette, odd widths) to the arrays cv2.imread gives, IMREAD_COLOR
and flag 0. The grid's line mask is held to cv2.line's at IoU >= 0.95
(it matches pixel for pixel on every case here)."""
import struct
import zlib

import numpy as np
import pytest

from npp_tpu_torch.utils import io as TIO
from npp_tpu_torch.utils import png
from npp_tpu_torch.utils.visualizer import GridProgram, line_mask_of

cv2 = pytest.importorskip('cv2')

SIZES = [(37, 53), (64, 80), (5, 7), (1, 9)]
FILTERS = ('none', 'sub', 'up', 'average', 'paeth')


def _encode(img, filters, palette=None):
    """A test encoder for what the port's writer does not write: gray +
    alpha, RGBA and palette files, and rows filtered by filters[y % n]."""
    if img.ndim == 2:
        img = img[..., None]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[
        img.shape[2]]
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    scan = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        cur, name = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        pred = {'none': 0, 'sub': left, 'up': prev,
                'average': (left + prev) >> 1,
                'paeth': png._paeth(left, prev, up_left)}[name]
        scan.append(FILTERS.index(name))
        scan += ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    out = png.SIGNATURE + png._chunk(
        b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        out += png._chunk(b'PLTE', palette.tobytes())
    out += png._chunk(b'IDAT', zlib.compress(bytes(scan), 6))
    return out + png._chunk(b'IEND', b'')


def _image(seed, h, w, c):
    """Noise in the top half, a smooth wave below (cv2's encoder picks
    different row filters for the two)."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    wave = (128 + 100 * np.sin(yy / 3.0) * np.cos(xx / 5.0)).astype(np.uint8)
    img[h // 2:] = wave[h // 2:, :, None]
    return img


@pytest.mark.parametrize('h,w', SIZES)
@pytest.mark.parametrize('channels', [1, 3, 4])
def test_port_reads_cv2_files(tmp_path, h, w, channels):
    img = _image(h * w + channels, h, w, channels)
    path = str(tmp_path / 'a.png')
    cv2.imwrite(path, img[..., [2, 1, 0, 3][:channels]] if channels > 1
                else img[..., 0])
    np.testing.assert_array_equal(png.read_png(path, 'rgb'),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(png.read_png(path, 'gray'),
                                  cv2.imread(path, 0))


@pytest.mark.parametrize('filt', FILTERS)
@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_each_row_filter_against_cv2(tmp_path, filt, channels):
    """Files written with one row filter (gray + alpha included, which
    cv2 does not write) decode as cv2 decodes them."""
    img = _image(7, 23, 31, channels)
    path = str(tmp_path / 'f.png')
    with open(path, 'wb') as f:
        f.write(_encode(img, (filt,)))
    np.testing.assert_array_equal(png.read_png(path, 'rgb'),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(png.read_png(path, 'gray'),
                                  cv2.imread(path, 0))


def test_mixed_filters_and_palette(tmp_path):
    rng = np.random.RandomState(3)
    pal = rng.randint(0, 256, (17, 3)).astype(np.uint8)
    pal[5] = (9, 9, 9)       # a gray entry: kept as it is by flag 0
    idx = rng.randint(0, 17, (29, 41)).astype(np.uint8)
    path = str(tmp_path / 'p.png')
    with open(path, 'wb') as f:
        f.write(_encode(idx, FILTERS, pal))
    np.testing.assert_array_equal(png.read_png(path, 'rgb'), pal[idx])
    np.testing.assert_array_equal(png.read_png(path, 'rgb'),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(png.read_png(path, 'gray'),
                                  cv2.imread(path, 0))


@pytest.mark.parametrize('h,w', SIZES)
def test_cv2_reads_port_files(tmp_path, h, w):
    rgb = _image(h + w, h, w, 3)
    gray = _image(abs(h - w), h, w, 1)[..., 0]
    png.write_png(str(tmp_path / 'rgb.png'), rgb)
    png.write_png(str(tmp_path / 'gray.png'), gray)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'rgb.png'))
                                  [..., ::-1], rgb)
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / 'gray.png'), cv2.IMREAD_UNCHANGED), gray)


def test_unread_formats_raise(tmp_path):
    img = np.zeros((4, 4), np.uint16)
    cv2.imwrite(str(tmp_path / 'sixteen.png'), img)
    with pytest.raises(ValueError, match='8-bit only'):
        png.read_png(str(tmp_path / 'sixteen.png'))
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[28] = 1                         # IHDR's interlace byte
    with open(tmp_path / 'inter.png', 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match='interlaced'):
        png.read_png(str(tmp_path / 'inter.png'))


def test_io_round_trips(tmp_path):
    """utils/io.py's float read and write, as npp_tpu's (cv2) are."""
    from npp_tpu.utils import io as JIO
    rgb = np.random.RandomState(0).rand(19, 23, 3)
    gray = np.random.RandomState(1).rand(19, 23, 1)
    TIO.write_rgb(str(tmp_path / 't' / 'rgb.png'), rgb)
    TIO.write_gray(str(tmp_path / 't' / 'gray.png'), gray)
    JIO.write_rgb(str(tmp_path / 'j' / 'rgb.png'), rgb)
    JIO.write_gray(str(tmp_path / 'j' / 'gray.png'), gray)
    for name in ('rgb', 'gray'):
        read_t = TIO.read_rgb if name == 'rgb' else TIO.read_gray
        read_j = JIO.read_rgb if name == 'rgb' else JIO.read_gray
        t_file = str(tmp_path / 't' / f'{name}.png')
        j_file = str(tmp_path / 'j' / f'{name}.png')
        np.testing.assert_array_equal(read_t(t_file), read_j(t_file))
        np.testing.assert_array_equal(read_t(j_file), read_j(j_file))
        np.testing.assert_array_equal(read_t(t_file), read_t(j_file))
    with pytest.raises(FileNotFoundError):
        TIO.read_rgb(str(tmp_path / 'missing.png'))


def _cv2_grid(hw, base, s1, s2):
    """npp_tpu's GridProgram.draw (cv2.line, thickness 2) as a mask."""
    from npp_tpu.utils.visualizer import GridProgram as JGrid
    img = np.zeros(hw + (3,), np.uint8)
    _, mask = JGrid(hw, base, s1, s2).draw(img)
    return mask > 0


@pytest.mark.parametrize('seed', range(6))
def test_grid_lines_match_cv2(seed):
    rng = np.random.RandomState(seed)
    hw = tuple(int(v) for v in rng.randint(60, 400, 2))
    while True:
        s1, s2 = rng.uniform(-40, 40, 2), rng.uniform(-40, 40, 2)
        if abs(np.linalg.det(np.stack([s1, s2]))) > 50:
            break
    base = (int(rng.randint(0, hw[1])), int(rng.randint(0, hw[0])))
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    drawn, mask = GridProgram(hw, base, s1, s2).draw(img.copy())
    ref = _cv2_grid(hw, base, s1, s2)
    ours = mask > 0
    iou = (ours & ref).sum() / max((ours | ref).sum(), 1)
    assert iou >= 0.95, iou
    np.testing.assert_array_equal(drawn[ours], np.broadcast_to(
        np.array([255, 255, 0], np.uint8), (ours.sum(), 3)))
    np.testing.assert_array_equal(drawn[~ours], img[~ours])


def test_single_lines_match_cv2_pixel_for_pixel():
    rng = np.random.RandomState(0)
    for _ in range(100):
        p0 = tuple(int(v) for v in rng.randint(-40, 120, 2))
        p1 = tuple(int(v) for v in rng.randint(-40, 120, 2))
        ref = np.zeros((60, 80), np.uint8)
        cv2.line(ref, p0, p1, color=1, thickness=2)
        np.testing.assert_array_equal(line_mask_of((60, 80), p0, p1, 2), ref)
