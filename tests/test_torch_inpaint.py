"""The port's Navier-Stokes inpainting (ops/inpaint.py, csrc/inpaint_ns.cpp)
against cv2.inpaint(..., cv2.INPAINT_NS) on the CPU: seeded random gray
and 3-channel images, noisy and smooth, holes of every kind the seam
composite meets and the ones where equality is hardest (rectangles with
many fast-marching ties, blobs, one-pixel lines, holes on each border, a
hole over most of the image), radius 1, 3 and 5 (and the rounding and
clamping of other radii). The pixels must be equal."""
import os

import numpy as np
import pytest

from npp_tpu_torch.ops.inpaint import inpaint_ns
from tests.torch_threads import few_threads  # noqa: F401  (autouse)

cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'fixtures', 'torch_inpaint_ns_cv2.npz')


def _mask(kind: str, h: int, w: int, rng) -> np.ndarray:
    m = np.zeros((h, w), np.uint8)
    if kind == 'rect':
        y, x = rng.integers(1, h // 2), rng.integers(1, w // 2)
        m[y:y + h // 3, x:x + w // 3] = 255
    elif kind == 'blob':
        noise = cv2.GaussianBlur(rng.random((h, w)), (9, 9), 3)
        m[noise > np.quantile(noise, 0.7)] = 255
    elif kind == 'line':
        m[h // 2, 2:w - 3] = 255
        m[3:h - 2, w // 3] = 1
    elif kind == 'border':
        m[:3, :] = 255
        m[:, -2:] = 255
        m[-1, :5] = 255
        m[5:9, 0] = 255
    elif kind == 'most':
        m[1:-2, 2:-1] = 255
    return m


def _image(channels: int, smooth: bool, h: int, w: int, rng) -> np.ndarray:
    shape = (h, w) if channels == 1 else (h, w, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 2) if smooth else img


@pytest.mark.parametrize('channels', [1, 3])
@pytest.mark.parametrize('kind', ['rect', 'blob', 'line', 'border', 'most'])
def test_inpaint_ns_equals_cv2(kind, channels):
    """Every pixel equal to cv2's, on noisy and smooth images of two
    sizes, at radius 1, 3 and 5."""
    rng = np.random.default_rng(
        ['rect', 'blob', 'line', 'border', 'most'].index(kind) * 4 + channels)
    for h, w in ((23, 31), (64, 80)):
        mask = _mask(kind, h, w, rng)
        for smooth in (False, True):
            img = _image(channels, smooth, h, w, rng)
            for radius in (1, 3, 5):
                want = cv2.inpaint(img, mask, radius, cv2.INPAINT_NS)
                got = inpaint_ns(img, mask, radius)
                np.testing.assert_array_equal(
                    got, want, err_msg=f'{h}x{w} smooth={smooth} r={radius}')


def test_inpaint_ns_random_masks_and_radii_equal_cv2():
    """Random sizes, masks of 1-90% density (some dilated into holes),
    residual-like images near 127 (what the seam composite inpaints), and
    radii that round (0.4, 2.5 half to even) or are clamped."""
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        shape = (h, w) if seed % 2 else (h, w, 3)
        img = np.clip(127 + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)
        mask = (rng.random((h, w)) < rng.uniform(0.01, 0.9)).astype(np.uint8)
        if seed % 3 == 0:
            mask = cv2.dilate(mask, np.ones((3, 3), np.uint8))
        for radius in (0.4, 2.5, 3, 7):
            np.testing.assert_array_equal(
                inpaint_ns(img, mask * 255, radius),
                cv2.inpaint(img, mask * 255, radius, cv2.INPAINT_NS),
                err_msg=f'seed {seed} r={radius}')


def test_inpaint_ns_checks_its_arguments():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(TypeError):
        inpaint_ns(img.astype(np.float32), np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        inpaint_ns(img, np.zeros((8, 9), np.uint8))
    with pytest.raises(ValueError):
        inpaint_ns(np.zeros((8, 8, 2), np.uint8), np.zeros((8, 8), np.uint8))


def test_golden_file_is_cv2s_output():
    """tests/fixtures/torch_inpaint_ns_cv2.npz, which chip_smoke.py holds
    the library to on a machine without cv2, is what cv2 gives here, and
    what the port gives."""
    with np.load(GOLDEN) as g:
        cases = sorted({k.split('_')[0] for k in g.files})
        assert cases
        for c in cases:
            img, mask = g[f'{c}_src'], g[f'{c}_mask']
            radius = float(g[f'{c}_radius'])
            want = cv2.inpaint(img, mask, radius, cv2.INPAINT_NS)
            np.testing.assert_array_equal(g[f'{c}_out'], want)
            np.testing.assert_array_equal(inpaint_ns(img, mask, radius), want)
