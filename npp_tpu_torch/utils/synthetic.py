"""The flagship synthetic completion example, made from a seed with no PNG IO.

A copy of `bench.py::_synthetic_data` (bench.py:47-68): a 384x512
near-periodic image with an 80x100 hole and three detected lattices, so the
main path runs at the reference's default shapes (patch size 160, 1386
embedding channels) on any machine. `synthetic_search_data` gives the same
image and masks without the lattices, for the periodicity search, and
`synthetic_remap_data` the image without its hole, blurred inside an
ellipse, with its lattices, for the remapping task.
`synthetic_segment_data` is another image: a near-periodic texture with
two non-periodic blobs and their ground-truth mask, for the segmentation
task.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage as ndimage

from ..models.loaders import TaskData

H, W = 384, 512
PATCH_SIZE = 160
TOPK = 3
SHIFTS = [[[56.0, 0.0], [0.0, 48.0]]] * TOPK
ANGLES = [[90.0, 180.0]] * TOPK
PERIODS = [[48.0, 56.0], [24.0, 28.0], [96.0, 112.0]]
BLUR_SIGMA = 2.5


def _image_and_mask(seed: int, h: int, w: int):
    """The near-periodic image and its known mask (0 in the hole)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    img = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * yy / 48.0) * np.cos(2 * np.pi * xx / 56.0),
        0.5 + 0.3 * np.cos(2 * np.pi * (yy / 48.0 + xx / 56.0)),
        0.5 + 0.2 * np.sin(2 * np.pi * xx / 56.0)], -1)
    img += rng.randn(h, w, 3) * 0.02
    img = np.clip(img, 0, 1)
    mask = np.ones((h, w, 1))
    mask[150 * h // H:230 * h // H, 200 * w // W:300 * w // W] = 0
    return img, mask


def synthetic_data(seed: int = 0, h: int = H, w: int = W) -> TaskData:
    """The example at (h, w); the hole scales with the canvas (bench.py's
    80x100 hole at the default size)."""
    img, mask = _image_and_mask(seed, h, w)
    valid = np.ones((h, w, 1))
    train = np.stack(np.nonzero((mask * valid)[..., 0]), 1)
    val = np.stack(np.nonzero(((1 - mask) * valid)[..., 0]), 1)
    return TaskData(img=img, masked_img=img * mask, mask=mask,
                    valid_mask=valid, i_train=train, i_val=val,
                    selected_shifts=SHIFTS, selected_angles=ANGLES,
                    selected_periods=PERIODS, patch_size=PATCH_SIZE)


def synthetic_search_data(seed: int = 0, h: int = H, w: int = W) -> dict:
    """The same image and masks without the lattices, as the search reads
    an example directory (utils/io.py::read_example_dir): 'masked_img',
    'gt_img', 'unknown_mask' (1 on known pixels) and 'valid_mask'. The
    search detects the lattices and makes its own pixel pools."""
    img, mask = _image_and_mask(seed, h, w)
    return {'masked_img': img * mask, 'gt_img': img, 'unknown_mask': mask,
            'valid_mask': np.ones((h, w, 1))}


def synthetic_remap_data(seed: int = 0, h: int = H, w: int = W) -> dict:
    """The flagship image (no hole) Gaussian-blurred (scipy, sigma 2.5)
    inside an ellipse, the shape of scripts/eval_remapping.py:33-58 with
    its radii scaled from that script's 256x320 canvas to (h, w), as
    `models/loaders.py::remapping_data` reads it: 'gt_img', 'valid_mask'
    and the three lattices ('selected_shifts', 'selected_angles',
    'selected_periods'); also 'sharp' (the image before the blur) and
    'blur_region' (the ellipse, (H, W) bool)."""
    sharp, _ = _image_and_mask(seed, h, w)
    rng = np.random.RandomState(seed + 1)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    cy, cx = rng.randint(h // 3, 2 * h // 3), rng.randint(w // 3, 2 * w // 3)
    ry = rng.randint(50, 70) * h / 256.0
    rx = rng.randint(60, 85) * w / 320.0
    region = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    blurred = np.stack([ndimage.gaussian_filter(sharp[..., c], BLUR_SIGMA)
                        for c in range(3)], -1)
    img = np.where(region[..., None], blurred, sharp)
    return {'gt_img': img, 'valid_mask': np.ones((h, w, 1)),
            'selected_shifts': SHIFTS, 'selected_angles': ANGLES,
            'selected_periods': PERIODS, 'sharp': sharp,
            'blur_region': region}


def _segment_example(seed: int, h: int, w: int):
    """A copy of scripts/eval_segmentation_iou.py:29-62::synth_example:
    a texture oscillating around a constant local mean (periods py, px
    well under the superpixel size) with two blobs of distinct base
    colour pasted in. Returns (image in [0, 1], blob mask, py, px)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    py, px = rng.choice([8, 10, 12]), rng.choice([10, 12, 16])
    ph = rng.uniform(0, 2 * np.pi, 3)
    base = np.asarray([0.55, 0.5, 0.42])
    osc = np.stack([np.sin(2 * np.pi * xx / px + ph[0]),
                    np.sin(2 * np.pi * yy / py + ph[1]),
                    np.sin(2 * np.pi * (xx / px + yy / py) + ph[2])], -1)
    amp = np.asarray([0.22, 0.18, 0.1])
    img = base + amp * osc + rng.randn(h, w, 3) * 0.015
    gt_mask = np.zeros((h, w), bool)
    for b in range(2):
        cy, cx_ = rng.randint(h // 4, 3 * h // 4), rng.randint(w // 4, 3 * w // 4)
        ry, rx = rng.randint(24, 40), rng.randint(28, 46)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx_) / rx) ** 2 < 1
        gt_mask |= blob
        color = np.asarray([0.08, 0.1, 0.14]) if b == 0 \
            else np.asarray([0.92, 0.88, 0.8])
        tex = color + rng.randn(h, w, 3) * 0.05 \
            + 0.1 * np.sin(0.0004 * ((yy - cy) ** 2 + (xx - cx_) ** 2))[..., None]
        img = np.where(blob[..., None], tex, img)
    return np.clip(img, 0, 1), gt_mask, float(py), float(px)


def synthetic_segment_data(seed: int = 0, h: int = 256, w: int = 320
                           ) -> dict:
    """The segmentation example of scripts/eval_segmentation_iou.py at
    (h, w), as `models/loaders.py::segmentation_data` reads it: 'gt_img',
    'valid_mask' and the lattices of its construction in the convention
    of SHIFTS / ANGLES / PERIODS (top-1 (py, px), then (py/2, px/2) and
    (2py, 2px), the top-1 shifts for all three; patch size 64); also
    'gt_mask', the blobs' (H, W) bool ground truth."""
    img, gt_mask, py, px = _segment_example(seed, h, w)
    return {'gt_img': img, 'valid_mask': np.ones((h, w, 1)),
            'selected_shifts': [[[px, 0.0], [0.0, py]]] * TOPK,
            'selected_angles': [[90.0, 180.0]] * TOPK,
            'selected_periods': [[py, px], [py / 2, px / 2],
                                 [2 * py, 2 * px]],
            'gt_mask': gt_mask}
