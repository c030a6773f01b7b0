"""The benchmark's inputs, made from the run's seed and handed to the port
and to the reference alike: the images and their lattices, and the conv
towers' weights.

The images are the flagship example of the port's
`utils/synthetic.py` (a copy, so that the yardstick cannot move): a
near-periodic 384x512 image with an 80x100 hole and three lattices, and
for remapping the same image without its hole, blurred (Gaussian, sigma
2.5) inside an ellipse. At another size than 384x512 (the CPU tests) the
hole, the lattices and the ellipse scale with the canvas.

The towers' weights are drawn on the device from the seed, in one call,
He-normal (std sqrt(2 / fan_in)) with small biases, and written as the
port's documented weight source reads them: `<dir>/<tower>.npz` with
'conv<i>/kernel' (HWIO) and 'conv<i>/bias', found through
$NPP_TPU_WEIGHTS_DIR. The reference takes the same arrays (OIHW) from
memory.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import scipy.ndimage as ndimage

H, W = 384, 512
SHIFTS = [[[56.0, 0.0], [0.0, 48.0]]] * 3
ANGLES = [[90.0, 180.0]] * 3
PERIODS = [[48.0, 56.0], [24.0, 28.0], [96.0, 112.0]]
BLUR_SIGMA = 2.5

# (convs per block, channels) of the two towers (VGG16 and VGG19)
VGG_BLOCKS = {'vgg16': ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
              'vgg19': ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))}


def data_seed(seed: int) -> int:
    """The seed of the images and of the fit (numpy's RandomState takes
    seeds below 2**32; the run's seed may be larger)."""
    return int(seed) % (2 ** 32 - 16)


def _scaled(h: int, w: int):
    """The lattices at (h, w): the flagship's, scaled with the canvas."""
    f = h / H
    shifts = [[[s * f for s in v] for v in p] for p in SHIFTS]
    periods = [[p * f for p in pp] for pp in PERIODS]
    return shifts, [list(a) for a in ANGLES], periods


def _image_and_mask(seed: int, h: int, w: int):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    f = h / H
    py, px = 48.0 * f, 56.0 * f
    img = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * yy / py) * np.cos(2 * np.pi * xx / px),
        0.5 + 0.3 * np.cos(2 * np.pi * (yy / py + xx / px)),
        0.5 + 0.2 * np.sin(2 * np.pi * xx / px)], -1)
    img += rng.randn(h, w, 3) * 0.02
    img = np.clip(img, 0, 1)
    mask = np.ones((h, w, 1))
    mask[150 * h // H:230 * h // H, 200 * w // W:300 * w // W] = 0
    return img, mask


def completion_arrays(seed: int, h: int = H, w: int = W,
                      patch_size: int = 160) -> dict:
    """The completion example: the image, the masked image, its known
    mask, the valid mask, the train (known) and val (hole) pixels and the
    three lattices."""
    img, mask = _image_and_mask(seed, h, w)
    valid = np.ones((h, w, 1))
    shifts, angles, periods = _scaled(h, w)
    return {'img': img, 'masked_img': img * mask, 'mask': mask,
            'valid_mask': valid,
            'i_train': np.stack(np.nonzero((mask * valid)[..., 0]), 1),
            'i_val': np.stack(np.nonzero(((1 - mask) * valid)[..., 0]), 1),
            'selected_shifts': shifts, 'selected_angles': angles,
            'selected_periods': periods, 'patch_size': patch_size}


def remap_arrays(seed: int, h: int = H, w: int = W) -> dict:
    """The remapping example as the port's `models/loaders.py::
    remapping_data` reads it: 'gt_img', 'valid_mask' and the lattices."""
    sharp, _ = _image_and_mask(seed, h, w)
    rng = np.random.RandomState(seed + 1)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    cy, cx = rng.randint(h // 3, 2 * h // 3), rng.randint(w // 3, 2 * w // 3)
    ry = rng.randint(50, 70) * h / 256.0
    rx = rng.randint(60, 85) * w / 320.0
    region = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    blurred = np.stack([ndimage.gaussian_filter(sharp[..., c], BLUR_SIGMA)
                        for c in range(3)], -1)
    shifts, angles, periods = _scaled(h, w)
    return {'gt_img': np.where(region[..., None], blurred, sharp),
            'valid_mask': np.ones((h, w, 1)), 'selected_shifts': shifts,
            'selected_angles': angles, 'selected_periods': periods}


MAKERS = {'completion': completion_arrays, 'remapping': remap_arrays}


def conv_shapes(tower: str) -> Dict[str, Tuple[int, int, int, int]]:
    """{'conv<i>': (out, in, 3, 3)} of the whole tower."""
    shapes, cin, idx = {}, 3, 0
    for n_convs, ch in VGG_BLOCKS[tower]:
        for _ in range(n_convs):
            shapes[f'conv{idx}'] = (ch, cin, 3, 3)
            cin, idx = ch, idx + 1
    return shapes


def tower_weights(seed: int, device) -> Dict[str, Dict[str, tuple]]:
    """{tower: {'conv<i>': (weight OIHW, bias)}} for VGG16 and VGG19, f32
    on `device`, drawn from one generator seeded with `seed` in one call."""
    import torch
    shapes = {t: conv_shapes(t) for t in VGG_BLOCKS}
    sizes = [(t, k, s) for t in VGG_BLOCKS for k, s in shapes[t].items()]
    total = sum(int(np.prod(s)) + s[0] for _, _, s in sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, Dict[str, tuple]] = {t: {} for t in VGG_BLOCKS}
    at = 0
    for t, k, s in sizes:
        n = int(np.prod(s))
        fan_in = s[1] * s[2] * s[3]
        wgt = flat[at:at + n].reshape(s) * float(np.sqrt(2.0 / fan_in))
        bias = flat[at + n:at + n + s[0]] * 0.01
        out[t][k] = (wgt, bias)
        at += n + s[0]
    return out


def write_weights(weights: Dict[str, Dict[str, tuple]], directory: str
                  ) -> None:
    """Each tower as `<directory>/<tower>.npz`, kernels HWIO."""
    os.makedirs(directory, exist_ok=True)
    for tower, convs in weights.items():
        arrays = {}
        for k, (wgt, bias) in convs.items():
            arrays[f'{k}/kernel'] = wgt.permute(2, 3, 1, 0).contiguous(
            ).cpu().numpy()
            arrays[f'{k}/bias'] = bias.cpu().numpy()
        np.savez(os.path.join(directory, f'{tower}.npz'), **arrays)
