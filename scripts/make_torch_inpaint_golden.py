#!/usr/bin/env python
"""Write tests/fixtures/torch_inpaint_ns_cv2.npz: cv2.inpaint(...,
cv2.INPAINT_NS) outputs on seeded inputs, which chip_smoke.py holds the
port's inpainting library (ops/inpaint.py) to on a machine without cv2.

Usage: python scripts/make_torch_inpaint_golden.py [--out PATH]

Cases (keys '<case>_src', '_mask', '_radius', '_out'): a seam-composite
residual (3 channels near 127, a rectangular hole, radius 3, as
models/completion.py::seam_residual_correction calls it), a noisy gray
image with a blob hole at radius 5, a smooth colour image with holes on
its borders at radius 1, and a hole over most of a gray image at radius 3.
tests/test_torch_inpaint.py checks the file against cv2 and the port.
"""
import argparse
import os

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases():
    rng = np.random.default_rng(0)
    h, w = 96, 128
    resid = np.clip(127.5 + rng.normal(0, 3, (h, w, 3)).cumsum(1) * 0.2,
                    0, 255).astype(np.uint8)
    m = np.zeros((h, w), np.uint8)
    m[30:70, 40:100] = 255
    yield 'seam', resid, m, 3
    gray = rng.integers(0, 256, (64, 80), dtype=np.uint8)
    blob = cv2.GaussianBlur(rng.random((64, 80)), (9, 9), 3)
    yield 'blob', gray, np.uint8(blob > np.quantile(blob, 0.7)) * 255, 5
    colour = cv2.GaussianBlur(rng.integers(0, 256, (48, 56, 3),
                                           dtype=np.uint8), (7, 7), 2)
    mb = np.zeros((48, 56), np.uint8)
    mb[:3, :] = 255
    mb[:, -2:] = 255
    mb[-1, :5] = 255
    mb[5:9, 0] = 255
    yield 'border', colour, mb, 1
    gray2 = rng.integers(0, 256, (40, 52), dtype=np.uint8)
    mm = np.zeros((40, 52), np.uint8)
    mm[1:-2, 2:-1] = 255
    yield 'most', gray2, mm, 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'tests', 'fixtures', 'torch_inpaint_ns_cv2.npz'))
    args = ap.parse_args()
    arrays = {}
    for name, src, mask, radius in cases():
        arrays[f'{name}_src'] = src
        arrays[f'{name}_mask'] = mask
        arrays[f'{name}_radius'] = np.float64(radius)
        arrays[f'{name}_out'] = cv2.inpaint(src, mask, radius,
                                            cv2.INPAINT_NS)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f'wrote {args.out} ({os.path.getsize(args.out)} bytes, '
          f'cv2 {cv2.__version__})')


if __name__ == '__main__':
    main()
