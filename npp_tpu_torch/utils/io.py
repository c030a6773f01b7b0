"""Image and odgt IO (reference: loaders/loaders.py:9-80,
NPP_proposal/search.py:221-280). A copy of `npp_tpu/utils/io.py` whose
PNGs go through the port's own codec (utils/png.py) instead of OpenCV,
which the card's machine lacks: the arrays equal cv2.imread's, and cv2
reads the written files back to the same pixels.

The odgt JSON record is wire-compatible with the reference so detections made
by either implementation are interchangeable.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from .png import read_png, write_png


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float RGB in [0, 1]."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return read_png(path, 'rgb').astype(np.float64) / 255.0


def read_gray(path: str) -> np.ndarray:
    """(H, W, 1) float in [0, 1]."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return (read_png(path, 'gray').astype(np.float64) / 255.0)[..., None]


def write_rgb(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, np.uint8(np.clip(np.asarray(img01), 0, 1) * 255))


def write_gray(path: str, img01: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path,
              np.uint8(np.clip(np.asarray(img01).squeeze(), 0, 1) * 255))


def read_example_dir(datadir: str) -> Dict[str, np.ndarray]:
    """Read the per-example 4-PNG contract (reference: loaders.py:15-18)."""
    return {
        'masked_img': read_rgb(os.path.join(datadir, 'masked_img.png')),
        'gt_img': read_rgb(os.path.join(datadir, 'gt_img.png')),
        'unknown_mask': read_gray(os.path.join(datadir, 'unknown_mask.png')),
        'valid_mask': read_gray(os.path.join(datadir, 'valid_mask.png')),
    }


def read_odgt(datadir: str) -> Dict[str, Any]:
    """Read config.odgt, remapping fpaths into datadir
    (reference: loaders.py:67-80)."""
    with open(os.path.join(datadir, 'config.odgt')) as f:
        raw = json.loads(f.readline().rstrip())
    info: Dict[str, Any] = {}
    for key, val in raw.items():
        if 'fpath' in key:
            fname = (val[0] if isinstance(val, list) else val).split('/')[-1]
            info[key] = os.path.join(datadir, fname)
        else:
            info[key] = val
    return info


def write_odgt(outdir: str, record: Dict[str, Any]) -> None:
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, 'config.odgt'), 'w') as f:
        json.dump(record, f)
        f.write('\n')


def patch_size_from_periods(selected_periods) -> int:
    """clip(ceil32(max top-1 period), 64, 160) (reference:
    loaders.py:130-134)."""
    max_period = max(selected_periods[0])
    return int(np.clip(max_period + (32 - max_period % 32), 64, 160))
