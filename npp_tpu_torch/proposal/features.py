"""Feature stack for periodicity detection (reference:
NPP_proposal/feature_searching.py:14-69), a port of
`npp_tpu/proposal/features.py` on the OpenCV-free primitives of
`proposal/cv.py`, on the host as in `npp_tpu`.

The default `SearchConfig` (gray_only=True, edge_searching=True) detects on
grayscale + Canny-edge features with no conv tower; gray_only=False adds
the 64 channels of the `owt` AlexNet's conv1 (pre-ReLU) through the
registry's 'alexnet', on the host's CPU, as npp_tpu runs it on its
default device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.ndimage as ndimage
import torch

from ..nn.features import imagenet_normalize
from ..nn.registry import get_feature_extractor
from . import cv


def pad_multiple_of(img: np.ndarray, multiple: int) -> np.ndarray:
    """Right/bottom zero pad to a multiple (reference: utils/ops.py:87-93)."""
    h, w = img.shape[:2]
    hh = -(-h // multiple) * multiple
    ww = -(-w // multiple) * multiple
    if (h, w) == (hh, ww):
        return img
    pad = [(0, hh - h), (0, ww - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def canny_edges(img_u8: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Masked Canny (reference: utils/miscs.py:22-33): gray, 3x3 Gaussian,
    Canny(10, 100), times the mask eroded 4 times."""
    if img_u8.ndim == 3:
        img_u8 = cv.rgb2gray(img_u8)
    blur = cv.gaussian_blur3(img_u8)
    m = ndimage.binary_erosion(mask, iterations=4).astype(np.float64)
    return cv.canny(blur, 10, 100) * m


def normalize_to_uint8(arr: np.ndarray, channel_idx=(1, 2)) -> np.ndarray:
    """Per-channel spatial min-max to uint8 (reference: miscs.py:42-48).
    No epsilon in the denominator (np.uint8 truncates, so any nudge drops
    exact integers a level); constant channels give 0."""
    amax = arr.max(axis=channel_idx, keepdims=True)
    amin = arr.min(axis=channel_idx, keepdims=True)
    rng = amax - amin
    out = np.divide(arr - amin, rng, out=np.zeros_like(arr, dtype=np.float64),
                    where=rng != 0)
    return np.uint8(out * 255)


@torch.no_grad()
def alexnet_conv1(img_u8: np.ndarray) -> np.ndarray:
    """The stride-4 conv1 activation (pre-ReLU) of the owt AlexNet on the
    32-padded, ImageNet-normalised image (reference:
    feature_searching.py:25-32, models/model_def.py:99-116):
    (ceil32(H)/4, ceil32(W)/4, 64)."""
    apply_fn, tap = get_feature_extractor('alexnet')
    x = pad_multiple_of(img_u8.astype(np.float32) / 255.0, 32)
    x = imagenet_normalize(torch.as_tensor(x)[None])
    return apply_fn(x)[tap][0].numpy()


def im2act(img_u8: np.ndarray, mask: np.ndarray, gray_only: bool = True
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The (C, h, w) feature stack at 1/4 resolution
    (reference: feature_searching.py:14-51): [conv1 (64)?] + gray + mask,
    all multiplied by the downsampled unknown mask. Returns (activation,
    mask)."""
    img_u8 = img_u8[..., :3]
    h, w = img_u8.shape[:2]
    nh, nw = h // 4, w // 4
    m = cv.resize_nearest(mask.astype(np.float64), (nw, nh))
    gray = cv.rgb2gray(np.ascontiguousarray(img_u8))
    gray = cv.resize_linear_u8(gray, (nw * 2, nh * 2))
    gray = cv.resize_linear_u8(gray, (nw, nh)).astype(np.float64)
    if gray_only:
        act = np.stack([gray, m])
    else:
        conv = alexnet_conv1(img_u8)[:nh, :nw]          # (nh, nw, 64)
        act = np.concatenate([np.moveaxis(conv, -1, 0), gray[None], m[None]],
                             0)
    return act * m[None], m


def act2edge(act: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Per-channel Canny on the normalised activation, summed
    (reference: feature_searching.py:54-69)."""
    act_u8 = normalize_to_uint8(act, channel_idx=(1, 2))
    edge = np.zeros((1,) + act.shape[1:])
    for c in range(act_u8.shape[0]):
        edge += canny_edges(act_u8[c], mask) / 255.0
    return np.concatenate([edge, mask[None]], 0)
