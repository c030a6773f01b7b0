"""Per-superpixel color statistics, a numpy copy of
`npp_tpu/segmentation/features.py` (reference:
NPP_segmentation/imsegm/descriptors.py:787-850 numpy path; the optional
Cython/OpenMP kernels there have identical semantics, §2.2 of SURVEY.md).

mean/meanGrad use bincount reductions; median sorts once and slices groups.
Feature column order matches the reference's fixed flag order for
{'color': ['mean', 'median', 'meanGrad']}: mean(3), median(3), meanGrad(3).
Row i corresponds to label i (row 0 = masked-out region, dropped by callers
via features[1:], reference: pipelines.py:154,236).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _segment_mean(img: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(seg.ravel(), minlength=n).astype(np.float64)
    out = np.stack([np.bincount(seg.ravel(), weights=img[..., c].ravel(),
                                minlength=n) for c in range(img.shape[-1])], 1)
    return out / np.maximum(counts[:, None], 1)


def _segment_median(img: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    flat_seg = seg.ravel()
    order = np.argsort(flat_seg, kind='stable')
    sorted_seg = flat_seg[order]
    bounds = np.searchsorted(sorted_seg, np.arange(n + 1))
    out = np.zeros((n, img.shape[-1]))
    for c in range(img.shape[-1]):
        vals = img[..., c].ravel()[order]
        for s in range(n):
            lo, hi = bounds[s], bounds[s + 1]
            if hi > lo:
                out[s, c] = np.median(vals[lo:hi])
    return out


def superpixel_color_stats(image: np.ndarray, seg: np.ndarray,
                           flags: Sequence[str] = ('mean', 'median', 'meanGrad')
                           ) -> np.ndarray:
    image = np.nan_to_num(np.asarray(image, np.float64))
    seg = np.asarray(seg)
    n = int(seg.max()) + 1
    feats = []
    if 'mean' in flags:
        feats.append(_segment_mean(image, seg, n))
    if 'median' in flags:
        feats.append(_segment_median(image, seg, n))
    if 'meanGrad' in flags:
        grad = np.zeros_like(image)
        for c in range(image.shape[-1]):
            grad[..., c] = np.sum(np.gradient(image[..., c]), axis=0)
        feats.append(_segment_mean(grad, seg, n))
    return np.nan_to_num(np.hstack(feats))


def superpixel_centers(seg: np.ndarray) -> np.ndarray:
    """(n, 2) centroid (y, x) per label (reference:
    superpixels.py:208-227); NaN-free (empty labels -> 0)."""
    n = int(seg.max()) + 1
    counts = np.bincount(seg.ravel(), minlength=n).astype(np.float64)
    yy, xx = np.mgrid[:seg.shape[0], :seg.shape[1]]
    cy = np.bincount(seg.ravel(), weights=yy.ravel(), minlength=n)
    cx = np.bincount(seg.ravel(), weights=xx.ravel(), minlength=n)
    with np.errstate(invalid='ignore', divide='ignore'):
        centers = np.stack([cy, cx], 1) / counts[:, None]
    return np.nan_to_num(centers)


def segment_adjacency_edges(seg: np.ndarray) -> np.ndarray:
    """Unique 4-connected label adjacency pairs (a < b)
    (reference: graph_cuts.py:288-301 via make_graph_segm_connect_grid2d_conn4)."""
    pairs = []
    a, b = seg[:, :-1].ravel(), seg[:, 1:].ravel()
    pairs.append(np.stack([a, b], 1))
    a, b = seg[:-1, :].ravel(), seg[1:, :].ravel()
    pairs.append(np.stack([a, b], 1))
    e = np.concatenate(pairs)
    e = e[e[:, 0] != e[:, 1]]
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)
