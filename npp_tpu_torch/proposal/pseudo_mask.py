"""Pseudo-validation-mask generation for proposal ranking
(reference: utils/miscs.py:53-97, loaders/loaders.py:34-54). A copy of
`npp_tpu/proposal/pseudo_mask.py` (numpy and scipy only)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.ndimage as ndimage


def find_mask_centroid(mask: np.ndarray, topk: int = 3,
                       threshold_ratio: float = 0.3
                       ) -> Tuple[List[List[int]], List[float]]:
    """Top-K pixels far from boundaries/unknown regions
    (reference: miscs.py:53-97)."""
    mask2d = np.asarray(mask).squeeze()
    dis = ndimage.distance_transform_edt(mask2d).reshape(-1)
    order = np.argsort(-dis)
    threshold = min(mask2d.shape[0], mask2d.shape[1]) * threshold_ratio

    centroids: List[List[int]] = []
    selected: List[float] = []
    for idx in order:
        h, w = int(idx // mask2d.shape[1]), int(idx % mask2d.shape[1])
        if all(np.hypot(c[0] - h, c[1] - w) >= threshold for c in centroids):
            centroids.append([h, w])
            selected.append(float(dis[idx]))
        if len(selected) == topk:
            break
    return centroids, selected


def build_pseudo_split(mask: np.ndarray, valid_mask: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pseudo train/val coordinate split (reference: loaders.py:34-54).
    Returns (pseudo_mask, i_train, i_val); pseudo_mask==0 marks held-out
    windows around the top-K centroids. Windows are clipped to the image:
    the reference's raw slice gives an empty window for a centroid within
    `half` of the border."""
    centroids, dist = find_mask_centroid(mask * valid_mask)
    pseudo = np.ones_like(mask)
    for c, d in zip(centroids, dist):
        half = int(d / np.sqrt(2) / 1.2)
        y0, y1 = max(0, c[0] - half), max(0, c[0] + half)
        x0, x1 = max(0, c[1] - half), max(0, c[1] + half)
        pseudo[y0:y1, x0:x1] = 0
    known = (mask * valid_mask)[..., 0] if mask.ndim == 3 else mask * valid_mask
    p2d = pseudo[..., 0] if pseudo.ndim == 3 else pseudo
    i_train = np.stack(np.nonzero(p2d * known), 1)
    i_val = np.stack(np.nonzero((1 - p2d) * known), 1)
    return pseudo, i_train, i_val
