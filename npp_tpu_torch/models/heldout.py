"""Held-out synthetic validation holes for completion fits.

A copy of `npp_tpu/models/heldout.py` (numpy on the host; no reference
equivalent). Each held-out block is the real hole's central bbox patch
translated by integer lattice vectors (i*shift1 + j*shift2) into the known
region, so its completion dynamics mirror the real hole's. The carved
blocks are treated exactly like the real hole during fitting (removed from
the train pool and the known mask, zeroed in the fit image, added to the
val pool); `comp_snapshot='best'` then keeps, across eval milestones, the
snapshot with the best held-out PSNR (models/completion.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .loaders import TaskData


def _window_known(known_sat: np.ndarray, y0: int, x0: int,
                  hh: int, ww: int) -> int:
    return int(known_sat[y0 + hh, x0 + ww] - known_sat[y0, x0 + ww]
               - known_sat[y0 + hh, x0] + known_sat[y0, x0])


def plan_heldout_rects(known: np.ndarray, hole: np.ndarray,
                       shift1: np.ndarray, shift2: np.ndarray,
                       n_blocks: int, size: Optional[Tuple[int, int]] = None,
                       max_side: int = 0) -> List[Tuple[int, int, int, int]]:
    """Choose up to n_blocks (y0, x0, h, w) rects, fully inside the known
    region, lattice-aligned with the real hole's centre.

    known / hole: (H, W) float masks (known = mask*valid; hole =
    (1-mask)*valid). shift1/shift2: top-1 lattice vectors in (y, x) order.
    size: explicit (h, w) block size; None = auto (the hole bbox clipped to
    max_side per side). Returns [] when nothing placeable.
    """
    h, w = known.shape
    hy, hx = np.nonzero(hole > 0.5)
    if len(hy) == 0:
        return []
    by0, by1 = int(hy.min()), int(hy.max()) + 1
    bx0, bx1 = int(hx.min()), int(hx.max()) + 1
    cy, cx = (by0 + by1) // 2, (bx0 + bx1) // 2
    if size is None:
        bh, bw = by1 - by0, bx1 - bx0
        if max_side:
            bh, bw = min(bh, max_side), min(bw, max_side)
    else:
        bh, bw = size
    bh, bw = max(8, int(bh)), max(8, int(bw))

    known_sat = np.pad(np.cumsum(np.cumsum(
        (known > 0.5).astype(np.int64), 0), 1), ((1, 0), (1, 0)))

    rects: List[Tuple[int, int, int, int]] = []

    def fits(y0, x0, hh, ww):
        if y0 < 0 or x0 < 0 or y0 + hh > h or x0 + ww > w:
            return False
        if _window_known(known_sat, y0, x0, hh, ww) != hh * ww:
            return False
        for (ry, rx, rh, rw) in rects:
            if not (y0 + hh <= ry or ry + rh <= y0 or
                    x0 + ww <= rx or rx + rw <= x0):
                return False
        return True

    # candidate lattice offsets by increasing |i|+|j| (closest phase-aligned
    # positions first); the sampler's own lattice extent is ±10
    # (models/sampler.py:37)
    offs = [(i, j) for i in range(-10, 11) for j in range(-10, 11)
            if (i, j) != (0, 0)]
    offs.sort(key=lambda ij: (abs(ij[0]) + abs(ij[1]),
                              abs(ij[0]), abs(ij[1])))
    for (hh, ww) in ((bh, bw), (max(8, bh // 2), max(8, bw // 2)),
                     (max(8, bh // 4), max(8, bw // 4))):
        for (i, j) in offs:
            dy = i * float(shift1[0]) + j * float(shift2[0])
            dx = i * float(shift1[1]) + j * float(shift2[1])
            y0 = int(round(cy + dy - hh / 2))
            x0 = int(round(cx + dx - ww / 2))
            if fits(y0, x0, hh, ww):
                rects.append((y0, x0, hh, ww))
                if len(rects) >= n_blocks:
                    return rects
        if rects:
            # don't mix sizes: either the full size fits somewhere or we
            # retry everything smaller
            break
    return rects


def carve_heldout(data: TaskData, cfg) -> TaskData:
    """Return a TaskData with cfg.comp_heldout synthetic validation holes
    carved from the known region, or `data` unchanged when nothing is
    placeable / the feature is off.

    The carved copy is the FIT-side view: heldout pixels leave the train
    pool and the known mask, join the val pool, and are zeroed in
    masked_img (no content leak through patch gathers — the sampler's SAT
    validity counts them unknown exactly like the real hole). Evaluation
    keeps using the ORIGINAL data; the carved copy carries
    extra['heldout_rects'] / ['heldout_mask'] / ['heldout_gt'] for the
    snapshot criterion.
    """
    n_blocks = int(getattr(cfg, 'comp_heldout', 0))
    if n_blocks <= 0:
        return data
    known = (data.mask * data.valid_mask)[..., 0]
    hole = ((1 - data.mask) * data.valid_mask)[..., 0]
    s = np.asarray(data.selected_shifts, np.float64).reshape(-1, 2, 2)[0]
    shift1 = np.array([s[0][1], s[0][0]])   # (x, y) -> (y, x)
    shift2 = np.array([s[1][1], s[1][0]])
    size = None
    side = int(getattr(cfg, 'comp_heldout_size', 0))
    if side > 0:
        size = (side, side)
    rects = plan_heldout_rects(known, hole, shift1, shift2, n_blocks,
                               size=size,
                               max_side=side if side > 0 else 160)
    if not rects:
        print('[heldout] no lattice-aligned known-region block placeable; '
              'comp_heldout disabled for this image')
        return data

    hmask = np.zeros_like(data.mask)
    for (y0, x0, hh, ww) in rects:
        hmask[y0:y0 + hh, x0:x0 + ww] = 1.0
    new_mask = data.mask * (1.0 - hmask)
    new_masked = data.masked_img * (1.0 - hmask)
    train = np.stack(np.nonzero((new_mask * data.valid_mask)[..., 0]), 1)
    val = np.stack(np.nonzero(
        ((1 - new_mask) * data.valid_mask)[..., 0]), 1)
    extra = dict(data.extra)
    extra.update(heldout_rects=rects, heldout_mask=hmask,
                 heldout_gt=data.masked_img.copy())
    return dataclasses.replace(data, mask=new_mask, masked_img=new_masked,
                               i_train=train, i_val=val, extra=extra)


def heldout_coords(data_fit: TaskData) -> Optional[np.ndarray]:
    hmask = data_fit.extra.get('heldout_mask')
    if hmask is None:
        return None
    return np.stack(np.nonzero(hmask[..., 0] > 0.5), 1)


def heldout_psnr(pred: np.ndarray, data_fit: TaskData) -> Optional[float]:
    """PSNR of the render over the held-out blocks vs their (legitimately
    known) input content. pred: (H, W, 3) full-canvas render."""
    hc = heldout_coords(data_fit)
    if hc is None or len(hc) == 0:
        return None
    gt = data_fit.extra['heldout_gt'][hc[:, 0], hc[:, 1]]
    pv = pred[hc[:, 0], hc[:, 1]]
    mse = float(np.mean((pv - gt) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))
