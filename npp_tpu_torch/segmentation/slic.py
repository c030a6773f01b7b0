"""Masked SLIC superpixels, the local k-means on the card.

Port of `npp_tpu/segmentation/slic.py` (which replaces the skimage C
implementation the reference wraps; reference:
NPP_segmentation/imsegm/superpixels.py:23-72). The colour conversion, the
pre-smoothing and the iterations run in f32 on the caller's device, as JAX
runs them with x64 off: each pixel considers the 3x3 neighbourhood of
grid-cell centres in JAX's order, and the first strictly nearest wins.
The centre update sorts the pixels by centre (stably) and sums each
centre's pixels in pixel order with one segment reduction: a scatter-add
on the card adds in atomic order and would move the centres from run to
run. Connectivity
enforcement (relabel + small-component merge) runs on the host.

Parameter mapping follows the reference wrapper: n_segments =
H*W/sp_size^2, compactness = (sp_size * relative_compact)^1.5, sigma=1
pre-smoothing, LAB colour space, min-max image scaling
(superpixels.py:55-64). Output labels: 0 = outside mask, 1..K =
superpixels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.ndimage as ndimage
import torch

_N_ITER = 10
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] -> CIELAB (D65), matching skimage.color.rgb2lab. The
    3x3 colour matrix is applied as products and sums (no matmul, so no
    TF32 on the card)."""
    r = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                    rgb / 12.92)
    m = torch.tensor(_RGB2XYZ, dtype=rgb.dtype, device=rgb.device)
    xyz = (r[..., None, :] * m).sum(-1)
    t = xyz / torch.tensor(_WHITE, dtype=rgb.dtype, device=rgb.device)
    f = torch.where(t > 0.008856, torch.pow(t.clamp(min=0.0), 1.0 / 3.0),
                    7.787 * t + 16.0 / 116.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([l, a, b], dim=-1)


def _reflect_index(n: int, r: int) -> np.ndarray:
    """Indices of numpy's 'reflect' padding by r on both sides."""
    idx = np.arange(-r, n + r)
    period = 2 * (n - 1) if n > 1 else 1
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _gauss(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of (H, W), reflect padding (skimage's
    sigma=1 pre-smoothing)."""
    r = int(3 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1, dtype=np.float32) / sigma) ** 2)
    k = (k / np.sum(k)).astype(np.float32)
    h, w = x.shape
    iy = torch.as_tensor(_reflect_index(h, r), device=x.device)
    xp = x[iy]
    x = sum(float(k[j]) * xp[j:j + h] for j in range(2 * r + 1))
    ix = torch.as_tensor(_reflect_index(w, r), device=x.device)
    xp = x[:, ix]
    return sum(float(k[j]) * xp[:, j:j + w] for j in range(2 * r + 1))


def _slic_iterate(lab: torch.Tensor, mask: torch.Tensor, gh: int, gw: int,
                  step: int, compactness: float, n_iter: int = _N_ITER
                  ) -> torch.Tensor:
    """Local k-means. Returns the per-pixel centre index (gh*gw grid)."""
    h, w = lab.shape[:2]
    dev = lab.device
    k = gh * gw
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    feats = torch.cat([lab, yy[..., None], xx[..., None]], -1)   # (H, W, 5)
    flat = feats.reshape(-1, 5)
    mflat = mask.reshape(-1).to(torch.float32)
    # (HW, 6): the masked features and the mask, summed per centre
    weighted = torch.cat([flat * mflat[:, None], mflat[:, None]], 1)

    cy = (np.arange(gh) + 0.5) * step
    cx = (np.arange(gw) + 0.5) * step
    cyy, cxx = np.meshgrid(cy, cx, indexing='ij')
    init_idx = (np.clip(cyy, 0, h - 1).astype(np.int64) * w +
                np.clip(cxx, 0, w - 1).astype(np.int64)).reshape(-1)
    centers = flat[torch.as_tensor(init_idx, device=dev)]          # (K, 5)

    ratio = (compactness / step) ** 2
    cell_y = torch.clamp((yy / step).to(torch.int64), 0, gh - 1)
    cell_x = torch.clamp((xx / step).to(torch.int64), 0, gw - 1)
    cands = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            cands.append(torch.clamp(cell_y + di, 0, gh - 1) * gw +
                         torch.clamp(cell_x + dj, 0, gw - 1))

    def assign(centers):
        best_d = torch.full((h, w), float('inf'), device=dev)
        best_i = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for ci in cands:
            c = centers[ci]                                          # (H, W, 5)
            dc = torch.sum((lab - c[..., :3]) ** 2, -1)
            ds = (yy - c[..., 3]) ** 2 + (xx - c[..., 4]) ** 2
            d = dc + ds * ratio
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_i = torch.where(take, ci, best_i)
        return best_i

    for _ in range(n_iter):
        # each centre's sum over its pixels in pixel order (a stable sort,
        # then one sequential sum per segment): no atomics, so card runs
        # repeat, and linear in H*W
        seg = assign(centers).reshape(-1)
        order = torch.argsort(seg, stable=True)
        sums = torch.segment_reduce(weighted[order], 'sum', axis=0,
                                    lengths=torch.bincount(seg, minlength=k))
        wsum, fsum = sums[:, 5:], sums[:, :5]
        centers = torch.where(wsum > 0,
                              fsum / torch.clamp(wsum, min=1e-9), centers)
    return assign(centers)


def _enforce_connectivity(labels: np.ndarray, mask: np.ndarray,
                          min_size: int) -> np.ndarray:
    """Relabel connected components; merge small ones into a neighbour.
    Host-side (irregular); labels in, labels out, 0 = outside mask.

    The same relabelling, merge order and choices as npp_tpu's loop, which
    dilates every small component over the whole image (thousands of them
    on a fine texture). Here each component keeps its pixel indices and is
    dilated inside its bounding box grown by one pixel, which gives the
    same ring."""
    h, w = labels.shape
    out = np.zeros_like(labels)
    next_label = 1
    for lab_val in np.unique(labels[mask]):
        comp, n = ndimage.label(labels == lab_val)
        sel = comp > 0
        out[sel] = comp[sel] + (next_label - 1)
        next_label += n
    flat = out.ravel()
    sizes = np.bincount(flat, minlength=next_label)
    order = np.argsort(flat, kind='stable')
    bounds = np.searchsorted(flat[order], np.arange(next_label + 1))
    members = {l: [order[bounds[l]:bounds[l + 1]]]
               for l in range(1, next_label)}
    # merge components smaller than min_size into an adjacent component
    small = sorted((l for l in range(1, next_label) if sizes[l] < min_size),
                   key=lambda l: sizes[l])
    for lab_val in small:
        idx = np.concatenate(members[lab_val])
        rows, cols = idx // w, idx % w
        r0, c0 = max(rows.min() - 1, 0), max(cols.min() - 1, 0)
        r1, c1 = min(rows.max() + 2, h), min(cols.max() + 2, w)
        region = np.zeros((r1 - r0, c1 - c0), bool)
        region[rows - r0, cols - c0] = True
        dil = ndimage.binary_dilation(region) & ~region & mask[r0:r1, c0:c1]
        neigh = out[r0:r1, c0:c1][dil]
        neigh = neigh[neigh > 0]
        if len(neigh):
            vals, counts = np.unique(neigh, return_counts=True)
            target = vals[np.argmax(counts)]
            flat[idx] = target
            members[target] += members.pop(lab_val)
    # compact labels to 1..K
    vals = np.unique(out[out > 0])
    remap = np.zeros(out.max() + 1, out.dtype)
    remap[vals] = np.arange(1, len(vals) + 1)
    return remap[out]


def slic_segment(img: np.ndarray, sp_size: int = 30,
                 relative_compact: float = 0.2,
                 mask: Optional[np.ndarray] = None,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """Masked SLIC with the reference wrapper's parameter mapping
    (reference: superpixels.py:23-72). Returns int labels (H, W), from 1
    inside the mask and 0 outside. The k-means runs on `device` (the CPU
    when None)."""
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.min() != 0.0 or img.max() != 1.0:
        img = (img - img.min()) / float(img.max() - img.min() + 1e-12)

    h, w = img.shape[:2]
    if mask is None:
        mask = np.ones((h, w), bool)
    mask = np.asarray(mask, bool)

    n_segments = max(1, int(h * w / sp_size ** 2))
    compactness = float((sp_size * relative_compact) ** 1.5)
    step = max(1, int(round(np.sqrt(h * w / n_segments))))
    gh, gw = max(1, -(-h // step)), max(1, -(-w // step))

    dev = torch.device('cpu') if device is None else torch.device(device)
    lab = rgb2lab(torch.as_tensor(img, dtype=torch.float32, device=dev))
    lab = torch.stack([_gauss(lab[..., c]) for c in range(3)], -1)
    idx = _slic_iterate(lab, torch.as_tensor(mask, device=dev), gh, gw, step,
                        compactness).cpu().numpy()
    labels = idx + 1
    labels[~mask] = 0
    min_size = max(1, int(0.5 * h * w / max(n_segments, 1) / 4))
    return _enforce_connectivity(labels, mask, min_size)
