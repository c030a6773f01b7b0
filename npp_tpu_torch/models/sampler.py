"""Periodicity-guided patch sampling, a port of `npp_tpu/models/sampler.py`
(reference: models/sampler.py:8-354).

Random draws come from an explicit CPU `torch.Generator` (a few scalars and
indices per step, copied to the device without waiting for its queue,
`device.py::to_device_async`); the JAX package draws from keys,
so the two agree in distribution only. Everything after the draws matches
the JAX package on the same centroids:
 - candidate real-patch centroids = fake centroid + i*d1 + j*d2 over the
   [-10, 10)^2 lattice (reference: sampler.py:89-99,146-167);
 - patch validity (unknown-area ratio) via a summed-area table of the mask;
 - invalid candidates get distance inf, weights renormalise over the
   survivors, and a fake patch with no valid candidate carries zero weight;
 - the top-k over integer L1 lattice distances, which tie all the time,
   breaks ties toward the lower candidate index (a stable sort), as
   lax.top_k does; torch.topk promises no order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import to_device_async
from ..ops.glimpse import extract_patches, patch_grid, summed_area_table, window_sum
from ..utils.debug import span
from ..utils.pools import pad_pool_pow2

MAX_SHIFT_IDX = 10   # lattice search extent (reference: sampler.py:89)
SELF_DISTANCE = 1e4  # distance assigned to the (0,0) lattice offset
                     # (reference: sampler.py:197)

# patch_source encoding (reference strings 'val'/'train'/'same',
# sampler.py:324-344)
SOURCE_VAL, SOURCE_TRAIN, SOURCE_SAME = 0, 1, 2


@dataclass
class SamplerConsts:
    """Per-(image, patch-size) device constants."""

    img: torch.Tensor          # (H, W, 3) source image for patches
    mask: torch.Tensor         # (H, W) known-region mask in [0,1]
    known_sat: torch.Tensor    # (H+1, W+1) SAT of (mask >= 0.5)
    pool_train: torch.Tensor   # (Nt, 2) long, padded
    pool_train_n: int          # valid count
    pool_val: torch.Tensor     # (Nv, 2) long, padded
    pool_val_n: int
    shift1: torch.Tensor       # (2,) float (dy, dx) top-1 lattice vector
    shift2: torch.Tensor       # (2,)
    real_pool: torch.Tensor    # (Nr, 2) long unfold-grid centroids (no_reg)
    real_pool_n: int


@dataclass
class PatchBatch:
    """One step's sampled patches."""

    fake_coords: torch.Tensor  # (P, S, S, 2) long pixel coords of pred patches
    fake_rgb: torch.Tensor     # (P, S, S, 3) input-image rgb at fake patches
    fake_mask: torch.Tensor    # (P, S, S, 1)
    real_rgb: torch.Tensor     # (P, K, S, S, 3)
    real_mask: torch.Tensor    # (P, K, S, S, 1)
    weight: torch.Tensor       # (P, K) 1/d weights, rows sum to 1 when valid
    valid: torch.Tensor        # (P, K) bool — candidate slot usable
    source: int                # SOURCE_VAL, SOURCE_TRAIN or SOURCE_SAME


def _valid_centroids(pool: np.ndarray, h: int, w: int, half: int) -> np.ndarray:
    """Keep centroids whose patch stays in bounds (reference:
    sampler.py:111-121)."""
    ok = ((pool[:, 0] > half) & (pool[:, 0] < h - (half + 1)) &
          (pool[:, 1] > half) & (pool[:, 1] < w - (half + 1)))
    return pool[ok]


def _pad_pool(pool: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, int]:
    # degenerate pools fall back to the image centre so shapes stay valid
    return pad_pool_pow2(pool, fallback_row=(h // 2, w // 2), fill='first')


def build_sampler_consts(img: np.ndarray, mask: np.ndarray,
                         pool_train: np.ndarray, pool_val: np.ndarray,
                         selected_shifts, patch_size: int,
                         device: torch.device) -> SamplerConsts:
    """Host-side precompute. Only the top-1 proposal of `selected_shifts`
    is used (reference: sampler.py:31-35), (x, y) flipped to (y, x)."""
    h, w = img.shape[:2]
    half = patch_size // 2
    mask2d = np.asarray(mask, np.float32).reshape(h, w)

    pt, nt = _pad_pool(_valid_centroids(np.asarray(pool_train), h, w, half), h, w)
    pv, nv = _pad_pool(_valid_centroids(np.asarray(pool_val), h, w, half), h, w)

    s = np.asarray(selected_shifts, np.float32).reshape(-1, 2, 2)[0]
    shift1 = np.array([s[0][1], s[0][0]], np.float32)
    shift2 = np.array([s[1][1], s[1][0]], np.float32)

    # unfold-grid real-patch pool for the no_reg strategy
    # (reference: sampler.py:66-86: stride S//10, zero invalid ratio)
    stride = max(1, patch_size // 10)
    ys = np.arange(0, h - patch_size + 1, stride)
    xs = np.arange(0, w - patch_size + 1, stride)
    cents = np.stack(np.meshgrid(ys + half, xs + half, indexing='ij'), -1).reshape(-1, 2)
    inv = np.cumsum(np.cumsum(mask2d < 0.5, 0), 1)
    inv = np.pad(inv, ((1, 0), (1, 0)))
    y0, x0 = cents[:, 0] - half, cents[:, 1] - half
    y1, x1 = y0 + patch_size, x0 + patch_size
    n_unknown = inv[y1, x1] - inv[y0, x1] - inv[y1, x0] + inv[y0, x0]
    rp, nr = _pad_pool(cents[n_unknown <= 0], h, w)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    mask_t = dev(mask2d)
    return SamplerConsts(
        img=dev(np.asarray(img, np.float32).reshape(h, w, -1)[..., :3]),
        mask=mask_t,
        known_sat=summed_area_table((mask_t >= 0.5).to(torch.float32)),
        pool_train=dev(pt, torch.long), pool_train_n=max(nt, 1),
        pool_val=dev(pv, torch.long), pool_val_n=max(nv, 1),
        shift1=dev(shift1), shift2=dev(shift2),
        real_pool=dev(rp, torch.long), real_pool_n=max(nr, 1))


def _randint(gen: torch.Generator, high: int, shape, device) -> torch.Tensor:
    idx = torch.randint(0, high, shape, generator=gen)
    with span('npp.h2d'):
        return to_device_async(idx, device)


def _sample_fake(gen, consts: SamplerConsts, pool, pool_n, patch_num: int,
                 patch_size: int):
    cents = pool[_randint(gen, pool_n, (patch_num,), pool.device)]   # (P, 2)
    coords = patch_grid(cents, patch_size)                          # (P, S, S, 2)
    rgb = extract_patches(consts.img, cents, patch_size)
    msk = extract_patches(consts.mask[..., None], cents, patch_size)
    return cents, coords, rgb, msk


def _real_from_lattice(consts: SamplerConsts, fake_cents: torch.Tensor,
                       patch_size: int, topk: int, invalid_ratio: float):
    """Periodicity-guided real-patch selection (reference:
    sampler.py:144-221), vectorised over the 400 lattice candidates."""
    h, w = consts.img.shape[:2]
    dev = fake_cents.device
    r = torch.arange(-MAX_SHIFT_IDX, MAX_SHIFT_IDX, device=dev)
    ii, jj = torch.meshgrid(r, r, indexing='ij')
    ii = ii.reshape(-1).to(torch.float32)                # (400,)
    jj = jj.reshape(-1).to(torch.float32)
    offsets = ii[:, None] * consts.shift1 + jj[:, None] * consts.shift2
    cand = (fake_cents[:, None, :].to(torch.float32) + offsets).to(torch.long)

    in_bounds = ((cand[..., 0] > 0) & (cand[..., 0] < h - 1) &
                 (cand[..., 1] > 0) & (cand[..., 1] < w - 1))
    # zero-padded mask pixels count as unknown (sampler.py:171-186)
    n_known = window_sum(consts.known_sat, cand, patch_size)
    n_unknown = patch_size * patch_size - n_known
    ratio_ok = n_unknown <= patch_size * patch_size * invalid_ratio

    dist = torch.abs(ii) + torch.abs(jj)
    dist = torch.where(dist == 0, torch.full_like(dist, SELF_DISTANCE), dist)
    dist = torch.where(in_bounds & ratio_ok, dist.expand(cand.shape[:2]),
                       torch.full_like(n_known, float('inf')))

    top_dist, top_idx = torch.sort(dist, dim=1, stable=True)
    top_dist, top_idx = top_dist[:, :topk], top_idx[:, :topk]   # (P, K)
    valid = torch.isfinite(top_dist)
    sel = torch.gather(cand, 1, top_idx[..., None].expand(-1, -1, 2))

    inv_d = torch.where(valid, 1.0 / top_dist, torch.zeros_like(top_dist))
    norm = torch.sum(inv_d, dim=1, keepdim=True)
    weight = torch.where(norm > 0, inv_d / torch.clamp(norm, min=1e-12),
                         torch.zeros_like(inv_d))

    rgb = extract_patches(consts.img, sel, patch_size)
    msk = extract_patches(consts.mask[..., None], sel, patch_size)
    return rgb, msk, weight, valid


def sample_patches(gen: torch.Generator, consts: SamplerConsts,
                   patch_num: int, patch_size: int, topk: int,
                   invalid_ratio: float,
                   no_reg_sampling: bool = False) -> PatchBatch:
    """One step's patch batch (reference: sampler.py:297-354).
    Branch probabilities: val 0.5 / train 0.3 / same 0.2."""
    u = float(torch.rand((), generator=gen))
    source = SOURCE_VAL if u < 0.5 else (SOURCE_TRAIN if u < 0.8 else SOURCE_SAME)
    dev = consts.img.device

    if source == SOURCE_SAME:
        _, coords, rgb, msk = _sample_fake(
            gen, consts, consts.pool_train, consts.pool_train_n, patch_num,
            patch_size)
        # real = fake at the same location, k=1 effective
        r_rgb = rgb[:, None].expand((patch_num, topk) + rgb.shape[1:])
        r_msk = msk[:, None].expand((patch_num, topk) + msk.shape[1:])
        valid = (torch.arange(topk, device=dev)[None, :] < 1).expand(
            patch_num, topk)
        return PatchBatch(coords, rgb, msk, r_rgb, r_msk,
                          valid.to(torch.float32), valid, source)

    pool, pool_n = (consts.pool_val, consts.pool_val_n) if source == SOURCE_VAL \
        else (consts.pool_train, consts.pool_train_n)
    cents, coords, rgb, msk = _sample_fake(gen, consts, pool, pool_n,
                                           patch_num, patch_size)
    if no_reg_sampling:
        sel = consts.real_pool[_randint(gen, consts.real_pool_n,
                                        (patch_num, topk), dev)]
        r_rgb = extract_patches(consts.img, sel, patch_size)
        r_msk = extract_patches(consts.mask[..., None], sel, patch_size)
        weight = torch.full((patch_num, topk), 1.0 / topk, device=dev)
        valid = torch.ones((patch_num, topk), dtype=torch.bool, device=dev)
    else:
        r_rgb, r_msk, weight, valid = _real_from_lattice(
            consts, cents, patch_size, topk, invalid_ratio)
    return PatchBatch(coords, rgb, msk, r_rgb, r_msk, weight, valid, source)
