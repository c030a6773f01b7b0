"""Task data loaders (reference: loaders/loaders.py:82-136).

A copy of the completion, remapping and segmentation loaders of
`npp_tpu/models/loaders.py`: host-side numpy preprocessing whose outputs
are plain arrays + metadata consumed by the pipelines. The remapping and
segmentation loaders are each split into file reading (`load_remapping`,
`load_segmentation`) and a function on arrays (`remapping_data`, whose
blur map runs on the caller's device; `segmentation_data`, whose SLIC
does), so that data made in memory needs no PNGs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..ops.blur import blur_map, blur_with_mask
from ..utils.io import patch_size_from_periods, read_odgt, read_gray, read_rgb


@dataclasses.dataclass
class TaskData:
    img: np.ndarray            # (H, W, 3) gt image
    masked_img: np.ndarray     # (H, W, 3) input (masked) image
    mask: np.ndarray           # (H, W, 1) known mask (1 = known)
    valid_mask: np.ndarray     # (H, W, 1)
    i_train: np.ndarray        # (Nt, 2) int coords
    i_val: np.ndarray          # (Nv, 2)
    selected_shifts: List      # top-K [(x,y),(x,y)]
    selected_angles: List      # top-K [a1, a2]
    selected_periods: List     # top-K [p1, p2]
    patch_size: int
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def orig_shape(self):
        return self.extra.get('orig_shape', self.img.shape[:2])


def pad_canvas(data: TaskData, multiple: int) -> TaskData:
    """Pad all image-shaped arrays to a multiple-of-`multiple` canvas so
    compiled fit/render executables are shared across image sizes. The pad
    region is invalid (valid_mask = 0) and appears in no coordinate pool;
    crop outputs back with data.orig_shape."""
    if multiple <= 0:
        return data
    h, w = data.img.shape[:2]
    hh = -(-h // multiple) * multiple
    ww = -(-w // multiple) * multiple
    if (hh, ww) == (h, w):
        data.extra.setdefault('orig_shape', (h, w))
        return data

    def pad(x):
        return np.pad(x, ((0, hh - h), (0, ww - w), (0, 0)))

    extra = {k: (pad(v) if isinstance(v, np.ndarray) and v.ndim == 3
                 and v.shape[:2] == (h, w) else v)
             for k, v in data.extra.items()}
    extra['orig_shape'] = (h, w)
    return dataclasses.replace(
        data, img=pad(data.img), masked_img=pad(data.masked_img),
        mask=pad(data.mask), valid_mask=pad(data.valid_mask), extra=extra)


def _topk_periodicity(info: dict, p_topk: int, aux_gate_ratio: float = 0.0):
    """Select the top-K proposals, optionally rank-gating the aux ones.

    With aux_gate_ratio > 0, aux proposals (rank 2..K) whose ranking distance
    (30*LPIPS + 1*CX, written to the odgt by the search stage) exceeds
    ratio x top-1 distance are dropped: a clearly-worse lattice contributes
    noise channels to the NPP-Net aux branch (round-1 ablation: top-1-only
    beat top-3 by +1.1 dB on the example whose aux distances were 1.2x/1.4x
    top-1). The reference always consumes a fixed top-K
    (loaders/loaders.py:110-128).

    Gating uses the REFERENCE-proxy distances ('distances_gate', written by
    the search stage since round 3) even when a different rank_proxy ordered
    the candidates: the ratio gate is calibrated on the 30*LPIPS+1*CX scale,
    and other proxies (log10 MSE) can be negative, where ratios are
    meaningless. Falls back to 'distances' for round-1/2 odgt files."""
    k = p_topk
    dist = info.get('distances_gate') or info.get('distances')
    if aux_gate_ratio > 0 and dist:
        gate = aux_gate_ratio * float(dist[0])
        k = 1
        while k < min(p_topk, len(dist)) and float(dist[k]) <= gate:
            k += 1
    return (info['selected_shifts'][:k], info['selected_angles'][:k],
            info['selected_periods'][:k])


def load_completion(cfg) -> TaskData:
    """reference: loaders.py:82-136."""
    info = read_odgt(cfg.datadir)
    masked_img = read_rgb(info['fpath_masked_img'])
    img = read_rgb(info['fpath_gt_img'])
    valid_mask = read_gray(info['fpath_valid_mask'])
    mask = read_gray(info['fpath_mask'])

    mask = mask * valid_mask
    if cfg.invalid_as_unknown:
        valid_mask = np.ones_like(valid_mask)

    train = np.stack(np.nonzero((mask * valid_mask)[..., 0]), 1)
    val = np.stack(np.nonzero(((1 - mask) * valid_mask)[..., 0]), 1)

    if cfg.normalize_type == 2:
        img = (img - 0.5) * 2

    shifts, angles, periods = _topk_periodicity(info, cfg.p_topk, cfg.aux_gate_ratio)
    return pad_canvas(TaskData(img=img, masked_img=masked_img, mask=mask,
                               valid_mask=valid_mask, i_train=train, i_val=val,
                               selected_shifts=shifts, selected_angles=angles,
                               selected_periods=periods,
                               patch_size=patch_size_from_periods(periods)),
                      cfg.canvas_multiple)


def remapping_data(arrays: dict, cfg, device: Optional[torch.device] = None
                   ) -> TaskData:
    """reference: loaders.py:244-304, on arrays: 'gt_img' (H, W, 3) in
    [0, 1], 'valid_mask' (H, W, 1) and the record's 'selected_shifts',
    'selected_angles', 'selected_periods' (and optional distances). `mask`
    carries the clear mask (the pixel loss's weights); train = all valid
    pixels, val = clear & valid. The blur map runs on `device`."""
    img = np.asarray(arrays['gt_img'], np.float64)
    valid_mask = np.asarray(arrays['valid_mask'], np.float64)
    _, clear = blur_map(np.uint8(img * 255), thresh=cfg.blur_thresh,
                        device=device)
    clear_mask = clear[..., None] / 255.0 * valid_mask

    train = np.stack(np.nonzero(valid_mask[..., 0]), 1)
    val = np.stack(np.nonzero((clear_mask * valid_mask)[..., 0]), 1)

    shifts, angles, periods = _topk_periodicity(arrays, cfg.p_topk,
                                                cfg.aux_gate_ratio)
    return pad_canvas(TaskData(img=img, masked_img=img, mask=clear_mask,
                               valid_mask=valid_mask, i_train=train, i_val=val,
                               selected_shifts=shifts, selected_angles=angles,
                               selected_periods=periods,
                               patch_size=patch_size_from_periods(periods),
                               extra={'clear_mask': clear_mask}),
                      cfg.canvas_multiple)


def load_remapping(cfg, device: Optional[torch.device] = None) -> TaskData:
    """reference: loaders.py:244-304: cfg.datadir's record and images, then
    remapping_data."""
    info = read_odgt(cfg.datadir)
    arrays = dict(info, gt_img=read_rgb(info['fpath_gt_img']),
                  valid_mask=read_gray(info['fpath_valid_mask']))
    return remapping_data(arrays, cfg, device)


def segmentation_data(arrays: dict, cfg, device: Optional[torch.device] = None
                      ) -> TaskData:
    """reference: loaders.py:141-239, on arrays: 'gt_img' (H, W, 3) in
    [0, 1], 'valid_mask' (H, W, 1) and the record's lattices. The coarse
    SLIC + GMM + graph cut (its SLIC on `device`) proposes the periodic
    region: the class that holds most of the centre quarter, so the mask
    does not depend on the GMM's component order. The model is fit on the
    masked-blurred image."""
    from ..segmentation.coarse import coarse_segment

    img = np.asarray(arrays['gt_img'], np.float64)
    valid_mask = np.asarray(arrays['valid_mask'], np.float64)
    img_u8 = np.uint8(img * 255)
    blur_img = blur_with_mask(img_u8, valid_mask) / 255.0

    seg = coarse_segment(img_u8, valid_mask[..., 0] > 0.5,
                         nb_classes=cfg.nb_classes, sp_size=cfg.sp_size,
                         sp_regul=cfg.sp_regul, device=device)
    seg = np.uint8((seg + 1) * valid_mask[..., 0])

    h, w = seg.shape
    counts = np.bincount(seg[h // 4: h // 4 * 3, w // 4: w // 4 * 3].reshape(-1),
                         minlength=cfg.nb_classes + 1)[1:]
    period_label = int(counts.argmax()) + 1

    period_mask = (seg == period_label)[..., None].astype(np.float64)
    non_period_mask = (((seg != period_label) & (seg > 0))[..., None]
                       ).astype(np.float64)

    train = np.stack(np.nonzero((period_mask * valid_mask)[..., 0]), 1)
    val = np.stack(np.nonzero(((1 - period_mask) * valid_mask)[..., 0]), 1)

    shifts, angles, periods = _topk_periodicity(arrays, cfg.p_topk,
                                                cfg.aux_gate_ratio)
    return pad_canvas(TaskData(img=img, masked_img=blur_img, mask=period_mask,
                               valid_mask=valid_mask, i_train=train, i_val=val,
                               selected_shifts=shifts, selected_angles=angles,
                               selected_periods=periods,
                               patch_size=patch_size_from_periods(periods),
                               extra={'blur_img': blur_img,
                                      'period_mask': period_mask,
                                      'non_period_mask': non_period_mask,
                                      'coarse_seg': seg}),
                      cfg.canvas_multiple)


def load_segmentation(cfg, device: Optional[torch.device] = None) -> TaskData:
    """reference: loaders.py:141-239: cfg.datadir's record and images,
    then segmentation_data."""
    info = read_odgt(cfg.datadir)
    arrays = dict(info, gt_img=read_rgb(info['fpath_gt_img']),
                  valid_mask=read_gray(info['fpath_valid_mask']))
    return segmentation_data(arrays, cfg, device)
