"""Segmentation task: separate the periodic region from non-periodic
content (reference: NPP_segmentation/train.py:28-415). Port of
`npp_tpu/models/segmentation.py`: the coarse SLIC + GMM + graph cut
proposes a periodic region (the loader), NPP-Net is fit on the blurred
image through the completion's fit driver, and the region is refined by
thresholding the L1 and spatial LPIPS-alex error maps. The spatial LPIPS
runs on the card in full f32; the thresholds and the morphology on the
host, in float64 where npp_tpu's numpy runs them.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import scipy.ndimage as ndimage
import torch

from ..device import matmul_precision, resolve_device
from ..losses.lpips import LPIPS
from ..nn.pretrained import weight_reports
from ..utils.io import write_gray, write_rgb
from .loaders import load_segmentation, segmentation_data
from .pipeline import fit_image
from .trainer import FitState, TaskSpec

SEGMENTATION_TASK = TaskSpec(name='segmentation')

_GRAY = np.array([0.299, 0.587, 0.114])  # kornia rgb_to_grayscale weights


def remove_small_objects(mask: np.ndarray, min_size: int = 500,
                         connectivity: int = 1) -> np.ndarray:
    """skimage.morphology.remove_small_objects equivalent
    (reference: NPP_segmentation/train.py:395)."""
    structure = ndimage.generate_binary_structure(2, connectivity)
    lab, n = ndimage.label(mask, structure=structure)
    sizes = np.bincount(lab.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[lab]


def spatial_lpips_layers(lpips_alex: LPIPS, pred_gray: np.ndarray,
                         blur_gray: np.ndarray):
    """The spatial LPIPS-alex maps of two (H, W, 1) gray images on the
    tower's device, in full f32, as npp_tpu's refinement reads them: the
    reference's in-place `val = res[0]; val += res[l]`
    (externel_lib/lpips/lpips.py:127-129) aliases the first per-layer map
    to the total, so entry 0 is the sum over all layers (verified against
    a reference-executed golden, tests/goldens/seg_criterion_parity.npz).
    Returns numpy (H, W) f32 maps."""
    dev = lpips_alex.shift.device

    def t(a):
        return torch.as_tensor(a[None], dtype=torch.float32, device=dev)
    with torch.no_grad(), matmul_precision('float32'):
        val, per_layer = lpips_alex(t(pred_gray), t(blur_gray),
                                    use_robust=False, normalize=True,
                                    spatial=True, ret_per_layer=True)
    return [m[0, ..., 0].cpu().numpy() for m in [val] + list(per_layer[1:])]


def refine_segmentation(cfg, data, pred_img: np.ndarray,
                        lpips_alex: LPIPS) -> Dict[str, np.ndarray]:
    """The two-criterion refinement (reference:
    NPP_segmentation/train.py:333-406): L1 < l1_thresh AND spatial
    LPIPS < lpips_thresh per layer; morphology post-processing; with
    npp_tpu's gated options (seg_color_criterion, seg_refine_hysteresis,
    seg_texture_criterion, seg_refine_protect, seg_autocal)."""
    valid = data.valid_mask
    blur_img = data.extra['blur_img']
    non_period = data.extra['non_period_mask'][..., 0]

    pred_gray = ((pred_img * valid) @ _GRAY)[..., None]     # (H, W, 1)
    blur_gray = ((blur_img * valid) @ _GRAY)[..., None]

    if getattr(cfg, 'seg_color_criterion', False):
        # colour-aware variant: max per-channel |diff| catches isoluminant
        # anomalies the reference's grayscale criterion cannot see
        l1_img = np.clip(
            np.abs((pred_img - blur_img) * valid).max(-1), 0, 0.99)
    else:
        l1_img = np.clip(np.abs(pred_gray - blur_gray).sum(-1), 0, 0.99)
    l1_ok = l1_img < cfg.l1_thresh

    per_layer = spatial_lpips_layers(lpips_alex, pred_gray, blur_gray)

    # The reference's lpips_thresh (0.3) is calibrated for the pretrained
    # AlexNet. On analytic weights the maps are rescaled per image: the
    # 95th percentile over the well-fit periodic region maps to half the
    # threshold. cfg.seg_autocal ('auto'|'off'|'on') overrides the
    # automatic choice.
    autocal_mode = getattr(cfg, 'seg_autocal', 'auto')
    if autocal_mode == 'auto':
        rep = weight_reports().get('alexnet_tv')
        autocal = rep is not None and not rep.pretrained
    else:
        autocal = autocal_mode == 'on'
    periodic_ref = (data.mask[..., 0] > 0.5) & (valid[..., 0] > 0.5)

    # Hysteresis (1.0 = reference behaviour): removing an init
    # non-periodic pixel demands stronger evidence than adding one.
    hyst = float(getattr(cfg, 'seg_refine_hysteresis', 1.0))
    init_np = non_period > 0.5
    if hyst != 1.0:
        l1_ok = np.where(init_np, l1_img < cfg.l1_thresh * hyst, l1_ok)

    non_period_final = None
    lpips_maps = []
    lpips_masks = []
    for i in range(cfg.lpips_layers):
        lp = per_layer[i]
        if autocal and periodic_ref.any():
            p95 = float(np.percentile(lp[periodic_ref], 95))
            lp = lp * (0.5 * cfg.lpips_thresh / max(p95, 1e-8))
        lp_np = non_period * lp
        lpips_maps.append(lp_np)
        lp_ok = lp_np < cfg.lpips_thresh
        if hyst != 1.0:
            lp_ok = np.where(init_np, lp_np < cfg.lpips_thresh * hyst,
                             lp_ok)
        lpips_masks.append(lp_ok)
        period_i = lp_ok & l1_ok
        np_i = (~period_i).astype(np.float64)
        non_period_final = np_i if non_period_final is None \
            else non_period_final + np_i

    non_period_final = non_period_final > 0
    if getattr(cfg, 'seg_texture_criterion', False):
        # texture-energy cue (additive only): valid pixels whose local
        # grayscale std sits far below the periodic region's low quantile
        win = int(getattr(cfg, 'seg_texture_window', 9))
        beta = float(getattr(cfg, 'seg_texture_beta', 0.5))
        g = blur_gray[..., 0]
        mean = ndimage.uniform_filter(g, win)
        sq = ndimage.uniform_filter(g * g, win)
        energy = np.sqrt(np.maximum(sq - mean * mean, 0.0))
        if periodic_ref.any():
            thr = beta * float(np.percentile(energy[periodic_ref], 25))
            non_period_final = non_period_final | (
                (energy < thr) & (valid[..., 0] > 0.5))
    if getattr(cfg, 'seg_refine_protect', False):
        # restore every init component that keeps any refined evidence,
        # before the small-object removal
        init_mask = non_period > 0.5
        lab, n = ndimage.label(init_mask,
                               ndimage.generate_binary_structure(2, 1))
        if n:
            keep = np.zeros(n + 1, bool)
            keep[np.unique(lab[non_period_final & init_mask])] = True
            keep[0] = False
            non_period_final = non_period_final | keep[lab]
    non_period_final = ndimage.binary_fill_holes(non_period_final)
    non_period_final = remove_small_objects(non_period_final, min_size=500,
                                            connectivity=1)
    oh, ow = data.orig_shape
    return {
        'non_period_mask': non_period_final.astype(np.float64)[:oh, :ow, None],
        'l1_img': (l1_img * valid[..., 0])[:oh, :ow],
        'l1_mask': l1_ok[:oh, :ow],
        'lpips_maps': [m[:oh, :ow] for m in lpips_maps],
        'lpips_masks': [m[:oh, :ow] for m in lpips_masks],
    }


def overlay(img: np.ndarray, non_period_mask: np.ndarray,
            valid_mask: np.ndarray, alpha: float = 0.7) -> np.ndarray:
    """Green non-periodic overlay (reference: train.py:398-406)."""
    np_color = np.array([0.0, 1.0, 0.0])
    m = non_period_mask
    vis = img * alpha + (1 - alpha) * (np_color * m + img * (1 - m))
    return vis * valid_mask


def save_refinement(save_dir: str, i: int, data, pred: np.ndarray,
                    res: Dict[str, np.ndarray]) -> None:
    """Write the per-eval artifact set (reference: NPP_segmentation/
    train.py:357,390,398-406), and the raw refined mask."""
    d = os.path.join(save_dir, f'testset_{i:06d}')
    write_gray(os.path.join(d, 'l1_diff_img.png'), res['l1_img'])
    # inverted threshold masks, as the reference saves them
    write_gray(os.path.join(d, 'l1_img_mask.png'),
               (~res['l1_mask']).astype(np.float64))
    for j, lp in enumerate(res['lpips_maps']):
        write_gray(os.path.join(d, f'lpips_diff_img_{j}.png'),
                   np.clip(lp, 0, 1))
        write_gray(os.path.join(d, f'lpips_img_mask_{j}.png'),
                   (~res['lpips_masks'][j]).astype(np.float64))
    oh, ow = data.orig_shape
    write_rgb(os.path.join(d, 'segment.png'),
              overlay(data.img[:oh, :ow], res['non_period_mask'],
                      data.valid_mask[:oh, :ow]))
    write_gray(os.path.join(d, 'segment_mask.png'),
               (np.asarray(res['non_period_mask'])[..., 0] > 0
                ).astype(np.float64)[:oh, :ow])
    write_rgb(os.path.join(d, 'pred_rgb_img.png'),
              (pred * data.valid_mask)[:oh, :ow])


def run_segmentation(cfg, save: bool = True, device=None,
                     data: Optional[dict] = None):
    """End-to-end segmentation on one detected example dir (cfg.datadir),
    or on `data`, the arrays of models/loaders.py::segmentation_data (e.g.
    utils/synthetic.py::synthetic_segment_data). Runs on the card unless
    device='cpu' is passed; SLIC and the spatial LPIPS run there too.
    Returns (fit result, refinements by iteration, task data); the
    coarse mask is the data's extra['non_period_mask']."""
    device = resolve_device(device)
    with matmul_precision('float32'):
        data = load_segmentation(cfg, device) if data is None else \
            segmentation_data(data, cfg, device)
    name = cfg.datadir.rstrip('/').split('/')[-1] or 'example'
    save_dir = os.path.join(cfg.basedir, f'{cfg.expname}_top{cfg.p_topk}',
                            name)
    if save:
        oh, ow = data.orig_shape
        write_gray(os.path.join(save_dir, 'segment_init.png'),
                   (data.extra['non_period_mask'] > 0
                    ).astype(np.float64)[:oh, :ow])

    lpips_alex = LPIPS(device, net='alex')
    results: Dict[int, Dict[str, np.ndarray]] = {}
    h, w = data.img.shape[:2]

    def refine(i: int, params, render):
        pred = render(params, h, w).to(torch.float32).cpu().numpy()
        res = refine_segmentation(cfg, data, pred, lpips_alex)
        results[i] = res
        print(f"[segmentation] eval@{i}: non-periodic fraction="
              f"{float(res['non_period_mask'].mean()):.3f}", flush=True)
        if save:
            save_refinement(save_dir, i, data, pred, res)

    def eval_hook(i: int, state: FitState, render):
        refine(i, state.params, render)

    result = fit_image(cfg, data, eval_hook=eval_hook, log_every=cfg.i_print,
                       device=device, task=SEGMENTATION_TASK)
    if not results:  # at least one refinement, at the end
        with matmul_precision('float32'):    # the render sets its own
            refine(cfg.N_iters - 1, result.state.params, result.render)
    return result, results, data
