"""Completion task: inpaint the unknown region of a near-periodic image
(reference: NPP_completion/train.py:20-343). Port of
`npp_tpu/models/completion.py`, with the held-out blocks (cfg.comp_heldout,
models/heldout.py), the 'best' snapshot policy and the seam-aware residual
composite (cfg.comp_seam), whose Navier-Stokes inpainting is the port's
own host library (ops/inpaint.py)."""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..losses.lpips import LPIPS
from ..losses.pixel import img2mse, mse2psnr
from ..ops.inpaint import inpaint_ns
from ..utils.io import write_rgb
from .heldout import carve_heldout, heldout_psnr
from .loaders import TaskData, load_completion
from .pipeline import FitState, fit_image

OUTPUT_KEYS = ('pred_rgb_img', 'pred_rgb_img_comp', 'pred_rgb_img_comp_seam')


def seam_residual_correction(pred: np.ndarray, masked: np.ndarray,
                             known: np.ndarray, hole: np.ndarray,
                             value_range: float = 1.0) -> np.ndarray:
    """The prediction with the known region's render error diffused into
    the hole (cfg.comp_seam='residual'; npp_tpu/models/completion.py:21-47,
    which has no reference equivalent). err = masked - pred on the known
    region, 0 elsewhere, is quantised to uint8 over [-value_range,
    value_range] (np.uint8 truncates) and Navier-Stokes-inpainted across
    the hole (radius 3), so the composite meets the known content without
    a step and loses the hole's low-frequency offset. value_range: 2.0 for
    normalize_type=2 ([-1, 1] images), else 1.0. Float64 numpy on the
    host, as in npp_tpu."""
    scale = 127.5 / float(value_range)
    err = np.where(known[..., None] > 0.5, masked - pred, 0.0)
    err_u8 = np.uint8(np.clip(err * scale + 127.5, 0, 255))
    hole_u8 = np.uint8(hole * 255)
    filled = inpaint_ns(err_u8, hole_u8, 3)
    err_filled = (filled.astype(np.float64) - 127.5) / scale
    return np.where(hole[..., None] > 0.5, pred + err_filled, pred)


@torch.no_grad()
def evaluate(data: TaskData, params, render, adaptive_pix, loss_type: str,
             device: torch.device, comp_seam: str = 'none',
             normalize_type: int = 1, compute_seam: Optional[bool] = None,
             return_pred: bool = False) -> Dict[str, object]:
    """Render the canvas and compose the reference's output set
    (reference: NPP_completion/train.py:270-331), plus PSNR metrics; the
    seam outputs as compose_outputs says.
    return_pred: also emit the raw canvas render as 'pred' (numpy), which
    the 'best' snapshot policy stores to re-compose at the end."""
    h, w = data.img.shape[:2]
    pred = render(params, h, w)
    out = compose_outputs(pred, data, adaptive_pix, loss_type, device,
                          comp_seam=comp_seam, normalize_type=normalize_type,
                          compute_seam=compute_seam)
    if return_pred:
        out['pred'] = pred.cpu().numpy()
    return out


@torch.no_grad()
def compose_outputs(pred, data: TaskData, adaptive_pix,
                    loss_type: str, device: torch.device,
                    comp_seam: str = 'none', normalize_type: int = 1,
                    compute_seam: Optional[bool] = None) -> Dict[str, object]:
    """The output set + metrics from an already-rendered canvas (a tensor
    or a numpy array). Also 'heldout_psnr' where `data` carries held-out
    blocks: against their known input content, never the hole's truth.

    The seam-corrected composite (seam_residual_correction) comes out as
    'pred_rgb_img_comp_seam' with 'val_psnr_seam'; under
    comp_seam='residual' it is also 'pred_rgb_img_comp'. compute_seam:
    whether to make the seam outputs at all (a host inpainting of the
    canvas); None makes them only under 'residual', and the final evals
    pass True."""
    if compute_seam is None:
        compute_seam = comp_seam == 'residual'

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    pred = torch.as_tensor(pred).to(device=device, dtype=torch.float32)
    mask, valid = dev(data.mask), dev(data.valid_mask)
    img, masked = dev(data.img), dev(data.masked_img)

    train_img = pred * mask * valid
    val_img = pred * (1.0 - mask) * valid
    comp = val_img + masked * mask

    oh, ow = data.orig_shape
    out: Dict[str, object] = {
        'pred_rgb_train_img': train_img[:oh, :ow].cpu().numpy(),
        'pred_rgb_val_img': val_img[:oh, :ow].cpu().numpy(),
        'pred_rgb_img': (pred * valid)[:oh, :ow].cpu().numpy(),
        'pred_rgb_img_comp': comp[:oh, :ow].cpu().numpy(),
    }
    pred_seam = None
    if compute_seam:
        m_np = np.asarray(data.mask)
        v_np = np.asarray(data.valid_mask)
        masked_np = np.asarray(data.masked_img, np.float64)
        pred_seam = seam_residual_correction(
            pred.cpu().numpy().astype(np.float64), masked_np,
            (m_np * v_np)[..., 0], ((1 - m_np) * v_np)[..., 0],
            value_range=2.0 if normalize_type == 2 else 1.0)
        comp_seam_img = pred_seam * (1.0 - m_np) * v_np + \
            np.asarray(data.masked_img) * m_np
        out['pred_rgb_img_comp_seam'] = comp_seam_img[:oh, :ow]
        if comp_seam == 'residual':
            out['pred_rgb_img_comp'] = out['pred_rgb_img_comp_seam']
    tc = torch.as_tensor(np.asarray(data.i_train), dtype=torch.long,
                         device=device)
    vc = torch.as_tensor(np.asarray(data.i_val), dtype=torch.long,
                         device=device)
    if len(tc):
        pt, gt = pred[tc[:, 0], tc[:, 1]], masked[tc[:, 0], tc[:, 1]]
        out['img_train_loss'] = float(img2mse(pt, gt, loss_type, adaptive_pix))
        out['train_psnr'] = float(mse2psnr(torch.mean((pt - gt) ** 2)))
    if len(vc):
        pv, gv = pred[vc[:, 0], vc[:, 1]], img[vc[:, 0], vc[:, 1]]
        out['img_val_loss'] = float(img2mse(pv, gv, loss_type, adaptive_pix))
        out['val_psnr'] = float(mse2psnr(torch.mean((pv - gv) ** 2)))
        if pred_seam is not None:
            vn = np.asarray(data.i_val)
            mse = np.mean((pred_seam[vn[:, 0], vn[:, 1]] -
                           gv.cpu().numpy()) ** 2)
            out['val_psnr_seam'] = float(mse2psnr(
                torch.tensor(mse, dtype=torch.float32)))
    if 'heldout_mask' in data.extra:
        hp = heldout_psnr(pred.cpu().numpy(), data)
        if hp is not None:
            out['heldout_psnr'] = hp
    return out


def heldout_views(data: TaskData, cfg):
    """The fit-side and eval-side views for cfg.comp_heldout
    (npp_tpu/models/completion.py:326-345): (data_fit, data_eval,
    snapshot_best). data_fit has the held-out blocks carved; data_eval
    keeps the original mask and known content plus the held-out extras, so
    evaluate() emits 'heldout_psnr'; snapshot_best: the 'best' policy is on
    and blocks were placeable."""
    data_fit = carve_heldout(data, cfg)
    if data_fit is data or 'heldout_mask' not in data_fit.extra:
        return data, data, False
    extra = dict(data.extra)
    extra.update({k: data_fit.extra[k] for k in
                  ('heldout_rects', 'heldout_mask', 'heldout_gt')})
    return data_fit, dataclasses.replace(data, extra=extra), \
        cfg.comp_snapshot == 'best'


def _save(d: str, res: Dict[str, object], keys) -> None:
    for key in keys:
        if key in res:
            write_rgb(os.path.join(d, f'{key}.png'), res[key])


def run_completion(cfg, save: bool = True, device=None,
                   data: Optional[TaskData] = None):
    """End-to-end completion on one detected example dir (cfg.datadir), or
    on `data` when given. Runs on the card unless device='cpu' is passed.
    Returns (fit result, final outputs, evals by iteration)."""
    device = resolve_device(device)
    if data is None:
        data = load_completion(cfg)
    name = cfg.datadir.rstrip('/').split('/')[-1] or 'example'
    save_dir = os.path.join(cfg.basedir, f'{cfg.expname}_top{cfg.p_topk}',
                            name)
    data_fit, data_eval, snapshot_best = heldout_views(data, cfg)
    evals: Dict[int, Dict[str, float]] = {}
    best: Dict[str, object] = {}   # best held-out snapshot

    seam = dict(comp_seam=cfg.comp_seam, normalize_type=cfg.normalize_type)

    def eval_hook(i: int, state: FitState, render):
        # the seam composite is a host inpainting: the intermediate evals
        # make it only under 'residual', the last testset always
        final_eval = i + cfg.i_testset > cfg.N_iters - 1
        res = evaluate(data_eval, state.params, render,
                       state.params.adaptive_pix, cfg.loss_type, device,
                       compute_seam=final_eval or None,
                       return_pred=snapshot_best, **seam)
        evals[i] = {k: v for k, v in res.items() if np.isscalar(v)}
        ho = res.get('heldout_psnr')
        print(f"[completion] eval@{i}: "
              f"train_psnr={res.get('train_psnr', float('nan')):.2f} "
              f"val_psnr={res.get('val_psnr', float('nan')):.2f}" +
              (f" heldout_psnr={ho:.2f}" if ho is not None else ""),
              flush=True)
        if snapshot_best and ho is not None and \
                ho > best.get('score', -np.inf):
            # the render and a copy of the pixel latents (a later step
            # moves the live ones)
            best.update(score=ho, iter=i, pred=res['pred'],
                        adaptive=copy.deepcopy(state.params.adaptive_pix))
        if save:
            d = os.path.join(save_dir, f'testset_{i:06d}')
            _save(d, res, ('pred_rgb_train_img', 'pred_rgb_val_img',
                           *OUTPUT_KEYS))
            oh, ow = data.orig_shape
            write_rgb(os.path.join(d, 'gt_rgb_img.png'),
                      (data.img * data.valid_mask)[:oh, :ow])
            write_rgb(os.path.join(d, 'input_rgb_img.png'),
                      (data.masked_img * data.valid_mask)[:oh, :ow])

    result = fit_image(cfg, data_fit, eval_hook=eval_hook,
                       log_every=cfg.i_print, device=device)
    params = result.state.params
    with matmul_precision('float32'):    # the render sets its own
        final = evaluate(data_eval, params, result.render,
                         params.adaptive_pix, cfg.loss_type, device,
                         compute_seam=True, **seam)
        final['snapshot_iter'] = cfg.N_iters - 1
        if snapshot_best and best and \
                best['score'] > final.get('heldout_psnr', -np.inf):
            # the held-out criterion prefers an earlier milestone:
            # re-compose the final output set from its stored render
            final = compose_outputs(best['pred'], data_eval, best['adaptive'],
                                    cfg.loss_type, device, compute_seam=True,
                                    **seam)
            final['snapshot_iter'] = best['iter']

    final_lpips(final, data, result.components.percep or
                LPIPS(device, net='vgg'), device)
    if save:
        _save(os.path.join(save_dir, 'testset_final'), final, OUTPUT_KEYS)
    return result, final, evals


def final_lpips(final: Dict[str, object], data: TaskData, percep: LPIPS,
                device: torch.device) -> None:
    """'val_lpips' of the composite and 'val_lpips_seam' of the seam
    composite against the ground truth, into `final` (absolute values need
    converted pretrained towers)."""
    oh, ow = data.orig_shape
    gt = torch.as_tensor((data.img * data.valid_mask)[:oh, :ow],
                         dtype=torch.float32, device=device)[None]
    for key, name in (('pred_rgb_img_comp', 'val_lpips'),
                      ('pred_rgb_img_comp_seam', 'val_lpips_seam')):
        if key in final:
            comp = torch.as_tensor(final[key], dtype=torch.float32,
                                   device=device)[None]
            with torch.no_grad(), matmul_precision('float32'):
                final[name] = float(torch.mean(percep(comp, gt,
                                                      normalize=True)))
