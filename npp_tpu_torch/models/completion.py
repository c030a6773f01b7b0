"""Completion task: inpaint the unknown region of a near-periodic image
(reference: NPP_completion/train.py:20-343). Port of
`npp_tpu/models/completion.py`, with the held-out blocks (cfg.comp_heldout,
models/heldout.py) and the 'best' snapshot policy, without the seam-aware
composite (comp_seam needs cv2.inpaint), so the outputs
`pred_rgb_img_comp_seam` and `val_lpips_seam` are absent."""
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
from ..utils.io import write_rgb
from .heldout import carve_heldout, heldout_psnr
from .loaders import TaskData, load_completion
from .pipeline import FitState, check_slice, fit_image


@torch.no_grad()
def evaluate(data: TaskData, params, render, adaptive_pix, loss_type: str,
             device: torch.device, return_pred: bool = False
             ) -> Dict[str, object]:
    """Render the canvas and compose the reference's output set
    (reference: NPP_completion/train.py:270-331), plus PSNR metrics.
    return_pred: also emit the raw canvas render as 'pred' (numpy), which
    the 'best' snapshot policy stores to re-compose at the end."""
    h, w = data.img.shape[:2]
    pred = render(params, h, w)
    out = compose_outputs(pred, data, adaptive_pix, loss_type, device)
    if return_pred:
        out['pred'] = pred.cpu().numpy()
    return out


@torch.no_grad()
def compose_outputs(pred, data: TaskData, adaptive_pix,
                    loss_type: str, device: torch.device) -> Dict[str, object]:
    """The output set + metrics from an already-rendered canvas (a tensor
    or a numpy array). Also 'heldout_psnr' where `data` carries held-out
    blocks: against their known input content, never the hole's truth."""
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
    check_slice(cfg)
    if data is None:
        data = load_completion(cfg)
    name = cfg.datadir.rstrip('/').split('/')[-1] or 'example'
    save_dir = os.path.join(cfg.basedir, f'{cfg.expname}_top{cfg.p_topk}',
                            name)
    data_fit, data_eval, snapshot_best = heldout_views(data, cfg)
    evals: Dict[int, Dict[str, float]] = {}
    best: Dict[str, object] = {}   # best held-out snapshot

    def eval_hook(i: int, state: FitState, render):
        res = evaluate(data_eval, state.params, render,
                       state.params.adaptive_pix, cfg.loss_type, device,
                       return_pred=snapshot_best)
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
                           'pred_rgb_img', 'pred_rgb_img_comp'))
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
                         params.adaptive_pix, cfg.loss_type, device)
        final['snapshot_iter'] = cfg.N_iters - 1
        if snapshot_best and best and \
                best['score'] > final.get('heldout_psnr', -np.inf):
            # the held-out criterion prefers an earlier milestone:
            # re-compose the final output set from its stored render
            final = compose_outputs(best['pred'], data_eval, best['adaptive'],
                                    cfg.loss_type, device)
            final['snapshot_iter'] = best['iter']

    # final LPIPS of the composite vs gt (absolute values need converted
    # pretrained towers)
    percep = result.components.percep or LPIPS(device, net='vgg')
    oh, ow = data.orig_shape
    comp = torch.as_tensor(final['pred_rgb_img_comp'], dtype=torch.float32,
                           device=device)[None]
    gt = torch.as_tensor((data.img * data.valid_mask)[:oh, :ow],
                         dtype=torch.float32, device=device)[None]
    with torch.no_grad(), matmul_precision('float32'):
        final['val_lpips'] = float(torch.mean(percep(comp, gt, normalize=True)))
    if save:
        _save(os.path.join(save_dir, 'testset_final'), final,
              ('pred_rgb_img', 'pred_rgb_img_comp'))
    return result, final, evals
