"""Remapping task: re-render the whole image sharply by fitting only to
clear (non-blurry) regions with a style loss (reference:
NPP_remapping/train.py:28-380). Port of `npp_tpu/models/remapping.py`.

The collapse guard (cfg.remap_guard, default on) keeps a host copy (a CPU
state_dict) of the parameters at the best-train_psnr milestone; if the
final eval sits more than cfg.remap_guard_db below that best, the final
outputs come from the best milestone instead and carry
'collapse_guard_iter'. Healthy runs are untouched.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..losses.lpips import LPIPS
from ..losses.pixel import img2mse, mse2psnr
from ..utils.io import write_gray, write_rgb
from .loaders import TaskData, load_remapping, remapping_data
from .pipeline import FitState, check_slice, fit_image
from .trainer import TaskSpec

REMAPPING_TASK = TaskSpec(name='remapping', use_style=True,
                          pixel_mask_from_gt=True)


@torch.no_grad()
def evaluate(data: TaskData, params, render, adaptive_pix, loss_type: str,
             device: torch.device, percep: Optional[LPIPS] = None
             ) -> Dict[str, object]:
    """reference: NPP_remapping/train.py:306-365. percep: an LPIPS tower,
    which adds 'full_lpips' (the re-render against the input) and
    'clear_lpips' (the render pasted into the input inside the clear mask,
    so only clear-region deviations count)."""
    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    h, w = data.img.shape[:2]
    pred = render(params, h, w).to(device=device, dtype=torch.float32)
    valid, img = dev(data.valid_mask), dev(data.img)
    clear = dev(data.extra['clear_mask'])
    oh, ow = data.orig_shape
    out: Dict[str, object] = {
        'pred_rgb_train_img': (pred * valid)[:oh, :ow].cpu().numpy(),
        'pred_rgb_val_img': (pred * clear * valid)[:oh, :ow].cpu().numpy(),
        'pred_rgb_img': (pred * valid)[:oh, :ow].cpu().numpy(),
    }
    for key, coords in (('train', data.i_train), ('val', data.i_val)):
        if len(coords):
            c = torch.as_tensor(np.asarray(coords), dtype=torch.long,
                                device=device)
            pt, gt = pred[c[:, 0], c[:, 1]], img[c[:, 0], c[:, 1]]
            out[f'img_{key}_loss'] = float(img2mse(pt, gt, loss_type,
                                                   adaptive_pix))
            out[f'{key}_psnr'] = float(mse2psnr(torch.mean((pt - gt) ** 2)))
    if percep is not None:
        gt_full = (img * valid)[None, :oh, :ow]
        out['full_lpips'] = float(torch.mean(percep(
            (pred * valid)[None, :oh, :ow], gt_full, normalize=True)))
        cm = (clear * valid)[:oh, :ow]
        comp = pred[:oh, :ow] * cm + img[:oh, :ow] * (1.0 - cm)
        out['clear_lpips'] = float(torch.mean(percep(
            comp[None] * valid[None, :oh, :ow], gt_full, normalize=True)))
    return out


def run_remapping(cfg, save: bool = True, device=None,
                  data: Optional[dict] = None):
    """End-to-end remapping on one detected example dir (cfg.datadir), or
    on `data`, the arrays of models/loaders.py::remapping_data (e.g.
    utils/synthetic.py::synthetic_remap_data). Runs on the card unless
    device='cpu' is passed; the blur map runs there too. Returns (fit
    result, final outputs, evals by iteration)."""
    device = resolve_device(device)
    check_slice(cfg)
    with matmul_precision('float32'):
        data = load_remapping(cfg, device) if data is None else \
            remapping_data(data, cfg, device)
    name = cfg.datadir.rstrip('/').split('/')[-1] or 'example'
    save_dir = os.path.join(cfg.basedir, f'{cfg.expname}_top{cfg.p_topk}',
                            name)
    oh, ow = data.orig_shape
    if save:
        write_gray(os.path.join(save_dir, 'blur_mask.png'),
                   data.extra['clear_mask'][:oh, :ow])

    evals: Dict[int, Dict[str, float]] = {}
    best = {'psnr': -np.inf, 'iter': None, 'params': None}
    guard_on = bool(cfg.remap_guard)

    def eval_hook(i: int, state: FitState, render):
        res = evaluate(data, state.params, render, state.params.adaptive_pix,
                       cfg.loss_type, device)
        evals[i] = {k: v for k, v in res.items() if np.isscalar(v)}
        tp = float(res.get('train_psnr', float('nan')))
        if guard_on and np.isfinite(tp) and tp > best['psnr']:
            best.update(psnr=tp, iter=i, params={
                k: v.detach().cpu().clone()
                for k, v in state.params.state_dict().items()})
        print(f"[remapping] eval@{i}: "
              f"train_psnr={res.get('train_psnr', float('nan')):.2f} "
              f"val_psnr={res.get('val_psnr', float('nan')):.2f}", flush=True)
        if save:
            d = os.path.join(save_dir, f'testset_{i:06d}')
            for key in ('pred_rgb_train_img', 'pred_rgb_val_img',
                        'pred_rgb_img'):
                write_rgb(os.path.join(d, f'{key}.png'), res[key])
            write_rgb(os.path.join(d, 'gt_rgb_img.png'),
                      (data.img * data.valid_mask)[:oh, :ow])

    result = fit_image(cfg, data, eval_hook=eval_hook, log_every=cfg.i_print,
                       device=device, task=REMAPPING_TASK)
    percep = LPIPS(device, net='vgg')
    params = result.state.params
    with matmul_precision('float32'):    # the render sets its own
        final = evaluate(data, params, result.render, params.adaptive_pix,
                         cfg.loss_type, device, percep=percep)
        if guard_on and best['params'] is not None and \
                float(final.get('train_psnr', np.inf)) < \
                best['psnr'] - cfg.remap_guard_db:
            print(f"[remapping] COLLAPSE GUARD: final train_psnr "
                  f"{float(final.get('train_psnr', float('nan'))):.2f} is "
                  f">{cfg.remap_guard_db:.0f} dB under the best milestone "
                  f"({best['psnr']:.2f} @ iter {best['iter']}); returning "
                  f"the best-milestone snapshot", flush=True)
            params = copy.deepcopy(params)
            params.load_state_dict(best['params'])
            final = evaluate(data, params, result.render, params.adaptive_pix,
                             cfg.loss_type, device, percep=percep)
            final['collapse_guard_iter'] = float(best['iter'])
    return result, final, evals
