#!/usr/bin/env python
"""The remapping evaluation on square-wave images, run through the PyTorch
port: the counterpart of scripts/eval_remapping.py's synthetic part and its
A/B arms.

Each synthetic example is a sharp soft-square-wave lattice (256x320) with an
elliptical region Gaussian-blurred (sigma 2.5). The whole pipeline
(search -> blur detection -> weighted fit -> re-render) must restore that
region; it is scored against the sharp original: blur-region PSNR and bbox
LPIPS, clear-region PSNR, beside the classical baselines (the blurred input
itself and unsharp masking at amounts 1.5 and 3). Arms: 'ref' (the default
RemappingConfig), with --ab-style 'style0' (use_style_loss=False), with
--ab-iters 'iters2x' (twice the schedule).

The JAX script's bundled part is left out: it reads the reference
checkout's example images, which this repository does not hold.

No OpenCV (the card's machine has none): the Gaussian is scipy's
gaussian_filter with mode='mirror' and truncate=4.0, which is
cv2.GaussianBlur(img, (0, 0), sigma)'s kernel and border on float64 images,
and the PNGs go through utils/png.py (pixel-equal to cv2 both ways), so
both packages fit the same pixels.

  python scripts/torch_eval_remapping.py [--iters-scale 1.0]
      [--out remap_eval_out] [--n-synth 2] [--search-iters N]
      [--ab-style] [--ab-iters] [--device cpu|cuda]

Runs on the card unless --device cpu is given. Prints one JSON line per
example with the JAX script's keys, then its summary line, and writes
OUT/remap_records.json; on stderr (and in OUT/remap_runs.json) the card's
name and power limit, each search's and each fit's wall seconds and
whether the collapse guard fired.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.ndimage as ndimage

BASELINES = ('identity', 'unsharp_1.5', 'unsharp_3')


def gaussian_blur(img, sigma):
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float64 (H, W, C) image:
    radius 4 sigma, reflect-101 border."""
    return np.stack([ndimage.gaussian_filter(img[..., c], sigma,
                                             mode='mirror', truncate=4.0)
                     for c in range(img.shape[-1])], -1)


def synth_blur_example(seed, h=256, w=320):
    """Sharp near-periodic lattice with fine detail (square-ish waves keep
    high harmonics for the blur to destroy) + an elliptical Gaussian-blurred
    region; scripts/eval_remapping.py's draws. Returns (sharp, blurred,
    blur_mask)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    py, px = rng.choice([12, 14, 16]), rng.choice([14, 16, 20])
    ph = rng.uniform(0, 2 * np.pi, 3)

    def sq(t):   # soft square wave: sharp edges, band-limited enough
        return np.tanh(3.0 * np.sin(t))

    base = np.asarray([0.52, 0.48, 0.45])
    osc = np.stack([sq(2 * np.pi * xx / px + ph[0]),
                    sq(2 * np.pi * yy / py + ph[1]),
                    sq(2 * np.pi * (xx / px + yy / py) + ph[2])], -1)
    amp = np.asarray([0.2, 0.17, 0.12])
    sharp = np.clip(base + amp * osc + rng.randn(h, w, 3) * 0.01, 0, 1)

    cy, cx_ = rng.randint(h // 3, 2 * h // 3), rng.randint(w // 3, 2 * w // 3)
    ry, rx = rng.randint(50, 70), rng.randint(60, 85)
    blur_mask = (((yy - cy) / ry) ** 2 + ((xx - cx_) / rx) ** 2 < 1)
    blurred = np.where(blur_mask[..., None], gaussian_blur(sharp, 2.5), sharp)
    return sharp, blurred, blur_mask


def psnr(a, b, m):
    mse = ((a - b) ** 2 * m[..., None]).sum() / (m.sum() * 3.0)
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def unsharp(img, mask, sigma=2.0, amount=1.5):
    """Classical local sharpening: unsharp mask applied in `mask` only."""
    hp = img - gaussian_blur(img, sigma)
    out = np.clip(img + amount * hp, 0, 1)
    m3 = mask[..., None]
    return out * m3 + img * (1 - m3)


def lpips_val(percep, a, b, device):
    """Mean LPIPS of two (H, W, 3) [0, 1] images on the port's tower, in
    full f32 (cuDNN would take TF32 by default on the card)."""
    import torch
    from npp_tpu_torch.device import matmul_precision

    def t(x):
        return torch.as_tensor(np.asarray(x)[None], dtype=torch.float32,
                               device=device)

    with torch.no_grad(), matmul_precision('float32'):
        return float(torch.mean(percep(t(a), t(b), normalize=True)))


def bbox_lpips(percep, pred, gt, mask, device):
    """LPIPS on the blur-region bbox, pred composited into gt context
    (compare_telea.py's protocol)."""
    ys, xs = np.nonzero(mask)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    m3 = mask[..., None]
    comp = pred * m3 + gt * (1 - m3)
    return lpips_val(percep, comp[y0:y1, x0:x1], gt[y0:y1, x0:x1], device)


def write_inputs(in_dir, sharp, blurred, blur_mask):
    """The example as the pipeline reads it (eval_remapping.py:163-176):
    the blurred image as gt_img and masked_img, all-known masks, and the
    sharp original and the blur region as .npy."""
    from npp_tpu_torch.utils.io import write_gray, write_rgb
    for f in ('gt_img.png', 'masked_img.png'):
        write_rgb(os.path.join(in_dir, f), blurred)
    for f in ('unknown_mask.png', 'valid_mask.png'):
        write_gray(os.path.join(in_dir, f), np.ones(blurred.shape[:2]))
    np.save(os.path.join(in_dir, 'sharp_gt.npy'), sharp)
    np.save(os.path.join(in_dir, 'blur_mask.npy'), blur_mask)


def ensure_search(name, in_dir, out_root, search_iters, device):
    """Detection + ranking for one example (idempotent via the odgt)."""
    from npp_tpu_torch.config import SearchConfig, replace
    from npp_tpu_torch.proposal.search import run_search

    det_root = os.path.join(out_root, 'detected')
    det_dir = os.path.join(det_root, name)
    if not os.path.exists(os.path.join(det_dir, 'config.odgt')):
        scfg = replace(SearchConfig(), datadir=in_dir, outdir=det_root)
        if search_iters:
            scfg = replace(scfg, N_iters=search_iters)
        run_search(scfg, device=device)
    return det_dir


def run_arm(det_dir, out_root, arm, cfg_kw, iters_scale, device):
    from npp_tpu_torch.config import RemappingConfig, replace
    from npp_tpu_torch.models.remapping import run_remapping

    cfg = replace(RemappingConfig(), datadir=det_dir,
                  basedir=os.path.join(out_root, 'results', arm), **cfg_kw)
    if iters_scale != 1.0:
        cfg = replace(cfg, N_iters=max(2, int(cfg.N_iters * iters_scale)),
                      i_testset=max(1, int(cfg.i_testset * iters_scale)))
    result, final, _ = run_remapping(cfg, device=device)
    return result, final


T_START = time.perf_counter()


def _log(msg):
    print(f'[remap-eval] {time.perf_counter() - T_START:.1f}s {msg}',
          file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters-scale', type=float, default=1.0)
    ap.add_argument('--out', default='remap_eval_out')
    ap.add_argument('--n-synth', type=int, default=2)
    ap.add_argument('--search-iters', type=int, default=None,
                    help='override the ranking fit iterations')
    ap.add_argument('--ab-style', action='store_true',
                    help="add a use_style_loss=False arm (A/B the "
                         "reference's style loss)")
    ap.add_argument('--ab-iters', action='store_true',
                    help='add a 2x-schedule arm')
    ap.add_argument('--device', default=None,
                    help="'cpu' or 'cuda' (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from npp_tpu_torch.device import resolve_device, smi_line
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.utils.io import read_rgb

    device = resolve_device(args.device)
    runs = {'device': str(device), 'fits': [], 'searches': []}
    if device.type == 'cuda':
        runs.update(device_name=torch.cuda.get_device_name(device),
                    nvidia_smi=smi_line())
        _log(f'card: {runs["nvidia_smi"]}')

    arms = [('ref', {}, args.iters_scale)]
    if args.ab_style:
        arms.append(('style0', {'use_style_loss': False}, args.iters_scale))
    if args.ab_iters:
        arms.append(('iters2x', {}, args.iters_scale * 2.0))

    # every input written and every search run before any fit, as the JAX
    # script orders them
    synth = []
    for s in range(args.n_synth):
        name = f'synth_blur{s}'
        in_dir = os.path.join(args.out, 'input', name)
        os.makedirs(in_dir, exist_ok=True)
        write_inputs(in_dir, *synth_blur_example(seed=300 + s))
        synth.append((name, in_dir))
    det_dirs = {}
    for name, in_dir in synth:
        t0 = time.time()
        det_dirs[name] = ensure_search(name, in_dir, args.out,
                                       args.search_iters, device)
        runs['searches'].append({'example': name,
                                 'wall_s': time.time() - t0})
        _log(f'search {name}: {time.time() - t0:.1f}s')

    percep = LPIPS(device, net='vgg')
    records = []
    for name, in_dir in synth:
        sharp = np.load(os.path.join(in_dir, 'sharp_gt.npy'))
        blur_mask = np.load(os.path.join(in_dir, 'blur_mask.npy'))
        # the input quantised exactly as the pipeline reads it back
        inp = read_rgb(os.path.join(in_dir, 'gt_img.png'))
        base_rows = {'identity': inp,
                     'unsharp_1.5': unsharp(inp, blur_mask, 2.0, 1.5),
                     'unsharp_3': unsharp(inp, blur_mask, 2.0, 3.0)}
        rec = {'example': name,
               'blur_frac': round(float(blur_mask.mean()), 3)}
        for bname, bimg in base_rows.items():
            rec[f'psnr_blur_{bname}'] = round(psnr(bimg, sharp, blur_mask), 2)
            rec[f'lpips_blur_{bname}'] = round(
                bbox_lpips(percep, bimg, sharp, blur_mask, device), 4)
        _log(f'baselines {name} scored')

        for arm, kw, iscale in arms:
            t0 = time.time()
            result, final = run_arm(det_dirs[name], args.out, arm, kw, iscale,
                                    device)
            wall = time.time() - t0
            guard = final.get('collapse_guard_iter')
            runs['fits'].append({'example': name, 'arm': arm, 'wall_s': wall,
                                 'fit_wall_s': result.wall_time_s,
                                 'collapse_guard_iter': guard})
            _log(f'fit {name}/{arm}: {wall:.1f}s, collapse guard '
                 f'{"fired (iter %d)" % guard if guard else "not fired"}')
            pred = np.asarray(final['pred_rgb_img'], np.float64)
            pred = pred[:sharp.shape[0], :sharp.shape[1]]
            rec[f'psnr_blur_ours_{arm}'] = round(
                psnr(pred, sharp, blur_mask), 2)
            rec[f'lpips_blur_ours_{arm}'] = round(
                bbox_lpips(percep, pred, sharp, blur_mask, device), 4)
            rec[f'psnr_clear_ours_{arm}'] = round(
                psnr(pred, sharp, ~blur_mask), 2)
            rec[f'iters_per_sec_{arm}'] = round(result.iters_per_sec, 2)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if records:
        best_psnr = [max(r[f'psnr_blur_{b}'] for b in BASELINES)
                     for r in records]
        best_lpips = [min(r[f'lpips_blur_{b}'] for b in BASELINES)
                      for r in records]
        summary = {
            'beats_best_baseline_psnr': sum(
                r['psnr_blur_ours_ref'] > b
                for r, b in zip(records, best_psnr)),
            'beats_best_baseline_lpips': sum(
                r['lpips_blur_ours_ref'] < b
                for r, b in zip(records, best_lpips)),
            'total': len(records)}
        print(json.dumps({'summary': summary}), flush=True)
    with open(os.path.join(args.out, 'remap_records.json'), 'w') as f:
        json.dump(records, f, indent=1)
    with open(os.path.join(args.out, 'remap_runs.json'), 'w') as f:
        json.dump(runs, f, indent=1)
    print(json.dumps(runs), file=sys.stderr, flush=True)
    return records


if __name__ == '__main__':
    main()
