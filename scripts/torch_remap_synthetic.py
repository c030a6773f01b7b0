"""One whole remapping fit of the PyTorch port on one CUDA card.

    python3 scripts/torch_remap_synthetic.py [--iters 2801] [--i_print 400]
                                             [--out FILE]

Runs `run_remapping` at the default RemappingConfig (the reference's
schedule: evals every 400 iterations, the collapse guard on) on the
384x512 synthetic remapping example of npp_tpu_torch/utils/synthetic.py
(the flagship image blurred with sigma 2.5 inside an ellipse, made from a
seed), and prints one JSON line: the wall seconds of the whole call, ms
per step of each logged block, train/val PSNR at each eval, the final
metrics (train and clear-region PSNR against the input, full_lpips,
clear_lpips, collapse_guard_iter if the guard fired), the peak device
memory, and what the task is for: the PSNR of the render against the
sharp image inside the blurred ellipse and outside it, beside the blurred
input's own PSNR inside it. Needs a card; writes the JSON to --out as well.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def psnr(a, b):
    import numpy as np
    return float(-10.0 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-12)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=2801)
    ap.add_argument('--i_print', type=int, default=400,
                    help='log cadence; blocks are gcd(i_testset, i_print) '
                         'steps')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'torch_remap_synthetic.json'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_remap_synthetic: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.config import RemappingConfig, replace
    from npp_tpu_torch.models.remapping import run_remapping
    from npp_tpu_torch.utils.synthetic import synthetic_remap_data

    cfg = replace(RemappingConfig(), N_iters=args.iters, i_print=args.i_print)
    arrays = synthetic_remap_data(cfg.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result, final, evals = run_remapping(cfg, save=False, device='cuda',
                                         data=arrays)
    torch.cuda.synchronize()
    wall = time.time() - t0
    pred, sharp = final['pred_rgb_img'], arrays['sharp']
    inside = arrays['blur_region']
    out = {
        'device': torch.cuda.get_device_name(0), 'iters': args.iters - 1,
        'matmul_precision': cfg.matmul_precision, 'wall_s': wall,
        'ms_per_step': {h['iter']: h['ms_per_step'] for h in result.history},
        'evals': {i: {k: e[k] for k in ('train_psnr', 'val_psnr')}
                  for i, e in evals.items()},
        'final': {k: final[k] for k in ('train_psnr', 'val_psnr',
                                        'full_lpips', 'clear_lpips',
                                        'collapse_guard_iter') if k in final},
        'vs_sharp_psnr': {
            'render_in_blur_region': psnr(pred[inside], sharp[inside]),
            'render_outside': psnr(pred[~inside], sharp[~inside]),
            'input_in_blur_region': psnr(arrays['gt_img'][inside],
                                         sharp[inside])},
        'peak_bytes': torch.cuda.max_memory_allocated(),
    }
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
