"""One whole completion fit of the PyTorch port on one CUDA card.

    python3 scripts/torch_fit_synthetic.py [--iters 2001] [--i_print 500]
                                           [--matmul_precision NAME]
                                           [--out FILE]

Runs `run_completion` at the default CompletionConfig (the reference's
schedule: evals every 500 iterations, patch-size decay at 2000) on the
384x512 synthetic example of npp_tpu_torch/utils/synthetic.py, made from
a seed, at the default matmul_precision ('bfloat16': TF32 in the steps
and the render) or the one given, and prints one JSON line: the wall seconds of the whole call, ms per
step of each logged block, train/val PSNR at each eval, the final val_lpips
and the peak device memory. Needs a card; writes the JSON to --out as well.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--iters', type=int, default=2001)
    ap.add_argument('--i_print', type=int, default=500,
                    help='log cadence; blocks are gcd(i_testset, i_print) '
                         'steps')
    ap.add_argument('--matmul_precision', default=None,
                    help="the fit's matmul_precision (default: "
                         "CompletionConfig's)")
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'torch_fit_synthetic.json'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_fit_synthetic: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.config import CompletionConfig, replace
    from npp_tpu_torch.models.completion import run_completion
    from npp_tpu_torch.utils.synthetic import synthetic_data

    cfg = replace(CompletionConfig(), N_iters=args.iters,
                  i_print=args.i_print)
    if args.matmul_precision:
        cfg = replace(cfg, matmul_precision=args.matmul_precision)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result, final, evals = run_completion(cfg, save=False, device='cuda',
                                          data=synthetic_data(cfg.seed))
    torch.cuda.synchronize()
    out = {
        'device': torch.cuda.get_device_name(0), 'iters': args.iters - 1,
        'matmul_precision': cfg.matmul_precision,
        'wall_s': time.time() - t0,
        'ms_per_step': {h['iter']: h['ms_per_step'] for h in result.history},
        'evals': {i: {k: e[k] for k in ('train_psnr', 'val_psnr')}
                  for i, e in evals.items()},
        'final': {k: final[k] for k in ('train_psnr', 'val_psnr',
                                        'val_lpips')},
        'peak_bytes': torch.cuda.max_memory_allocated(),
    }
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
