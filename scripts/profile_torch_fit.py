"""Where a fit step's device time goes, for the PyTorch port on one CUDA card.

    python3 scripts/profile_torch_fit.py [--blocks 2]
                                         [--matmul_precision bfloat16]
                                         [--task completion|remapping|
                                                 segmentation]
                                         [--warp_field] [--out FILE]

Builds the main path's fit (default CompletionConfig widths and
matmul_precision, or the one given: 'bfloat16' runs the steps' f32 matmuls
and convolutions in TF32, 'float32' in full f32; the 384x512
synthetic example of npp_tpu_torch/utils/synthetic.py, blocks of 10 steps
with the per-block embedding table), or with --task remapping the
remapping fit (default RemappingConfig widths, the synthetic remapping
example with its blur map on the card), or with --task segmentation the
segmentation fit (default SegmentationConfig widths, the 256x320
synthetic segmentation example with its coarse mask, SLIC on the card),
or with --warp_field the
completion with the warp field (K1 and its backward on the fly every
step), runs one block to warm up (kernel
builds, cuDNN's algorithm choice), then profiles `--blocks` more blocks with
torch.profiler. Prints, as one JSON line: the wall ms per step, the device
busy share (kernel time over wall time), the device time per step by group
(the port's kernels, matrix products, convolutions, the rest) and the top
kernels by device time. Needs a card; writes the JSON to --out as well.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (  # first match wins; names as the profiler reports kernels
    ('K1 periodic_embed', ('periodic_embed_kernel',)),
    ('K1 bwd', ('periodic_embed_bwd_kernel',)),
    ('K2 bias_snake', ('snake_fwd_kernel', 'snake_bwd_kernel')),
    ('K4 robust_rho', ('rho_fwd_group_kernel', 'rho_bwd_kernel',
                       'rho_bwd_finish', 'rho_fwd_wide_finish',
                       'rho_bwd_wide_kernel')),
    ('K3 cx_chain', ('cx_gemm', 'cx_row_', 'cx_col_', 'cx_grad_',
                     'cx_transpose', 'cx_round_copy', 'cx_l1_fill')),
    # cuDNN's tensor-core (TF32) convolutions add layout transforms, its
    # FFT convolutions fft2d_* kernels
    ('conv', ('conv', 'cudnn', 'implicit', 'winograd', 'fprop', 'dgrad',
              'wgrad', 'nchwtonhwc', 'nhwctonchw', 'fft2d')),
    # cuBLAS's Hopper GEMMs are named nvjet_* in recent releases
    ('matmul', ('gemm', 'xmma', 'cutlass', 'sm90_', 'nvjet', 'splitkreduce')),
)


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--blocks', type=int, default=2)
    ap.add_argument('--matmul_precision', default=None,
                    help="the fit's matmul_precision (default: "
                         "CompletionConfig's)")
    ap.add_argument('--task', default='completion',
                    choices=('completion', 'remapping', 'segmentation'))
    ap.add_argument('--warp_field', action='store_true')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'profile_torch_fit.json'))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        sys.exit('profile_torch_fit: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from npp_tpu_torch.config import (CompletionConfig, RemappingConfig,
                                      SegmentationConfig, replace)
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models.loaders import remapping_data, segmentation_data
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.remapping import REMAPPING_TASK
    from npp_tpu_torch.models.segmentation import SEGMENTATION_TASK
    from npp_tpu_torch.models.trainer import (COMPLETION_TASK, init_fit_state,
                                              make_fit_block)
    from npp_tpu_torch.utils.synthetic import (synthetic_data,
                                               synthetic_remap_data,
                                               synthetic_segment_data)

    dev = torch.device('cuda')
    if args.task == 'remapping':
        cfg, task = RemappingConfig(), REMAPPING_TASK
        with matmul_precision('float32'):
            data = remapping_data(synthetic_remap_data(0), cfg, dev)
    elif args.task == 'segmentation':
        cfg, task = SegmentationConfig(), SEGMENTATION_TASK
        with matmul_precision('float32'):
            data = segmentation_data(synthetic_segment_data(0), cfg, dev)
    else:
        cfg, task = CompletionConfig(), COMPLETION_TASK
        data = synthetic_data(0)
    cfg = replace(cfg, warp_field=args.warp_field)
    if args.matmul_precision:
        cfg = replace(cfg, matmul_precision=args.matmul_precision)
    comps = build_components(cfg, data, dev, task)
    state = init_fit_state(cfg, comps.model, comps.percep, dev, comps.style)
    consts = make_fit_consts(cfg, data, data.patch_size, dev, task)
    block = 10
    run_block = make_fit_block(cfg, comps.embedder, consts, comps.percep,
                               comps.contextual, cfg.patch_num,
                               data.patch_size, block, comps.style, task)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    # outside the steps (which set cfg's precision), full f32 as in a fit
    with matmul_precision('float32'):
        run_block(state, gen)
        torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(args.blocks):
                run_block(state, gen)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0)
    steps = args.blocks * block

    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.key, [0.0, 0])
            k[0] += us / 1e3
            k[1] += ev.count
    if not kernels:
        sys.exit('profile_torch_fit: the profiler saw no device time')
    groups = {}
    for name, (ms, _) in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms / steps
    device_ms = sum(ms for ms, _ in kernels.values())
    if abs(sum(groups.values()) - device_ms / steps) > 1e-6 * device_ms:
        sys.exit('profile_torch_fit: the groups do not sum to the total')
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    out = {
        'device': torch.cuda.get_device_name(0), 'steps': steps,
        'task': task.name, 'warp_field': cfg.warp_field,
        'patch_size': data.patch_size,
        'matmul_precision': cfg.matmul_precision,
        'wall_ms_per_step': wall_ms / steps,
        'device_ms_per_step': device_ms / steps,
        'busy_share': device_ms / wall_ms,
        'group_ms_per_step': dict(sorted(groups.items(),
                                         key=lambda kv: -kv[1])),
        'top_kernels': [{'name': n[:120], 'ms_per_step': ms / steps,
                         'calls_per_step': c / steps}
                        for n, (ms, c) in top],
    }
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
