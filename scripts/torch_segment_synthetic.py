"""Whole segmentation runs of the PyTorch port on one CUDA card.

    python3 scripts/torch_segment_synthetic.py [--seeds 0 1 2]
        [--fit_seeds 0] [--search] [--no_profile] [--iters 601] [--out FILE]

Runs `run_segmentation` at the default SegmentationConfig (601
iterations, the refinement at 600) on the 256x320 synthetic segmentation
examples of npp_tpu_torch/utils/synthetic.py::synthetic_segment_data (a
copy of scripts/eval_segmentation_iou.py::synth_example, made from a
seed), once for each data seed and fit seed (cfg.seed: the MLP's init,
the Fourier bands and the sampler's draws). The lattices are those of the
example's construction, or with --search those the port's `run_search`
finds at the default SearchConfig on the example quantised to 8 bits, as
scripts/eval_segmentation_iou.py runs the JAX package (search, then
segmentation).

Prints one JSON line per run and a summary line per fit seed. Each line
holds, from an unprofiled run: the wall seconds of the whole call (coarse
mask, fit, refinement; the first run of the process also builds the graph
cut and the towers), the fit's wall and ms per step of each logged block,
the IoU against the example's ground truth of the coarse init and of the
refined mask under the reference's grayscale criterion and under
seg_color_criterion (the same final render), and the peak device memory.
Unless --no_profile, the same call is run again under torch.profiler
recording the card's kernels only, for the device time: 'busy_share' is
that device time over that profiled run's own wall ('profiled_wall_s'),
so the profiler's cost is in its denominator. With the card's name and
power limit. Needs a card; writes the lines to --out as well.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iou(a, b):
    import numpy as np
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    u = (a | b).sum()
    return float((a & b).sum() / u) if u else 1.0


def searched_lattices(arrays):
    """The example's lattices as the port's search finds them at the
    default SearchConfig, on the image quantised to 8 bits as a PNG would
    hold it, with no unknown pixels."""
    import numpy as np
    from npp_tpu_torch.config import SearchConfig
    from npp_tpu_torch.proposal.search import run_search
    img = np.uint8(arrays['gt_img'] * 255) / 255.0
    ones = np.ones(img.shape[:2] + (1,))
    odgt = run_search(SearchConfig(), device='cuda', save=False, data={
        'masked_img': img, 'gt_img': img, 'unknown_mask': ones,
        'valid_mask': ones})
    return {k: v for k, v in odgt.items() if k.startswith('selected_')
            or k.startswith('distances')}


def segment(cfg, arrays):
    """One whole `run_segmentation` call and its wall seconds."""
    import torch
    from npp_tpu_torch.models.segmentation import run_segmentation
    torch.cuda.synchronize()
    t0 = time.time()
    out = run_segmentation(cfg, save=False, device='cuda', data=arrays)
    torch.cuda.synchronize()
    return out, time.time() - t0


def device_ms_of(cfg, arrays):
    """The card's kernel time over one whole call under torch.profiler,
    and that call's wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    from npp_tpu_torch.utils.debug import kernel_times
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = segment(cfg, arrays)
    device_ms = sum(ms for ms, _ in kernel_times(prof).values())
    if device_ms <= 0:
        sys.exit('torch_segment_synthetic: the profiler saw no device time')
    return device_ms, wall


def run_seed(seed, fit_seed, iters, search, profiled):
    import torch
    from npp_tpu_torch.config import SegmentationConfig, replace
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.models.segmentation import refine_segmentation
    from npp_tpu_torch.utils.synthetic import synthetic_segment_data

    cfg = replace(SegmentationConfig(), N_iters=iters, seed=fit_seed)
    arrays = synthetic_segment_data(seed)
    gt = arrays['gt_mask']
    rec = {'seed': seed, 'fit_seed': fit_seed, 'iters': iters - 1,
           'lattices': 'search' if search else 'construction'}
    if search:
        t0 = time.time()
        arrays.update(searched_lattices(arrays))
        rec['search_s'] = time.time() - t0
    rec['periods'] = arrays['selected_periods'][:cfg.p_topk]
    torch.cuda.reset_peak_memory_stats()
    (result, results, data), wall = segment(cfg, arrays)
    last = max(results)
    oh, ow = data.orig_shape
    init = data.extra['non_period_mask'][:oh, :ow, 0] > 0
    h, w = data.img.shape[:2]
    with matmul_precision('float32'):
        pred = result.render(result.state.params, h, w).float().cpu().numpy()
        color = refine_segmentation(
            replace(cfg, seg_color_criterion=True), data, pred,
            LPIPS(torch.device('cuda'), net='alex'))
    rec.update({
        'patch_size': data.patch_size, 'wall_s': wall,
        'fit_wall_s': result.wall_time_s,
        'ms_per_step': {h_['iter']: h_['ms_per_step']
                        for h_ in result.history},
        'iou_init': iou(init, gt),
        'iou_refined_gray': iou(results[last]['non_period_mask'][..., 0] > 0,
                                gt),
        'iou_refined_color': iou(color['non_period_mask'][..., 0] > 0, gt),
        'gt_fraction': float(gt.mean()), 'init_fraction': float(init.mean()),
        'peak_bytes': torch.cuda.max_memory_allocated(),
    })
    if profiled:
        device_ms, pwall = device_ms_of(cfg, arrays)
        rec.update(device_ms=device_ms, profiled_wall_s=pwall,
                   busy_share=device_ms / (1e3 * pwall))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--fit_seeds', type=int, nargs='+', default=[0])
    ap.add_argument('--search', action='store_true',
                    help="the port's search finds the lattices")
    ap.add_argument('--no_profile', action='store_true',
                    help='skip the profiled second run of each call')
    ap.add_argument('--iters', type=int, default=601)
    ap.add_argument('--out', default=os.path.join(
        ROOT, 'chiprun_out', 'torch_segment_synthetic.jsonl'))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_segment_synthetic: needs a CUDA card')
    sys.path.insert(0, ROOT)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    lines = []
    for fit_seed in args.fit_seeds:
        recs = []
        for seed in args.seeds:
            recs.append(dict(run_seed(seed, fit_seed, args.iters,
                                      args.search, not args.no_profile),
                             card=smi))
            lines.append(json.dumps(recs[-1]))
            print(lines[-1], flush=True)
        summary = {'card': smi, 'device': torch.cuda.get_device_name(0),
                   'seeds': args.seeds, 'fit_seed': fit_seed,
                   'search': args.search}
        for k in ('wall_s', 'busy_share', 'iou_init', 'iou_refined_gray',
                  'iou_refined_color'):
            if k in recs[0]:
                summary[f'mean_{k}'] = float(np.mean([r[k] for r in recs]))
        lines.append(json.dumps(summary))
        print(lines[-1], flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
