"""Where the periodicity search's time goes, for the PyTorch port on one
CUDA card.

    python3 scripts/profile_torch_search.py [--steps 20] [--out FILE]

Runs `run_search` at the default SearchConfig on the 384x512 synthetic
example of npp_tpu_torch/utils/synthetic.py (its lattices not given) twice,
the first to warm up (Triton builds, cuDNN's algorithm choice), and keeps
the second's phase walls: detect, the lockstep fit (ms/step), the eval
(render, LPIPS, CX) and the artefacts. Then, on the same candidates:
`--steps` fit steps under torch.profiler (the fit's device busy share and
device ms per step by group), one eval under torch.profiler (device ms by
group), and one candidate's CX alone (device ms and the peak memory it
adds, at the eval crop's relu3_4 positions). For K3's case beside it, the
completion step's CX (six 160x160 pairs, forward and backward, under the
fit's default matmul_precision). Prints one JSON line and writes it to
--out. Needs a card.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))

from profile_torch_fit import group_of  # noqa: E402


def device_ms_by_group(prof):
    """Device ms by group of profile_torch_fit.GROUPS, and the total."""
    from npp_tpu_torch.utils.debug import kernel_times
    groups, total = {}, 0.0
    for name, (ms, _) in kernel_times(prof).items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + ms
        total += ms
    if not total:
        sys.exit('profile_torch_search: the profiler saw no device time')
    return dict(sorted(groups.items(), key=lambda kv: -kv[1])), total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'profile_torch_search.json'))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('profile_torch_search: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from npp_tpu_torch.config import SearchConfig
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.losses.contextual import ContextualLoss
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.nn.embedder import gaussian_freq_bands
    from npp_tpu_torch.proposal import ranking
    from npp_tpu_torch.proposal.search import _prepare_search, run_search
    from npp_tpu_torch.utils.synthetic import synthetic_search_data

    dev = torch.device('cuda')
    cfg = SearchConfig()
    data = synthetic_search_data(0)
    percep, contextual = LPIPS(dev), ContextualLoss(dev)
    runs = []
    for _ in range(2):
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        run_search(cfg, percep, contextual, device=dev, data=data,
                   save=False, stats=stats)
        torch.cuda.synchronize()
        stats.pop('fit_losses')
        stats['peak_bytes'] = torch.cuda.max_memory_allocated()
        runs.append(stats)

    prep = _prepare_search(cfg, data, dev)
    n_cand = len(prep['all_angles'])
    lat = ranking.Lattices(
        cfg, prep['all_angles'], prep['all_periods'],
        gaussian_freq_bands(torch.Generator().manual_seed(cfg.seed),
                            cfg.multires), (prep['dh'], prep['dw']), dev)
    img = torch.as_tensor(prep['masked_img'], dtype=torch.float32,
                          device=dev)
    pool = torch.as_tensor(prep['i_train'], dtype=torch.long, device=dev)
    params = ranking.init_rank_params(cfg, n_cand, dev)
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    with matmul_precision('float32'):
        ranking.fit_candidates(params, lat, img, pool, gen, 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            ranking.fit_candidates(params, lat, img, pool, gen, args.steps)
            torch.cuda.synchronize()
            fit_wall = 1e3 * (time.time() - t0)
        fit_groups, fit_dev = device_ms_by_group(prof)

        crop = ranking._eval_inputs(cfg, prep['i_val'],
                                    (prep['dh'], prep['dw']))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            ranking.eval_candidates(cfg, params, lat, img, prep['i_val'],
                                    crop, percep, contextual)
            torch.cuda.synchronize()
            eval_wall = 1e3 * (time.time() - t0)
        eval_groups, eval_dev = device_ms_by_group(prof)

        # one candidate's CX alone, on the eval's bbox crop
        y0, x0, ch, cw = crop
        x = img[None, y0:y0 + ch, x0:x0 + cw]
        y = torch.flip(x, dims=(2,)).contiguous()
        with torch.no_grad():
            contextual(x, y, per_sample=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                contextual(x, y, per_sample=True)
            end.record()
            torch.cuda.synchronize()
            cx_ms = start.elapsed_time(end) / 3
            cx_peak = torch.cuda.max_memory_allocated() - base

    # the completion step's CX: six 160x160 pairs, forward and backward,
    # under the fit's default precision (TF32 on the card)
    gen = torch.Generator().manual_seed(0)
    fake = torch.rand(6, 160, 160, 3, generator=gen).to(dev)
    real = torch.rand(6, 160, 160, 3, generator=gen).to(dev)
    valid = torch.ones(6, device=dev)

    def cx_step():
        x = fake.clone().requires_grad_()
        contextual(x, real, valid=valid).backward()
    with matmul_precision(cfg.matmul_precision):
        for _ in range(2):
            cx_step()
        start.record()
        for _ in range(5):
            cx_step()
        end.record()
        torch.cuda.synchronize()
        cx_completion_ms = start.elapsed_time(end) / 5

    out = {
        'device': torch.cuda.get_device_name(0), 'n_cand': n_cand,
        'runs': runs,
        'fit': {'steps': args.steps, 'wall_ms_per_step': fit_wall / args.steps,
                'device_ms_per_step': fit_dev / args.steps,
                'busy_share': fit_dev / fit_wall,
                'group_ms_per_step': {k: v / args.steps
                                      for k, v in fit_groups.items()}},
        'eval': {'wall_ms': eval_wall, 'device_ms': eval_dev,
                 'busy_share': eval_dev / eval_wall,
                 'group_ms': eval_groups, 'crop': [ch, cw]},
        'cx_one_candidate': {'positions': (ch // 4) * (cw // 4),
                             'ms': cx_ms, 'peak_added_bytes': cx_peak},
        'cx_completion_step': {'pairs': 6, 'positions': 1600,
                               'fwd_bwd_ms': cx_completion_ms},
    }
    line = json.dumps(out, default=lambda o: np.asarray(o).tolist())
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
