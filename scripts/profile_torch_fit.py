"""Where a fit step's device and host time go, for the PyTorch port on one
CUDA card.

    python3 scripts/profile_torch_fit.py [--blocks 2] [--block 10]
                                         [--images 1]
                                         [--matmul_precision bfloat16]
                                         [--task completion|remapping|
                                                 segmentation]
                                         [--warp_field] [--out FILE]
                                         [--trace_dir DIR]

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
step), or with --images B the completion of B synthetic examples stacked
in one step as parallel/runner.py::fit_images stacks a bucket
(parallel/batch.py::make_batched_fit_block, the B tables under the
runner's size guard). Blocks of --block steps (the benchmark's cells run
50: `--block 50 --blocks 1`, with `--images 3` for completion-batch3).
Runs one block to warm up (kernel builds, cuDNN's algorithm choice), then
profiles `--blocks` more blocks under utils/debug.py::trace, which records
the port's spans. Prints a table per step of each span (npp.*): its self
ms on the host, the card's synchronising operations counted in it, and
the card's idle ms put down to the innermost span open at each idle
gap's start; then, as one JSON line, the wall ms per step, the device busy
share (kernel time over wall time), the device time per step by group
(the port's kernels, matrix products, convolutions, the rest), the top
kernels by device time and the span table. Needs a card; writes the JSON
to --out as well, and the Chrome trace with its spans.json to --trace_dir
if given.
"""
import argparse
import bisect
import json
import os
import shutil
import sys
import tempfile
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


DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def span_table(spans, steps):
    """Per span name, per step: calls, host self ms (its wall less its
    child spans') and syncs counted in it, from utils/debug.py's record."""
    child = [0.0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child[s.parent] += s.end - s.start
    table = {}
    for i, s in enumerate(spans):
        row = table.setdefault(s.name, {'calls': 0.0, 'self_ms': 0.0,
                                        'syncs': 0.0, 'idle_ms': 0.0})
        row['calls'] += 1 / steps
        row['self_ms'] += 1e3 * (s.end - s.start - child[i]) / steps
        row['syncs'] += s.syncs / steps
    return table


def idle_by_span(events):
    """{span name: the card's idle ms inside the npp.block annotations of
    a Chrome trace, each gap between device operations put down to the
    innermost npp.* annotation open at its start}. The annotations are one
    thread's, so they nest."""
    ann = sorted((float(e['ts']), -float(e['dur']), e['name'])
                 for e in events if e.get('cat') == 'user_annotation'
                 and str(e.get('name', '')).startswith('npp.'))
    ann = [(a, a - d, n) for a, d, n in ann]            # (start, end, name)
    busy = []
    for a, b in sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                       for e in events if e.get('cat') in DEVICE_CATS):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = []
    for a, b, n in ann:
        if n != 'npp.block':
            continue
        i = max(bisect.bisect_left([x[1] for x in busy], a) - 1, 0)
        t = a
        for lo, hi in busy[i:]:
            if lo >= b:
                break
            if lo > t:
                gaps.append((t, lo))
            t = max(t, hi)
        if t < b:
            gaps.append((t, b))
    out, stack, k = {}, [], 0
    for g0, g1 in sorted(gaps):
        while k < len(ann) and ann[k][0] <= g0:
            while stack and stack[-1][1] <= ann[k][0]:
                stack.pop()
            stack.append(ann[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        name = stack[-1][2] if stack else 'outside npp spans'
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e3
    return out


def print_table(table):
    print(f'{"span":<18}{"calls":>8}{"self ms":>10}{"syncs":>8}'
          f'{"idle ms":>10}   (per step)')
    for name, r in sorted(table.items(), key=lambda kv: -kv[1]['self_ms']):
        print(f'{name:<18}{r["calls"]:>8.2f}{r["self_ms"]:>10.3f}'
              f'{r["syncs"]:>8.2f}{r["idle_ms"]:>10.3f}')
    tot = {k: sum(r[k] for r in table.values())
           for k in ('self_ms', 'syncs', 'idle_ms')}
    print(f'{"total":<18}{"":>8}{tot["self_ms"]:>10.3f}{tot["syncs"]:>8.2f}'
          f'{tot["idle_ms"]:>10.3f}', flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--blocks', type=int, default=2)
    ap.add_argument('--block', type=int, default=10,
                    help='steps a block (the benchmark runs 50)')
    ap.add_argument('--images', type=int, default=1,
                    help='completion images stacked in one step')
    ap.add_argument('--matmul_precision', default=None,
                    help="the fit's matmul_precision (default: "
                         "CompletionConfig's)")
    ap.add_argument('--task', default='completion',
                    choices=('completion', 'remapping', 'segmentation'))
    ap.add_argument('--warp_field', action='store_true')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'profile_torch_fit.json'))
    ap.add_argument('--trace_dir', default=None,
                    help='keep the Chrome trace and spans.json here')
    args = ap.parse_args(argv)
    if args.images > 1 and (args.task != 'completion' or args.warp_field):
        ap.error('--images stacks completion images without the warp field')

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('profile_torch_fit: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.config import (CompletionConfig, RemappingConfig,
                                      SegmentationConfig, replace)
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models.loaders import remapping_data, segmentation_data
    from npp_tpu_torch.models.pipeline import build_components, make_fit_consts
    from npp_tpu_torch.models.remapping import REMAPPING_TASK
    from npp_tpu_torch.models.segmentation import SEGMENTATION_TASK
    from npp_tpu_torch.models.trainer import (COMPLETION_TASK, init_fit_state,
                                              make_fit_block, table_guard)
    from npp_tpu_torch.nn.embedder import make_task_embedder
    from npp_tpu_torch.parallel.batch import (init_batched_state,
                                              make_batched_fit_block,
                                              stack_consts, stack_embedders)
    from npp_tpu_torch.utils import debug
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
    block = args.block
    # outside the steps (which set cfg's precision), full f32 as in a fit
    with matmul_precision('float32'):
        comps = build_components(cfg, data, dev, task)
        state = init_fit_state(cfg, comps.model, comps.percep, dev,
                               comps.style)
        if args.images == 1:
            consts = make_fit_consts(cfg, data, data.patch_size, dev, task)
            run_block = make_fit_block(cfg, comps.embedder, consts,
                                       comps.percep, comps.contextual,
                                       cfg.patch_num, data.patch_size, block,
                                       comps.style, task)
            feed = torch.Generator().manual_seed(cfg.seed + 1)
        else:
            datas = [data] + [synthetic_data(j)
                              for j in range(1, args.images)]
            h, w = data.img.shape[:2]
            emb_b = stack_embedders([make_task_embedder(
                cfg, np.asarray(d.selected_angles),
                np.asarray(d.selected_periods), (h, w),
                torch.Generator().manual_seed(cfg.seed), dev)
                for d in datas])
            state = init_batched_state(cfg, state, args.images)
            run_block = make_batched_fit_block(
                cfg, emb_b, stack_consts([make_fit_consts(
                    cfg, d, data.patch_size, dev, task) for d in datas]),
                comps.percep, comps.contextual, cfg.patch_num,
                data.patch_size, block, comps.style, task, grid_hw=(h, w),
                table=table_guard(cfg, args.images * h * w * emb_b.out_dim))
            feed = [torch.Generator().manual_seed(cfg.seed + 1)
                    for _ in datas]
        run_block(state, feed)
        torch.cuda.synchronize()

        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix='npp_prof-')
        with debug.trace(trace_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(args.blocks):
                run_block(state, feed)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = args.blocks * block
    table = span_table(debug.RECORD.spans, steps)
    with open(os.path.join(trace_dir, 'trace.json')) as f:
        idle = idle_by_span(json.load(f)['traceEvents'])
    if not args.trace_dir:
        shutil.rmtree(trace_dir, ignore_errors=True)
    for name, ms in idle.items():
        table.setdefault(name, {'calls': 0.0, 'self_ms': 0.0, 'syncs': 0.0,
                                'idle_ms': 0.0})['idle_ms'] = ms / steps
    print_table(table)

    kernels = debug.kernel_times(prof)
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
        'images': args.images, 'block': block,
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
        'spans_per_step': table,
    }
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
