#!/usr/bin/env python
"""Run a suite of examples through the PyTorch port in one process: the
counterpart of scripts/run_suite.py for npp_tpu_torch.

Usage:
  python scripts/torch_run_suite.py --input-root DIR [--tasks completion,...]
      [--out OUT] [--device cpu|cuda] [--batched] [--batched-search]
      [--iters-scale S] [--only SUBSTR,...] [--aux-gate-ratio R]
      [--comp-heldout N] [--comp-snapshot last|best]
      [--comp-seam none|residual] [--seg-color-criterion on|off]
      [--seg-hysteresis H] [--seg-texture-criterion on|off]
      [--preset quality] [--rank-iters N] [--rank-proxy P]
      [--skip-search] [--search-only] [--set KEY=VALUE ...]

DIR/<task>/input/<name>/ holds each example's four PNGs (masked_img,
gt_img, unknown_mask, valid_mask). Every example is searched (one search
per image, or with --batched-search one lockstep ranking fit for all of
them, proposal/search.py::run_search_suite), then fitted (one fit_image
per image, or with --batched all of a task's images stacked in one fit,
parallel/runner.py::fit_images), then each image runs the port's post-fit
code: the completion's composites (the seam-aware one too) and their
LPIPS, the remapping's evaluation, the segmentation's refinement. Writes
OUT/<task>/detected, OUT/<task>/results and OUT/summary.json. Runs on the
card unless --device cpu is given.

--preset quality is scripts/run_suite.py's measured best configuration:
three times the completion's iterations (at the reference's eval cadence,
with the adaptive scale floored at 0.01), the seam-aware composite, two
held-out blocks with the 'best' snapshot, and the segmentation's colour
and texture criteria with hysteresis 0.5. Flags given explicitly win over
the preset (--iters-scale too: then the iterations are not tripled).

--skip-search reuses an example's config.odgt where OUT already holds one
and searches only the others; --search-only stops after --batched-search
(the records and their pictures written, nothing fitted). run_suite.py's
--no-global-canvas and --aot-cache steer only XLA (the search canvas's
pure pad and the serialized executables) and have no counterpart here.
"""
import argparse
import copy
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--tasks', default='completion,segmentation,remapping')
    ap.add_argument('--input-root', required=True)
    ap.add_argument('--out', default='suite_out')
    ap.add_argument('--device', default=None,
                    help="'cpu' or 'cuda' (default: the card)")
    ap.add_argument('--iters-scale', type=float, default=None,
                    help='scale every task N_iters and i_testset '
                         '(default 1)')
    ap.add_argument('--only', default=None,
                    help='comma-separated example-name substrings')
    ap.add_argument('--aux-gate-ratio', type=float, default=None,
                    help='default 1.25 for completion, 0 for the others')
    ap.add_argument('--batched', action='store_true',
                    help="fit each task's images together "
                         '(parallel/runner.py::fit_images)')
    ap.add_argument('--batched-search', action='store_true',
                    help='one lockstep ranking fit for every search '
                         '(proposal/search.py::run_search_suite)')
    # None: not given, so the preset or the plain default fills it
    ap.add_argument('--comp-heldout', type=int, default=None)
    ap.add_argument('--comp-snapshot', default=None, choices=['last', 'best'])
    ap.add_argument('--comp-seam', default=None, choices=['none', 'residual'])
    ap.add_argument('--seg-color-criterion', default=None,
                    choices=['on', 'off'])
    ap.add_argument('--seg-hysteresis', type=float, default=None)
    ap.add_argument('--seg-texture-criterion', default=None,
                    choices=['on', 'off'])
    ap.add_argument('--preset', default=None, choices=['quality'],
                    help="'quality': scripts/run_suite.py's measured best "
                         'configuration (see the module docstring)')
    ap.add_argument('--rank-iters', type=int, default=None,
                    help="override the search's SearchConfig.N_iters")
    ap.add_argument('--rank-proxy', default=None,
                    choices=['reference', 'window', 'mse', 'heldout_mse'],
                    help="the ranking's proxy objective "
                         '(default: SearchConfig.rank_proxy)')
    ap.add_argument('--skip-search', action='store_true',
                    help="reuse an example's existing config.odgt")
    ap.add_argument('--search-only', action='store_true',
                    help='stop after --batched-search: the records, no fit')
    ap.add_argument('--set', action='append', default=[],
                    metavar='KEY=VALUE',
                    help='override a task-config field, applied last '
                         '(cli.py value coercion; repeatable)')
    args = ap.parse_args(argv)
    if args.search_only and not args.batched_search:
        ap.error('--search-only requires --batched-search')
    quality = args.preset == 'quality'
    for key, plain, preset in (
            ('comp_seam', 'none', 'residual'), ('comp_heldout', 0, 2),
            ('comp_snapshot', 'last', 'best'),
            ('seg_color_criterion', 'off', 'on'),
            ('seg_hysteresis', 1.0, 0.5),
            ('seg_texture_criterion', 'off', 'on')):
        if getattr(args, key) is None:
            setattr(args, key, preset if quality else plain)
    # the preset triples the completion's iterations unless a scale is given
    args.quality_iters = quality and args.iters_scale is None
    if args.iters_scale is None:
        args.iters_scale = 1.0
    return args


def apply_sets(cfg, sets):
    from npp_tpu_torch.cli import _parse_value
    from npp_tpu_torch.config import replace
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    for kv in sets:
        k, v = kv.split('=', 1)
        if k in fields:
            cfg = replace(cfg, **{k: _parse_value(fields[k], v)})
        else:
            print(f'[suite] --set {k}: no such field on '
                  f'{type(cfg).__name__}, skipped')
    return cfg


def list_examples(args, task):
    in_dir = os.path.join(args.input_root, task, 'input')
    if not os.path.isdir(in_dir):
        return in_dir, []
    names = sorted(n for n in os.listdir(in_dir)
                   if os.path.exists(os.path.join(in_dir, n, 'gt_img.png')))
    if args.only:
        subs = [s for s in args.only.split(',') if s]
        names = [n for n in names if any(s in n for s in subs)]
    return in_dir, names


def task_config(args, task, det_dir, res_root):
    from npp_tpu_torch.config import (CompletionConfig, RemappingConfig,
                                      SegmentationConfig, replace)
    cls = {'completion': CompletionConfig, 'segmentation': SegmentationConfig,
           'remapping': RemappingConfig}[task]
    gate = args.aux_gate_ratio if args.aux_gate_ratio is not None \
        else (1.25 if task == 'completion' else 0.0)
    cfg = replace(cls(), datadir=det_dir, basedir=res_root,
                  aux_gate_ratio=gate)
    if task == 'completion':
        cfg = replace(cfg, comp_seam=args.comp_seam,
                      comp_heldout=args.comp_heldout,
                      comp_snapshot=args.comp_snapshot)
    if task == 'segmentation':
        cfg = replace(cfg,
                      seg_color_criterion=args.seg_color_criterion == 'on',
                      seg_texture_criterion=args.seg_texture_criterion == 'on',
                      seg_refine_hysteresis=args.seg_hysteresis)
    if args.quality_iters and task == 'completion':
        # 3x the iterations at the reference's eval cadence, so the 'best'
        # snapshot can still pick the reference budget's milestone; the
        # floor keeps the adaptive pixel scale from collapsing in the
        # extended fit (scripts/run_suite.py:312-335)
        cfg = replace(cfg, adaptive_scale_lo=0.01,
                      N_iters=max(2, int(cfg.N_iters * 3.0)))
    elif args.iters_scale != 1.0:
        cfg = replace(cfg, N_iters=max(2, int(cfg.N_iters * args.iters_scale)),
                      i_testset=max(1, int(cfg.i_testset * args.iters_scale)))
    return apply_sets(cfg, args.set)


def search_config(args, in_dir, det_root, name):
    from npp_tpu_torch.config import SearchConfig, replace
    scfg = replace(SearchConfig(), datadir=os.path.join(in_dir, name),
                   outdir=det_root)
    if args.rank_proxy:
        scfg = replace(scfg, rank_proxy=args.rank_proxy)
    if args.rank_iters:
        scfg = replace(scfg, N_iters=args.rank_iters)
    return scfg


def searched_before(args, det_dir):
    """--skip-search and the example's record already exists."""
    return args.skip_search and os.path.exists(
        os.path.join(det_dir, 'config.odgt'))


def load_task_data(task, cfg, device):
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.models import loaders
    with matmul_precision('float32'):
        if task == 'completion':
            return loaders.load_completion(cfg)
        if task == 'segmentation':
            return loaders.load_segmentation(cfg, device)
        return loaders.load_remapping(cfg, device)


def post_fit(task, cfg, name, st, ctx, data_eval, snaps, device, towers):
    """One image's post-fit stage on its unstacked state: the outputs and
    metrics its sequential run would give."""
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.parallel.runner import pad_to_canvas
    from npp_tpu_torch.utils.io import write_gray, write_rgb
    data_b = pad_to_canvas(data_eval, *ctx['canvas'])
    render = ctx['render']
    save_dir = os.path.join(cfg.basedir, f'{cfg.expname}_top{cfg.p_topk}',
                            name)
    oh, ow = data_b.orig_shape
    with matmul_precision('float32'):
        if task == 'completion':
            from npp_tpu_torch.models.completion import (
                OUTPUT_KEYS, compose_outputs, evaluate, final_lpips)
            seam = dict(comp_seam=cfg.comp_seam,
                        normalize_type=cfg.normalize_type, compute_seam=True)
            final = evaluate(data_b, st.params, render,
                             st.params.adaptive_pix, cfg.loss_type, device,
                             **seam)
            final['snapshot_iter'] = cfg.N_iters - 1
            best = (final.get('heldout_psnr', -np.inf), None, None)
            for it, params in snaps:
                res = evaluate(data_b, params, render, params.adaptive_pix,
                               cfg.loss_type, device, return_pred=True)
                if res.get('heldout_psnr', -np.inf) > best[0]:
                    best = (res['heldout_psnr'], it, (res['pred'], params))
            if best[1] is not None:
                final = compose_outputs(best[2][0], data_b,
                                        best[2][1].adaptive_pix,
                                        cfg.loss_type, device, **seam)
                final['snapshot_iter'] = best[1]
            final_lpips(final, data_b, ctx['components'].percep or
                        towers.setdefault('vgg', LPIPS(device, net='vgg')),
                        device)
            d = os.path.join(save_dir, 'testset_final')
            for key in OUTPUT_KEYS:
                write_rgb(os.path.join(d, f'{key}.png'), final[key])
        elif task == 'segmentation':
            from npp_tpu_torch.models.segmentation import (
                refine_segmentation, save_refinement)
            lpips_alex = towers.setdefault('alex', LPIPS(device, net='alex'))
            h, w = ctx['canvas']
            pred = render(st.params, h, w).to(torch.float32).cpu().numpy()
            res = refine_segmentation(cfg, data_b, pred, lpips_alex)
            write_gray(os.path.join(save_dir, 'segment_init.png'),
                       (data_b.extra['non_period_mask'] > 0
                        ).astype(np.float64)[:oh, :ow])
            save_refinement(save_dir, cfg.N_iters - 1, data_b, pred, res)
            final = {'non_periodic_fraction':
                     float(res['non_period_mask'].mean())}
        else:
            from npp_tpu_torch.models.remapping import evaluate
            final = evaluate(data_b, st.params, render,
                             st.params.adaptive_pix, cfg.loss_type, device)
    return final


def run_batched(task, pending, device, timer, towers, mesh):
    """fit_images over a task's images (grouped by N_iters), then each
    image's post-fit stage; over a mesh only for the images this rank
    fitted. pending: (name, rec, cfg, data_fit, data_eval,
    snapshot_best)."""
    from npp_tpu_torch.models.remapping import REMAPPING_TASK
    from npp_tpu_torch.models.segmentation import SEGMENTATION_TASK
    from npp_tpu_torch.models.trainer import COMPLETION_TASK
    from npp_tpu_torch.parallel.batch import unstack_params
    from npp_tpu_torch.parallel.runner import fit_images
    tspec = {'completion': COMPLETION_TASK, 'segmentation': SEGMENTATION_TASK,
             'remapping': REMAPPING_TASK}[task]
    datas = [p[3] for p in pending]
    # one canvas bucket for the task: every image rounded up to the
    # largest dimension (the pad is invalid)
    cm = max(-(-max(d.img.shape[:2]) // 64) * 64 for d in datas)
    order = {}
    for i, p in enumerate(pending):
        order.setdefault(p[2].N_iters, []).append(i)
    states, ctxs = [None] * len(pending), [None] * len(pending)
    raw_snaps = {}     # pending index -> [(iter, stacked params copy, row)]
    t0 = time.time()
    total_iters = 0
    fit_stats = {}
    with timer.phase(f'fit_batched/{task}'):
        for n_it, idxs in order.items():
            hook = None
            if any(pending[i][5] for i in idxs):
                def hook(it, bidx, state, _g=list(idxs)):
                    params = copy.deepcopy(state.params)
                    for j, b in enumerate(bidx):
                        if pending[_g[b]][5]:
                            raw_snaps.setdefault(_g[b], []).append(
                                (it, params, j))
            g_states, g_ctxs = fit_images(
                pending[idxs[0]][2], tspec, [datas[i] for i in idxs],
                n_iters=n_it - 1, canvas_multiple=cm, return_ctx=True,
                milestone_hook=hook, device=device, stats=fit_stats,
                mesh=mesh)
            for i, st, ctx in zip(idxs, g_states, g_ctxs):
                states[i], ctxs[i] = st, ctx
            total_iters += len(idxs) * (n_it - 1)
    wall = time.time() - t0
    agg = total_iters / max(wall, 1e-9)
    print(f'[suite] batched {task}: {len(pending)} images in {wall:.1f}s '
          f'({agg:.1f} image-iters/s)', flush=True)
    out = {}
    for i, ((name, rec, cfg, _, data_eval, _), st, ctx) in enumerate(
            zip(pending, states, ctxs)):
        if mesh is not None and ctx['rank'] != mesh.index('images'):
            continue
        template = st.params
        snaps = [(it, unstack_params(p, template, j))
                 for it, p, j in raw_snaps.get(i, [])]
        final = post_fit(task, cfg, name, st, ctx, data_eval, snaps, device,
                         towers)
        rec.update({k: round(float(v), 4) for k, v in final.items()
                    if np.isscalar(v)})
        rec['fit_s_batched_total'] = round(wall, 2)
        rec['aggregate_image_iters_per_sec'] = round(agg, 2)
        out[name] = rec
        print(f'[suite] {task}/{name} (batched): {rec}', flush=True)
    return out, fit_stats


def main(argv=None):
    args = parse_args(argv)
    from npp_tpu_torch.device import resolve_device
    from npp_tpu_torch.losses.contextual import ContextualLoss
    from npp_tpu_torch.losses.lpips import LPIPS
    from npp_tpu_torch.parallel.mesh import gather_objects, group_mesh
    from npp_tpu_torch.parallel.multihost import initialize, local_examples
    from npp_tpu_torch.proposal.search import run_search, run_search_suite
    from npp_tpu_torch.utils.debug import PhaseTimer

    initialize(backend='gloo' if args.device == 'cpu' else None)
    mesh = group_mesh(('images',))
    device = resolve_device(args.device)
    timer = PhaseTimer()
    summary = {'tasks': {}, 'env': {'device': str(device), 'world':
                                    1 if mesh is None else mesh.size},
               'options': {'preset': args.preset, 'batched': args.batched,
                           'batched_search': args.batched_search,
                           'iters_scale': args.iters_scale,
                           'comp_seam': args.comp_seam,
                           'comp_heldout': args.comp_heldout,
                           'comp_snapshot': args.comp_snapshot,
                           'seg_color_criterion': args.seg_color_criterion,
                           'seg_texture_criterion':
                               args.seg_texture_criterion,
                           'seg_hysteresis': args.seg_hysteresis,
                           'aux_gate_ratio': args.aux_gate_ratio,
                           'rank_proxy': args.rank_proxy,
                           'skip_search': args.skip_search,
                           'search_only': args.search_only,
                           'set': args.set}}
    if device.type == 'cuda':
        summary['env']['device_name'] = torch.cuda.get_device_name(device)
    percep, contextual = LPIPS(device, net='vgg'), ContextualLoss(device)
    towers = {'vgg': percep}
    tasks = [t for t in args.tasks.split(',') if t]

    searched = {}
    if args.batched_search:
        pre = []
        for task in tasks:
            in_dir, names = list_examples(args, task)
            det_root = os.path.join(args.out, task, 'detected')
            pre += [(os.path.join(det_root, n),
                     search_config(args, in_dir, det_root, n)) for n in names
                    if not searched_before(args, os.path.join(det_root, n))]
        if pre:
            t0 = time.time()
            stats = {}
            with timer.phase('search_batched'):
                odgts = run_search_suite([c for _, c in pre], percep,
                                         contextual, device=device,
                                         stats=stats, mesh=mesh)
            wall = time.time() - t0
            summary['search_batched'] = {
                'images': len(pre), 'wall_s': wall,
                'fit_ms_per_step': stats.get('fit_ms_per_step')}
            print(f'[suite] batched search: {len(pre)} images in '
                  f'{wall:.1f}s', flush=True)
            for (det_dir, _), odgt in zip(pre, odgts):
                searched[det_dir] = {'search_s_batched_total': round(wall, 2),
                                     'top_periods':
                                     odgt['selected_periods'][:3]}

    if args.search_only:
        print('[suite] --search-only: stopped after the search', flush=True)
    for task in [] if args.search_only else tasks:
        in_dir, names = list_examples(args, task)
        det_root = os.path.join(args.out, task, 'detected')
        res_root = os.path.join(args.out, task, 'results')
        summary['tasks'][task] = {}
        pending = []
        mine = set(local_examples(names))
        recs = {}
        for name in names:      # the searches, round-robin over any ranks
            det_dir = os.path.join(det_root, name)
            recs[name] = dict(searched.get(det_dir, {}))
            if det_dir in searched or name not in mine or \
                    searched_before(args, det_dir):
                continue
            t0 = time.time()
            with timer.phase(f'search/{task}'):
                odgt = run_search(search_config(args, in_dir, det_root, name),
                                  percep, contextual, device=device)
            recs[name]['search_s'] = round(time.time() - t0, 2)
            recs[name]['top_periods'] = odgt['selected_periods'][:3]
        if mesh is not None:
            mesh.barrier()      # every record written before a rank reads one
        for name in names:
            if not args.batched and name not in mine:
                continue
            rec = recs[name]
            det_dir = os.path.join(det_root, name)
            cfg = task_config(args, task, det_dir, res_root)
            if args.batched:
                data = load_task_data(task, cfg, device)
                if task == 'completion':
                    from npp_tpu_torch.models.completion import heldout_views
                    data_fit, data_eval, snap_best = heldout_views(data, cfg)
                else:
                    data_fit = data_eval = data
                    snap_best = False
                pending.append((name, rec, cfg, data_fit, data_eval,
                                snap_best))
                continue
            t0 = time.time()
            with timer.phase(f'fit/{task}'):
                if task == 'completion':
                    from npp_tpu_torch.models.completion import run_completion
                    result, final, _ = run_completion(cfg, device=device)
                elif task == 'segmentation':
                    from npp_tpu_torch.models.segmentation import (
                        run_segmentation)
                    result, results, _ = run_segmentation(cfg, device=device)
                    final = {'non_periodic_fraction': float(
                        results[max(results)]['non_period_mask'].mean())}
                else:
                    from npp_tpu_torch.models.remapping import run_remapping
                    result, final, _ = run_remapping(cfg, device=device)
            rec.update({k: round(float(v), 4) for k, v in final.items()
                        if np.isscalar(v)})
            rec['fit_s'] = round(time.time() - t0, 2)
            rec['iters_per_sec'] = round(result.iters_per_sec, 2)
            summary['tasks'][task][name] = rec
            print(f'[suite] {task}/{name}: {rec}', flush=True)
        if pending:
            fitted, fit_stats = run_batched(task, pending, device, timer,
                                            towers, mesh)
            summary['tasks'][task].update(fitted)
            summary.setdefault('fit_batched', {})[task] = fit_stats
            for name in mine:   # the searches of images fitted elsewhere
                summary['tasks'][task].setdefault(name, recs[name])

    summary['phases'] = {k: round(v, 2) for k, v in timer.phases.items()}
    if mesh is not None:
        # every rank's records and phases, gathered; rank 0 writes
        parts = gather_objects((summary['tasks'], summary['phases']), mesh)
        for task in summary['tasks']:
            merged = {}
            for tasks_r, _ in parts:
                for name, rec in tasks_r[task].items():
                    merged.setdefault(name, {}).update(rec)
            summary['tasks'][task] = {k: merged[k] for k in sorted(merged)}
        summary['rank_phases'] = [ph for _, ph in parts]
        if mesh.rank != 0:
            return summary
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'summary.json'), 'w') as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps(summary['phases']))
    print(f'[suite] wrote {args.out}/summary.json', flush=True)
    return summary


if __name__ == '__main__':
    import torch.distributed as dist
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
