"""User-facing batched multi-image fitting on one card, a port of
`npp_tpu/parallel/runner.py::fit_images` without the mesh.

Images are grouped into buckets by (padded canvas, patch size, effective
K, per-image overrides), padded into the bucket's canvas (valid_mask = 0
outside), and each bucket advances as one stacked fit (parallel/batch.py):
B images per step, as many kernel launches in the MLP and the losses as
one image takes. The loop is fit_image's, split for split
(models/pipeline.py::block_plan): the same blocks of gcd(i_testset,
i_print) steps (single steps below 8), the same patch-size decays at
block starts, the same learning-rate schedule, each
image drawing from its own generator seeded as fit_image seeds its one,
so each image's fit equals its sequential fit_image up to the float
rounding of stacked products.

npp_tpu's compile-ahead thread and AOT cache serve its XLA programs and
have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import matmul_precision, resolve_device
from ..models.loaders import TaskData
from ..models.pipeline import (_sync, block_plan, build_components,
                               make_fit_consts)
from ..models.trainer import (FitState, TaskSpec, init_fit_state,
                              make_render, table_guard)
from ..nn.embedder import make_task_embedder
from .batch import (init_batched_state, make_batched_fit_block,
                    stack_consts, stack_embedders, unstack_fit_state)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_to_canvas(data: TaskData, h: int, w: int) -> TaskData:
    """Zero-pad an example into an (h, w) canvas; padded area is invalid
    (runner.py:31-50)."""
    oh, ow = data.img.shape[:2]
    if (oh, ow) == (h, w):
        return data

    def pad_img(x):
        return np.pad(x, ((0, h - oh), (0, w - ow), (0, 0)))

    extra = {k: (pad_img(v) if isinstance(v, np.ndarray) and v.ndim == 3
                 and v.shape[:2] == (oh, ow) else v)
             for k, v in data.extra.items()}
    # keep the loader's original dims if present; otherwise the pre-pad
    # dims are the original (outputs crop back with data.orig_shape)
    extra.setdefault('orig_shape', (oh, ow))
    return dataclasses.replace(
        data, img=pad_img(data.img), masked_img=pad_img(data.masked_img),
        mask=pad_img(data.mask), valid_mask=pad_img(data.valid_mask),
        extra=extra)


def fit_images(cfg, task: TaskSpec, datas: Sequence[TaskData],
               n_iters: Optional[int] = None, canvas_multiple: int = 64,
               per_image: Optional[Sequence[dict]] = None,
               return_ctx: bool = False, milestone_hook=None, device=None,
               stats: Optional[dict] = None):
    """Fit all images, bucket by bucket. Returns the per-image FitStates in
    input order (and, with return_ctx, per-image dicts: 'model' (the
    single-image template), 'embedder' (its tight-canvas TaskEmbedder),
    'canvas', 'cfg', 'render', 'components'). Runs on the card unless
    device='cpu' is passed.

    - aux rank-gating: each TaskData arrives with its own gated proposal
      list; the effective K is part of the bucket key, so a gated image
      fits with the architecture its sequential fit gives it;
    - per_image[i]: overrides (e.g. {'warp_field': True}), part of the
      bucket key;
    - milestone_hook(i, idxs, state): at every i with i % i_testset == 0,
      with the bucket's original image indices and the stacked state (row
      j of a stacked parameter belongs to datas[idxs[j]]);
    - stats: a dict to fill with per-bucket 'buckets' records (images,
      canvas, table dtype, wall, ms per step of the steady blocks)."""
    device = resolve_device(device)
    n_iters = n_iters if n_iters is not None else cfg.N_iters - 1
    overrides = [dict(o) for o in per_image] if per_image is not None \
        else [{} for _ in datas]
    buckets: Dict[Tuple, List[int]] = {}
    for i, d in enumerate(datas):
        h = _round_up(d.img.shape[0], canvas_multiple)
        w = _round_up(d.img.shape[1], canvas_multiple)
        k_eff = min(cfg.p_topk, len(d.selected_angles))
        key = (h, w, d.patch_size, k_eff, tuple(sorted(overrides[i].items())))
        buckets.setdefault(key, []).append(i)

    results: List[Optional[FitState]] = [None] * len(datas)
    ctxs: List[Optional[dict]] = [None] * len(datas)
    with matmul_precision('float32'):     # the blocks set their own
        for (h, w, patch_size, _, okey), idxs in buckets.items():
            bcfg = dataclasses.replace(cfg, **dict(okey)) if okey else cfg
            out = _fit_bucket(bcfg, task, datas, idxs, h, w, patch_size,
                              n_iters, milestone_hook, device, stats)
            for j, i in enumerate(idxs):
                results[i], ctxs[i] = out[0][j], out[1][j]
    return (results, ctxs) if return_ctx else results


def _fit_bucket(bcfg, task: TaskSpec, datas, idxs, h: int, w: int,
                patch_size: int, n_iters: int, milestone_hook,
                device: torch.device, stats):
    group = [pad_to_canvas(datas[i], h, w) for i in idxs]
    # coordinate normalisation: each image's TIGHT loader canvas (a bucket
    # canvas would make a small image's embedding depend on the bucket)
    dims = [datas[i].img.shape[:2] for i in idxs]
    comps = build_components(bcfg, datas[idxs[0]], device, task)
    embedders = [make_task_embedder(
        bcfg, np.asarray(d.selected_angles), np.asarray(d.selected_periods),
        dims[j], torch.Generator().manual_seed(bcfg.seed), device)
        for j, d in enumerate(group)]
    emb_b = stack_embedders(embedders)
    state0 = init_fit_state(bcfg, comps.model, comps.percep, device,
                            comps.style)
    template = state0.params
    state = init_batched_state(bcfg, state0, len(group))
    gens = [torch.Generator().manual_seed(bcfg.seed + 1) for _ in group]
    # the B tables over the bucket canvas together under the size guard
    table = table_guard(bcfg, len(group) * h * w * emb_b.out_dim)
    if bcfg.embed_table and str(table) != f'torch.{bcfg.embed_table}':
        print(f'[runner] embed_table {bcfg.embed_table} of {len(group)} '
              f'images over {h}x{w}: '
              f'{"bfloat16" if table is not None else "none"} under '
              f'embed_table_max_mb={bcfg.embed_table_max_mb}', flush=True)

    consts_cache: Dict[int, object] = {}
    stages: Dict[Tuple, object] = {}

    def stage(ps, pn, n):
        if ps not in consts_cache:
            consts_cache[ps] = stack_consts(
                [make_fit_consts(bcfg, d, ps, device, task) for d in group])
        key = (ps, pn, n)
        if key not in stages:
            stages[key] = make_batched_fit_block(
                bcfg, emb_b, consts_cache[ps], comps.percep, comps.contextual,
                pn, ps, n, comps.style, task, grid_hw=(h, w), table=table)
        return stages[key]

    walls = []
    _sync(device)
    t0 = time.time()
    # n_iters + 1 is fit_image's cfg.N_iters
    for i, ps, pn, n in block_plan(bcfg, patch_size, 1, n_iters + 1,
                                   bcfg.i_print):
        tb = time.time()
        stage(ps, pn, n)(state, gens)
        _sync(device)
        walls.append((n, time.time() - tb))
        end = i + n - 1
        if milestone_hook is not None and end % bcfg.i_testset == 0:
            milestone_hook(end, idxs, state)
    wall = time.time() - t0
    if stats is not None:
        steady = walls[1:] or walls
        stats.setdefault('buckets', []).append({
            'images': list(idxs), 'canvas': (h, w), 'n_iters': n_iters,
            'table': None if table is None else str(table).split('.')[-1],
            'wall_s': wall,
            'ms_per_step_steady': 1e3 * sum(t for _, t in steady) /
            max(sum(k for k, _ in steady), 1)})
    states, ctxs = [], []
    for j in range(len(group)):
        states.append(unstack_fit_state(state, template, j))
        ctxs.append({'model': comps.model, 'embedder': embedders[j],
                     'canvas': (h, w), 'cfg': bcfg, 'components': comps,
                     'render': make_render(bcfg, embedders[j])})
    return states, ctxs
