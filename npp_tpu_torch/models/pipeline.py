"""The per-image fit driver, a port of `npp_tpu/models/pipeline.py` for the
completion, remapping and segmentation tasks: build components -> staged
fit (patch-size decay, pipeline.py:240-250) -> eval hooks at the i_testset
cadence."""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import allows_tf32, matmul_precision, resolve_device
from ..losses.contextual import ContextualLoss
from ..losses.lpips import LPIPS
from ..losses.style import StyleLoss
from ..nn.embedder import TaskEmbedder, make_task_embedder
from ..nn.mlp import NPPNet, NPPNetTop1
from ..utils.checkpoint import (latest_checkpoint, restore_fit_state,
                                save_fit_state)
from ..utils.debug import MetricLogger
from ..utils.pools import pad_pool_pow2
from .loaders import TaskData
from .sampler import build_sampler_consts
from .trainer import (COMPLETION_TASK, FitConsts, FitState, TaskSpec,
                      init_fit_state, make_fit_block, make_render)


def check_slice(cfg) -> None:
    """Options not ported yet raise instead of silently doing something
    else (ROADMAP.md lists them). Every SegmentationConfig option and
    feature_dtype are ported."""
    unported = {
        "comp_seam='residual'": cfg.comp_seam != 'none',
    }
    for name, on in unported.items():
        if on:
            raise NotImplementedError(
                f'{name} is not ported to npp_tpu_torch yet (see ROADMAP.md)')


def feature_dtype(cfg) -> torch.dtype:
    """torch.bfloat16 for feature_dtype='bfloat16', else float32, as
    npp_tpu reads the field."""
    return torch.bfloat16 if cfg.feature_dtype == 'bfloat16' \
        else torch.float32


@dataclasses.dataclass
class Components:
    embedder: TaskEmbedder
    model: torch.nn.Module
    percep: Optional[LPIPS]
    contextual: Optional[ContextualLoss]
    style: Optional[StyleLoss] = None


def build_components(cfg, data: TaskData, device: torch.device,
                     task: TaskSpec = COMPLETION_TASK) -> Components:
    """Embedder (bands from a generator seeded with cfg.seed), MLP (nn.Linear
    init under the same seed, without touching the global RNG) and the loss
    towers (the style loss for a task that uses it), all on `device`."""
    h, w = data.img.shape[:2]
    gen = torch.Generator().manual_seed(cfg.seed)
    embedder = make_task_embedder(cfg, np.asarray(data.selected_angles),
                                  np.asarray(data.selected_periods), (h, w),
                                  gen, device)
    k = min(cfg.p_topk, len(data.selected_angles))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        if k > 1:
            model = NPPNet(embedder.top1_dim,
                           embedder.out_dim - embedder.top1_dim,
                           depth=cfg.netdepth, width=cfg.netwidth,
                           activation=cfg.activation)
        else:
            model = NPPNetTop1(embedder.top1_dim, depth=cfg.netdepth,
                               width=cfg.netwidth, activation=cfg.activation)
    # cfg.feature_dtype: the LPIPS and style towers' activations
    # (npp_tpu/models/pipeline.py:53-73); the CX tower stays f32, since
    # bf16 features reshuffle its matches
    fdt = feature_dtype(cfg)
    percep = LPIPS(device, net='vgg', dtype=fdt) \
        if cfg.use_perceptual_loss else None
    contextual = ContextualLoss(device) if cfg.use_contextual_loss else None
    style = StyleLoss(device, getattr(cfg, 'use_adaptive_style_loss', False),
                      fdt) \
        if task.use_style and getattr(cfg, 'use_style_loss', False) else None
    return Components(embedder, model.to(device), percep, contextual, style)


def make_fit_consts(cfg, data: TaskData, patch_size: int,
                    device: torch.device,
                    task: TaskSpec = COMPLETION_TASK) -> FitConsts:
    """Remapping (pipeline.py:86-102) fits the whole image: its pixels are
    data.img, weighted by the clear mask, and its sampler's mask is
    data.mask (the clear mask). Completion and segmentation fit
    data.masked_img (the masked image; segmentation's blurred image) with
    unit pixel weights, and sample where data.mask * valid (the known
    region; segmentation's coarse period mask)."""
    remap = task.name == 'remapping'
    pixel_img = data.img if remap else data.masked_img
    pixel_mask = data.extra['clear_mask'] if task.pixel_mask_from_gt \
        else np.ones_like(data.mask)
    sampler_mask = data.mask[..., 0] if remap \
        else (data.mask * data.valid_mask)[..., 0]
    sampler = build_sampler_consts(pixel_img, sampler_mask, data.i_train,
                                   data.i_val, data.selected_shifts,
                                   patch_size, device)
    pool, n = pad_pool_pow2(data.i_train, fill='first')
    return FitConsts(
        pixel_img=torch.as_tensor(pixel_img, dtype=torch.float32,
                                  device=device),
        pixel_mask=torch.as_tensor(pixel_mask, dtype=torch.float32,
                                   device=device),
        pool_train=torch.as_tensor(pool, dtype=torch.long, device=device),
        pool_train_n=max(n, 1), sampler=sampler)


@dataclasses.dataclass
class FitResult:
    state: FitState
    render: Callable
    components: Components
    history: List[Dict[str, float]]
    wall_time_s: float
    iters_per_sec: float


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def fit_image(cfg, data: TaskData,
              eval_hook: Optional[Callable[[int, FitState, Callable], None]] = None,
              log_every: Optional[int] = None, device=None,
              checkpoint_dir: Optional[str] = None,
              task: TaskSpec = COMPLETION_TASK,
              metrics_path: Optional[str] = None) -> FitResult:
    """The reference's per-image training loop (NPP_completion/train.py:
    133-264). Runs on the card unless device='cpu' is passed. The history
    records, per log, the metrics and the wall ms per step of the block
    that ended there (synchronised, eval excluded). The steps and the
    render run under cfg.matmul_precision, everything else in full f32.

    checkpoint_dir: save the FitState and the batch generator every
    i_testset iterations (utils/checkpoint.py) and resume from the latest
    file there, so a resumed fit goes on exactly as one that never
    stopped. metrics_path: a JSONL stream with npp_tpu's events, a
    kind='train' event at every log and a kind='fit_done' event at the
    end (npp_tpu/models/pipeline.py:134,257,287-289)."""
    device = resolve_device(device)
    check_slice(cfg)
    tf32 = allows_tf32(cfg.matmul_precision)
    print(f'[fit] matmul_precision={cfg.matmul_precision!r}: on the card, '
          f'the steps and the render run f32 matmuls and convolutions '
          f'{"in TF32" if tf32 else "in full f32"}, the rest in full f32',
          flush=True)
    # full f32 outside the steps and the render, which set their own
    logger = MetricLogger(metrics_path)
    try:
        with matmul_precision('float32'):
            return _fit(cfg, data, eval_hook, log_every, device, task,
                        checkpoint_dir, logger)
    finally:
        logger.close()


def decayed_patch(cfg, patch_size: int, start_iter: int):
    """(patch_size, patch_num, n_decays) at start_iter: the patch-size
    schedule fast-forwarded for a resumed fit (npp_tpu/models/pipeline.py:
    147-154)."""
    n_decays = 0 if start_iter <= cfg.patch_size_decay else \
        (start_iter - 1) // cfg.patch_size_decay
    patch_num = cfg.patch_num
    for _ in range(n_decays):
        if patch_size > 31:
            patch_size //= 2
            patch_num *= 2
    return patch_size, patch_num, n_decays


def block_plan(cfg, patch_size: int, start_iter: int, n_total: int,
               log_every: Optional[int]):
    """Yields (i, patch_size, patch_num, n) for each block of a fit over
    iterations start_iter .. n_total - 1: blocks of the gcd of the event
    cadences, so eval and log boundaries fall between blocks (npp_tpu
    pipeline.py:157-163), single steps below 8 or where a whole block does
    not fit; the patch size halves (and the count doubles) at the first
    block start past each patch_size_decay iterations, while it exceeds
    31 and more than 10 iterations remain."""
    patch_size, patch_num, n_decays = decayed_patch(cfg, patch_size,
                                                    start_iter)
    block = math.gcd(cfg.i_testset, log_every or cfg.i_testset)
    use_blocks = block >= 8
    i = start_iter
    while i < n_total:
        due = (i - 1) // cfg.patch_size_decay if i > 1 else 0
        if due > n_decays and patch_size > 31 and n_total - i > 10:
            while n_decays < due and patch_size > 31:
                n_decays += 1
                patch_size //= 2
                patch_num *= 2
        n = block if (use_blocks and n_total - i >= block and
                      (i - 1) % block == 0) else 1
        yield i, patch_size, patch_num, n
        i += n


def _fit(cfg, data: TaskData, eval_hook, log_every, device: torch.device,
         task: TaskSpec, checkpoint_dir: Optional[str],
         logger: MetricLogger) -> FitResult:
    comps = build_components(cfg, data, device, task)
    state = init_fit_state(cfg, comps.model, comps.percep, device,
                           comps.style)
    render = make_render(cfg, comps.embedder)
    gen = torch.Generator().manual_seed(cfg.seed + 1)

    start_iter = 1
    if checkpoint_dir:
        latest = latest_checkpoint(checkpoint_dir)
        if latest:
            restore_fit_state(latest, state, gen)
            start_iter = state.step + 1
            print(f'[fit] resumed from {latest} at iter {start_iter}',
                  flush=True)
    stages: Dict = {}

    def stage(ps, pn, blk):
        key = (ps, pn, blk)
        if key not in stages:
            consts = make_fit_consts(cfg, data, ps, device, task)
            stages[key] = make_fit_block(cfg, comps.embedder, consts,
                                         comps.percep, comps.contextual, pn,
                                         ps, blk, comps.style, task)
        return stages[key]

    history: List[Dict[str, float]] = []
    _sync(device)
    t0 = time.time()
    fit_s = 0.0

    def post_step(i, metrics, ms_per_step):
        if log_every and i % log_every == 0:
            m = {k_: float(v) for k_, v in metrics.items()}
            m['iter'] = i
            logger.log(kind='train', task=task.name, **m)
            m['ms_per_step'] = ms_per_step
            history.append(m)
            print(f'[{task.name}] iter {i} ' + ' '.join(
                f'{k_}={v:.4g}' for k_, v in m.items() if k_ != 'iter'),
                flush=True)
        if i % cfg.i_testset == 0 and i > 0:
            if eval_hook is not None:
                eval_hook(i, state, render)
            if checkpoint_dir:
                save_fit_state(os.path.join(checkpoint_dir, f'step_{i}.pt'),
                               state, gen)

    for i, patch_size, patch_num, n in block_plan(
            cfg, data.patch_size, start_iter, cfg.N_iters, log_every):
        tb = time.time()
        metrics = stage(patch_size, patch_num, n)(state, gen)
        _sync(device)
        dt = time.time() - tb
        fit_s += dt
        post_step(i + n - 1, metrics, 1e3 * dt / n)
    _sync(device)
    wall = time.time() - t0
    iters = cfg.N_iters - start_iter
    logger.log(kind='fit_done', task=task.name, wall_time_s=wall,
               iters=iters)
    return FitResult(state=state, render=render, components=comps,
                     history=history, wall_time_s=wall,
                     iters_per_sec=iters / max(fit_s, 1e-9))
