"""Per-image fit engine: the loss, one Adam step, a block of steps, the render.

Port of `npp_tpu/models/trainer.py`, parameterised by a TaskSpec as the
JAX package's is (completion; remapping adds the style term and weights the
pixel loss by the clear mask). With cfg.warp_field the coordinates pass
through the learned warp (nn/warp.py) before the embedding, K1 then runs
on the fly on warped coordinates with its backward kernel, and no table is
built. What differs from the JAX package, and why:
 - PyTorch runs eagerly, so a "block" is a Python loop of steps; the canvas
   embedding table (cfg.embed_table, in its dtype, under the same size
   guard) is still built once per block by K1 and gathered per step, as
   the JAX scan-block does (trainer.py:285-327).
 - The perceptual term runs only on 'same' steps (trainer.py:223-224). In
   JAX its latents then get zero gradients and optax Adam still moves them
   by momentum; torch.optim.Adam skips a parameter whose .grad is None and
   does not advance its moments, so every step hands Adam an explicit zero
   gradient for each parameter the loss did not reach.
 - cfg.matmul_precision scopes the fit's steps (forward and backward) and
   the render, as in npp_tpu: TF32 on the card for the names JAX maps to
   DEFAULT or HIGH ('bfloat16', the default), full f32 for 'float32'.
 - The learning rate is set on the optimizer before each step: step k
   (0-based count of updates so far) uses lr0 * 0.1^(k / (lrate_decay*100)),
   optax's schedule(count) convention (trainer.py:72-73).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import matmul_precision
from ..losses.contextual import ContextualLoss
from ..losses.lpips import LPIPS
from ..losses.pixel import img2mse
from ..losses.robust import adaptive_init
from ..losses.style import StyleLoss
from ..nn.embedder import TaskEmbedder, make_embedding_table
from ..nn.mlp import render_activation
from ..nn.warp import WarpField, make_warp, warp_coords
from .sampler import (SOURCE_SAME, SOURCE_VAL, PatchBatch, SamplerConsts,
                      sample_patches)

RENDER_CHUNK = 1 << 16


@dataclass(frozen=True)
class TaskSpec:
    """Static per-task differences (npp_tpu/models/trainer.py:52-58)."""

    name: str
    use_style: bool = False
    pixel_mask_from_gt: bool = False  # remapping: weight by clear mask values


COMPLETION_TASK = TaskSpec(name='completion')


@dataclass
class FitConsts:
    """Device-resident per-image constants for the fit."""

    pixel_img: torch.Tensor     # (H, W, 3) gt source for the pixel loss
    pixel_mask: torch.Tensor    # (H, W, 1) weights for the pixel loss
    pool_train: torch.Tensor    # (Nt, 2) long padded train-coord pool
    pool_train_n: int
    sampler: SamplerConsts


class FitParams(nn.Module):
    """Everything Adam trains: the MLP, the adaptive-loss latents and the
    warp field."""

    def __init__(self, mlp: nn.Module, adaptive_pix: nn.Module,
                 adaptive_percep: Optional[nn.ModuleList] = None,
                 adaptive_style: Optional[nn.ModuleList] = None,
                 warp: Optional[WarpField] = None):
        super().__init__()
        self.mlp = mlp
        self.adaptive_pix = adaptive_pix
        self.adaptive_percep = adaptive_percep
        self.adaptive_style = adaptive_style
        self.warp = warp


@dataclass
class FitState:
    params: FitParams
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_schedule(cfg) -> Callable[[int], float]:
    return lambda step: cfg.lrate * (0.1 ** (step / (cfg.lrate_decay * 100.0)))


def init_fit_state(cfg, model: nn.Module, percep: Optional[LPIPS],
                   device: torch.device,
                   style: Optional[StyleLoss] = None) -> FitState:
    """The warp field's weights come from a generator seeded with
    cfg.seed + 2 (the bands take cfg.seed, the batches cfg.seed + 1)."""
    adaptive_percep = percep.init_adaptive() \
        if percep is not None and cfg.use_adaptive_perceptual_loss else None
    adaptive_style = style.init_adaptive() if style is not None and \
        getattr(cfg, 'use_adaptive_style_loss', False) else None
    warp = make_warp(cfg, torch.Generator().manual_seed(cfg.seed + 2))
    params = FitParams(model, adaptive_init(3), adaptive_percep,
                       adaptive_style, warp).to(device)
    opt = torch.optim.Adam(params.parameters(), lr=cfg.lrate,
                           betas=(0.9, 0.999), eps=1e-8)
    return FitState(params, opt, 0)


def embed_coords(params: FitParams, embedder, coords: torch.Tensor
                 ) -> torch.Tensor:
    """The embedding of f32 (N, 2) coordinates, warped first when the
    params carry a warp field (npp_tpu/models/trainer.py:76-95)."""
    if params.warp is not None:
        coords = warp_coords(params.warp, coords, embedder.res)
    return embedder.embed(coords)


def build_loss_fn(cfg, percep: Optional[LPIPS],
                  contextual: Optional[ContextualLoss], patch_num: int,
                  patch_size: int,
                  inject: Optional[Tuple[torch.Tensor, PatchBatch]] = None,
                  style: Optional[StyleLoss] = None,
                  task: TaskSpec = COMPLETION_TASK):
    """Returns loss_fn(params, embedder, consts, gen) -> (loss, metrics).

    inject: a fixed (pixel indices (N_rand,), PatchBatch) used instead of
    drawing from `gen` — the tests hand both packages the same batch."""
    topk = cfg.num_real_patch_per_sample
    n_rand = cfg.N_rand
    use_cx = cfg.use_contextual_loss and contextual is not None
    use_perc = cfg.use_perceptual_loss and percep is not None
    use_style = task.use_style and getattr(cfg, 'use_style_loss', False) \
        and style is not None

    def loss_fn(params: FitParams, embedder, consts: FitConsts,
                gen: Optional[torch.Generator]):
        dev = consts.pixel_img.device
        if inject is not None:
            pix_idx, batch = inject
            pix_idx = pix_idx.to(dev)
        else:
            batch = sample_patches(gen, consts.sampler, patch_num, patch_size,
                                   topk, cfg.invalid_ratio,
                                   cfg.no_reg_sampling)
            pix_idx = torch.randint(0, consts.pool_train_n, (n_rand,),
                                    generator=gen).to(dev)

        # ---- pixel batch (reference: NPP_completion/train.py:172-178)
        pix_coords = consts.pool_train[pix_idx]
        gt_rgb = consts.pixel_img[pix_coords[:, 0], pix_coords[:, 1]]
        gt_mask = consts.pixel_mask[pix_coords[:, 0], pix_coords[:, 1]]

        # ---- one MLP forward over pixels + patch pixels
        all_coords = torch.cat([pix_coords, batch.fake_coords.reshape(-1, 2)], 0)
        raw = params.mlp(embed_coords(params, embedder,
                                      all_coords.to(torch.float32)))
        pred = render_activation(raw, cfg.normalize_type)
        pred_pix = pred[:n_rand]
        pred_patch = pred[n_rand:].reshape(patch_num, patch_size, patch_size, 3)

        metrics: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=dev)
        if not cfg.no_pix_loss:
            pix_loss = img2mse(pred_pix, gt_rgb, cfg.loss_type,
                               params.adaptive_pix, gt_mask,
                               scale_lo=cfg.adaptive_scale_lo)
            loss = loss + pix_loss
            metrics['pixel'] = pix_loss.detach()

        # ---- NHWC patch tensors, (P*K, S, S, C)
        pk = patch_num * topk
        s = patch_size

        def per_slot(t):   # (P, ...) -> (P*K, ...), each repeated K times
            return t[:, None].expand((patch_num, topk) + t.shape[1:]
                                     ).reshape((pk,) + t.shape[1:])

        pred_t = per_slot(pred_patch)
        real_rgb = batch.real_rgb.reshape(pk, s, s, 3)
        real_mask = batch.real_mask.reshape(pk, s, s, 1)
        fake_rgb = per_slot(batch.fake_rgb)
        fake_mask = per_slot(batch.fake_mask)
        valid = batch.valid.reshape(pk)
        weight = batch.weight.reshape(pk) if cfg.use_patch_weight else None

        # comp-paste for 'val' batches (reference: train.py:228-236)
        if cfg.use_comp and batch.source == SOURCE_VAL:
            cx_pred = fake_rgb * fake_mask + pred_t * (1.0 - fake_mask)
        else:
            cx_pred = pred_t

        if use_cx:
            cx = contextual(cx_pred * real_mask, real_rgb * real_mask,
                            weight=weight, valid=valid)
            loss = loss + cx * cfg.contextual_weight
            metrics['contextual'] = cx.detach()

        if use_perc:
            # only on 'same' batches (reference: train.py:239-251)
            if batch.source == SOURCE_SAME:
                per = percep(pred_t * real_mask, fake_rgb * real_mask,
                             use_robust=cfg.use_adaptive_perceptual_loss,
                             adaptive=params.adaptive_percep,
                             normalize=True).reshape(pk)
                if weight is not None:
                    perc = torch.sum(per * weight * valid)
                else:
                    v = valid.to(per.dtype)
                    perc = torch.sum(per * v) / torch.clamp(v.sum(), min=1.0)
                loss = loss + perc * cfg.perceptual_weight
            else:
                perc = torch.zeros((), device=dev)
            metrics['perceptual'] = perc.detach()

        if use_style:
            # (reference: NPP_remapping/train.py:255-262), the comp-paste
            # on 'val' batches as for CX
            st = style(cx_pred * real_mask, real_rgb * real_mask,
                       weight=weight, adaptive=params.adaptive_style,
                       valid=valid)
            loss = loss + st * cfg.style_weight
            metrics['style'] = st.detach()

        metrics['source'] = torch.tensor(float(batch.source))
        return loss, metrics

    return loss_fn


def fit_step(state: FitState, loss_fn, embedder, consts: FitConsts,
             gen: Optional[torch.Generator], schedule) -> Dict[str, torch.Tensor]:
    """One Adam step. Every parameter gets a gradient, zero where the loss
    did not reach it this step (see the module note)."""
    for group in state.optimizer.param_groups:
        group['lr'] = schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.params, embedder, consts, gen)
    loss.backward()
    for p in state.params.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.step += 1
    metrics['loss'] = loss.detach()
    return metrics


def table_dtype(cfg, embedder, block: int) -> Optional[torch.dtype]:
    """The dtype of the per-block canvas table, or None to embed on the fly
    through K1 (npp_tpu/models/trainer.py:293-312): cfg.embed_table names
    it; no table for tiny blocks, with the warp field (its coordinates are
    not integers), or above cfg.embed_table_max_mb, unless
    cfg.embed_table_degrade lets a bf16 table stand in for an f32 one too
    large."""
    dtype = {'float32': torch.float32,
             'bfloat16': torch.bfloat16}.get(cfg.embed_table)
    if dtype is None or block < 8 or not isinstance(embedder, TaskEmbedder) \
            or getattr(cfg, 'warp_field', False):
        return None
    h, w = embedder.res
    mb = int(h) * int(w) * embedder.out_dim * dtype.itemsize / 1e6
    max_mb = int(cfg.embed_table_max_mb)
    if mb <= max_mb:
        return dtype
    if dtype == torch.float32 and cfg.embed_table_degrade and mb / 2 <= max_mb:
        return torch.bfloat16
    return None


def make_fit_block(cfg, embedder, consts: FitConsts, percep, contextual,
                   patch_num: int, patch_size: int, block: int,
                   style: Optional[StyleLoss] = None,
                   task: TaskSpec = COMPLETION_TASK):
    """run_block(state, gen) -> last step's metrics, after `block` steps.
    With cfg.embed_table the canvas embedding is built once per block. The
    steps run under cfg.matmul_precision (device.py::matmul_precision)."""
    loss_fn = build_loss_fn(cfg, percep, contextual, patch_num, patch_size,
                            style=style, task=task)
    schedule = make_schedule(cfg)
    dtype = table_dtype(cfg, embedder, block)

    def run_block(state: FitState, gen: torch.Generator):
        # npp_tpu's scope (trainer.py:139-146): every matmul and convolution
        # of the loss and of its gradient, so loss.backward() as well
        with matmul_precision(cfg.matmul_precision):
            emb = embedder if dtype is None else \
                make_embedding_table(embedder, dtype)
            metrics = None
            for _ in range(block):
                metrics = fit_step(state, loss_fn, emb, consts, gen, schedule)
        return metrics

    return run_block


def make_render(cfg, embedder, chunk: int = RENDER_CHUNK):
    """Chunked full-frame renderer (replaces the reference's chunk=20000
    eval loops, NPP_completion/train.py:277-308): render(params, h, w)
    -> (H, W, 3), under cfg.matmul_precision as npp_tpu's render
    (trainer.py:355-358)."""

    @torch.no_grad()
    def render(params: FitParams, h: int, w: int) -> torch.Tensor:
        dev = embedder.angles.device
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing='ij')
        coords = torch.stack([ys, xs], -1).reshape(-1, 2).to(torch.float32)
        with matmul_precision(cfg.matmul_precision):
            out = [render_activation(params.mlp(embed_coords(params,
                                                             embedder, c)),
                                     cfg.normalize_type)
                   for c in coords.split(chunk)]
        return torch.cat(out, 0).reshape(h, w, 3)

    return render

