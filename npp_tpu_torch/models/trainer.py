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
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import matmul_precision, to_device_async
from ..losses.contextual import ContextualLoss
from ..losses.lpips import LPIPS
from ..losses.pixel import img2mse
from ..losses.robust import adaptive_init, stacked_nll_mean_sum
from ..losses.style import StyleLoss
from ..nn.embedder import (TaskEmbedder, canvas_coords,
                           make_embedding_table)
from ..nn.mlp import render_activation
from ..nn.warp import WarpField, make_warp, warp_coords
from ..utils.debug import span
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
    return FitState(params, make_adam(params.parameters(), cfg.lrate), 0)


def make_adam(params, lr, capturable: bool = False) -> torch.optim.Adam:
    """Adam at the reference's betas (0.9, 0.999) and eps 1e-8, for every
    fit of the port; capturable for a fit replayed from a CUDA graph."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def embed_coords(params: FitParams, embedder, coords: torch.Tensor
                 ) -> torch.Tensor:
    """The embedding of f32 (N, 2) coordinates, warped first when the
    params carry a warp field (npp_tpu/models/trainer.py:76-95)."""
    if params.warp is not None:
        coords = warp_coords(params.warp, coords, embedder.res)
    return embedder.embed(coords)


def draw_batch(cfg, gen: torch.Generator, sampler: SamplerConsts,
               pool_n: int, patch_num: int, patch_size: int
               ) -> Tuple[PatchBatch, torch.Tensor]:
    """One step's draws from `gen`, in the order every fit draws them: the
    patches, then N_rand indices into the pixel pool (on the host)."""
    with span('npp.draw'):
        batch = sample_patches(gen, sampler, patch_num, patch_size,
                               cfg.num_real_patch_per_sample,
                               cfg.invalid_ratio, cfg.no_reg_sampling)
        return batch, torch.randint(0, pool_n, (cfg.N_rand,), generator=gen)


def image_losses(cfg, params: FitParams, pred_pix: torch.Tensor,
                 gt_rgb: torch.Tensor, gt_mask: torch.Tensor,
                 pred_patch: torch.Tensor, batches: Sequence[PatchBatch],
                 percep: Optional[LPIPS], contextual: Optional[ContextualLoss],
                 style: Optional[StyleLoss], task: TaskSpec, stacked: bool
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of B images, each on its own batch: pred_pix, gt_rgb and
    gt_mask (B, N_rand, .), pred_patch (B, P, S, S, 3), one PatchBatch per
    image. Returns the sum over the images (each image's gradient is its
    own) and the metrics, means over the images.

    stacked: the params hold a latent row per image ((B, 1, C),
    parallel/batch.py), so the pixel loss is one K4 segment of 3B columns
    and LPIPS, CX and the style loss aggregate per image; else B is 1 and
    the params are one image's (the sequential fit)."""
    dev = pred_pix.device
    nb = len(batches)
    metrics: Dict[str, torch.Tensor] = {}
    loss = torch.zeros((), device=dev)
    if not cfg.no_pix_loss:
        with span('npp.loss.pixel'):
            if not stacked:
                pix = img2mse(pred_pix[0], gt_rgb[0], cfg.loss_type,
                              params.adaptive_pix, gt_mask[0],
                              scale_lo=cfg.adaptive_scale_lo)
            elif cfg.loss_type == 'robust_loss_adaptive':
                diff = pred_pix - gt_rgb
                diff = diff * gt_mask + (1.0 - gt_mask) * diff * 0.3
                pix = stacked_nll_mean_sum(diff, params.adaptive_pix,
                                           scale_lo=cfg.adaptive_scale_lo)
            else:
                pix = sum(img2mse(pred_pix[j], gt_rgb[j], cfg.loss_type,
                                  None, gt_mask[j]) for j in range(nb))
            loss = loss + pix
            metrics['pixel'] = pix.detach() / nb

    # ---- NHWC patch tensors, (B*P*K, S, S, C), image-major
    patch_num, s = pred_patch.shape[1:3]
    topk = cfg.num_real_patch_per_sample
    pk = patch_num * topk

    def per_slot(t):   # (B, P, ...) -> (B*P*K, ...), each repeated K times
        return t[:, :, None].expand((nb, patch_num, topk) + t.shape[2:]
                                    ).reshape((nb * pk,) + t.shape[2:])

    def field(name):   # the images' PatchBatch fields on a leading axis
        ts = [getattr(b, name) for b in batches]
        return ts[0][None] if nb == 1 else torch.stack(ts)

    pred_t = per_slot(pred_patch)
    real_rgb = field('real_rgb').reshape(nb * pk, s, s, 3)
    real_mask = field('real_mask').reshape(nb * pk, s, s, 1)
    fake_rgb = per_slot(field('fake_rgb'))
    fake_mask = per_slot(field('fake_mask'))
    valid = field('valid').reshape(nb * pk)
    weight = field('weight').reshape(nb * pk) if cfg.use_patch_weight \
        else None
    sources = [b.source for b in batches]

    # comp-paste for 'val' batches (reference: train.py:228-236)
    is_val = [src == SOURCE_VAL for src in sources]
    cx_pred = pred_t
    if cfg.use_comp and any(is_val):
        cx_pred = fake_rgb * fake_mask + pred_t * (1.0 - fake_mask)
        if not all(is_val):
            with span('npp.h2d'):
                rows = to_device_async(torch.tensor(is_val), dev)
            rows = rows.repeat_interleave(pk)
            cx_pred = torch.where(rows[:, None, None, None], cx_pred, pred_t)

    if cfg.use_contextual_loss and contextual is not None:
        with span('npp.loss.cx'):
            cx = contextual(cx_pred * real_mask, real_rgb * real_mask,
                            weight=weight, valid=valid,
                            groups=nb if stacked else None)
            loss = loss + torch.sum(cx) * cfg.contextual_weight
            metrics['contextual'] = cx.detach().mean()

    if cfg.use_perceptual_loss and percep is not None:
        # only on 'same' batches (reference: train.py:239-251)
        same = [j for j, src in enumerate(sources) if src == SOURCE_SAME]
        perc = torch.zeros((), device=dev)
        if same:
            with span('npp.loss.lpips'):
                if len(same) < nb:
                    rows = torch.cat([torch.arange(j * pk, (j + 1) * pk)
                                      for j in same])
                    with span('npp.h2d'):
                        rows = to_device_async(rows, dev)
                    pred_s, real_s, fake_s, valid_s = (
                        t[rows] for t in (pred_t, real_mask, fake_rgb, valid))
                    weight_s = None if weight is None else weight[rows]
                else:
                    pred_s, real_s, fake_s, valid_s, weight_s = (
                        pred_t, real_mask, fake_rgb, valid, weight)
                robust = cfg.use_adaptive_perceptual_loss
                per = percep(pred_s * real_s, fake_s * real_s,
                             use_robust=robust,
                             adaptive=params.adaptive_percep, normalize=True,
                             images=same if stacked and robust else None
                             ).reshape(len(same), pk)
                v = valid_s.reshape(len(same), pk)
                if weight_s is not None:
                    perc = torch.sum(per * weight_s.reshape(len(same), pk) * v)
                else:
                    vf = v.to(per.dtype)
                    perc = torch.sum(torch.sum(per * vf, 1) /
                                     torch.clamp(vf.sum(1), min=1.0))
                loss = loss + perc * cfg.perceptual_weight
        metrics['perceptual'] = perc.detach() / nb

    if task.use_style and getattr(cfg, 'use_style_loss', False) \
            and style is not None:
        # (reference: NPP_remapping/train.py:255-262), the comp-paste on
        # 'val' batches as for CX
        with span('npp.loss.style'):
            st = style(cx_pred * real_mask, real_rgb * real_mask,
                       weight=weight, adaptive=params.adaptive_style,
                       valid=valid,
                       images=list(range(nb)) if stacked else None)
            loss = loss + torch.sum(st) * cfg.style_weight
            metrics['style'] = st.detach().mean()

    metrics['source'] = torch.tensor(float(np.mean(sources)))
    return loss, metrics


def build_loss_fn(cfg, percep: Optional[LPIPS],
                  contextual: Optional[ContextualLoss], patch_num: int,
                  patch_size: int,
                  inject: Optional[Tuple[torch.Tensor, PatchBatch]] = None,
                  style: Optional[StyleLoss] = None,
                  task: TaskSpec = COMPLETION_TASK):
    """Returns loss_fn(params, embedder, consts, gen) -> (loss, metrics):
    image_losses of one image.

    inject: a fixed (pixel indices (N_rand,), PatchBatch) used instead of
    drawing from `gen` — the tests hand both packages the same batch."""
    n_rand = cfg.N_rand

    def loss_fn(params: FitParams, embedder, consts: FitConsts,
                gen: Optional[torch.Generator]):
        if inject is not None:
            pix_idx, batch = inject
        else:
            batch, pix_idx = draw_batch(cfg, gen, consts.sampler,
                                        consts.pool_train_n, patch_num,
                                        patch_size)

        # ---- pixel batch (reference: NPP_completion/train.py:172-178)
        with span('npp.h2d'):
            pix_idx = to_device_async(pix_idx, consts.pixel_img.device)
        pix_coords = consts.pool_train[pix_idx]
        gt_rgb = consts.pixel_img[pix_coords[:, 0], pix_coords[:, 1]]
        gt_mask = consts.pixel_mask[pix_coords[:, 0], pix_coords[:, 1]]

        # ---- one MLP forward over pixels + patch pixels
        all_coords = torch.cat([pix_coords, batch.fake_coords.reshape(-1, 2)], 0)
        with span('npp.embed'):
            emb = embed_coords(params, embedder, all_coords.to(torch.float32))
        with span('npp.mlp'):
            pred = render_activation(params.mlp(emb), cfg.normalize_type)
        return image_losses(
            cfg, params, pred[None, :n_rand], gt_rgb[None], gt_mask[None],
            pred[None, n_rand:].reshape(1, patch_num, patch_size, patch_size,
                                        3),
            [batch], percep, contextual, style, task, stacked=False)

    return loss_fn


def fit_step(state: FitState, loss_fn, embedder, consts: FitConsts,
             gen: Optional[torch.Generator], schedule) -> Dict[str, torch.Tensor]:
    """One Adam step. Every parameter gets a gradient, zero where the loss
    did not reach it this step (see the module note)."""
    for group in state.optimizer.param_groups:
        group['lr'] = schedule(state.step)
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.params, embedder, consts, gen)
    with span('npp.backward'):
        loss.backward()
    with span('npp.adam'):
        for p in state.params.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
    state.step += 1
    metrics['loss'] = loss.detach()
    return metrics


def table_guard(cfg, n_values: int) -> Optional[torch.dtype]:
    """The dtype of a table of `n_values` entries under cfg's size guard
    (npp_tpu/models/trainer.py:293-312, parallel/runner.py:196-218):
    cfg.embed_table names it; none above cfg.embed_table_max_mb, unless
    cfg.embed_table_degrade lets a bf16 table stand in for an f32 one too
    large."""
    dtype = {'float32': torch.float32,
             'bfloat16': torch.bfloat16}.get(cfg.embed_table)
    if dtype is None:
        return None
    mb = n_values * dtype.itemsize / 1e6
    max_mb = int(cfg.embed_table_max_mb)
    if mb <= max_mb:
        return dtype
    if dtype == torch.float32 and cfg.embed_table_degrade and mb / 2 <= max_mb:
        return torch.bfloat16
    return None


def uses_table(cfg, block: int) -> bool:
    """Whether a block of `block` steps builds its canvas table: only a
    block of 8 steps or more, and none with the warp field (its
    coordinates are not integers). The table's dtype is table_guard's."""
    return block >= 8 and not getattr(cfg, 'warp_field', False)


def table_dtype(cfg, embedder, block: int) -> Optional[torch.dtype]:
    """The dtype of the per-block canvas table of one image, or None to
    embed on the fly through K1 (uses_table, then table_guard)."""
    if not uses_table(cfg, block) or not isinstance(embedder, TaskEmbedder):
        return None
    h, w = embedder.res
    return table_guard(cfg, int(h) * int(w) * embedder.out_dim)


def make_fit_block(cfg, embedder, consts: FitConsts, percep, contextual,
                   patch_num: int, patch_size: int, block: int,
                   style: Optional[StyleLoss] = None,
                   task: TaskSpec = COMPLETION_TASK):
    """run_block(state, gen) -> last step's metrics, after `block` steps.
    With cfg.embed_table the canvas embedding is built once per block. The
    steps run under cfg.matmul_precision (device.py::matmul_precision)."""
    loss_fn = build_loss_fn(cfg, percep, contextual, patch_num, patch_size,
                            style=style, task=task)
    dtype = table_dtype(cfg, embedder, block)
    return block_runner(cfg, block, loss_fn, embedder, consts,
                        (lambda: make_embedding_table(embedder, dtype))
                        if dtype is not None else None)


def block_runner(cfg, block: int, loss_fn, embedder, consts,
                 table: Optional[Callable[[], object]] = None):
    """run_block(state, feed) -> the last step's metrics after `block`
    fit_steps (this module's, read at each step) of loss_fn, in a span
    npp.block: the embedding from table() under npp.table when given, then
    a span npp.step a step. make_fit_block's and make_batched_fit_block's."""
    schedule = make_schedule(cfg)

    def run_block(state: FitState, feed):
        # npp_tpu's scope (trainer.py:139-146): every matmul and convolution
        # of the loss and of its gradient, so loss.backward() as well
        with matmul_precision(cfg.matmul_precision), span('npp.block'):
            emb = embedder
            if table is not None:
                with span('npp.table'):
                    emb = table()
            metrics = None
            for _ in range(block):
                with span('npp.step', state.step):
                    metrics = fit_step(state, loss_fn, emb, consts, feed,
                                       schedule)
        return metrics

    return run_block


def render_rows(cfg, params: FitParams, embedder, coords: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """RGB (N, 3) of (N, 2) f32 coordinates, `chunk` rows a forward."""
    return torch.cat([render_activation(
        params.mlp(embed_coords(params, embedder, c)), cfg.normalize_type)
        for c in coords.split(chunk)], 0)


def make_render(cfg, embedder, chunk: int = RENDER_CHUNK):
    """Chunked full-frame renderer (replaces the reference's chunk=20000
    eval loops, NPP_completion/train.py:277-308): render(params, h, w)
    -> (H, W, 3), under cfg.matmul_precision as npp_tpu's render
    (trainer.py:355-358)."""

    @torch.no_grad()
    def render(params: FitParams, h: int, w: int) -> torch.Tensor:
        coords = canvas_coords(h, w, embedder.angles.device)
        with matmul_precision(cfg.matmul_precision), span('npp.render'):
            return render_rows(cfg, params, embedder, coords,
                               chunk).reshape(h, w, 3)

    return render

