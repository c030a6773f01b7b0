"""Multi-image batched fits: B independent per-image optimisations
advanced by one step at a time, a port of `npp_tpu/parallel/batch.py`.

Where npp_tpu vmaps its per-image loss and shards the image axis over
chips, the port stacks the images on a leading axis inside one step:

 - the models: every nn.Linear of the per-image NPPNet / NPPNetTop1 (and
   of the warp field) becomes a StackedLinear, weights (B, in, out) run by
   torch.bmm, each snake through K2's batched path with a bias per image;
   the adaptive-loss latents become (B, 1, C). One torch.optim.Adam
   updates the stack: Adam is elementwise, so each image's slice moves as
   its own Adam would move it (`stack_modules`, `unstack_fit_state`);
 - the embedding: K1's batched entry, one launch for the B images, each
   with its own proposals and its own tight normalisation dims
   (`StackedEmbedder`); or a table per image over the shared bucket
   canvas, built by one batched K1 launch per block
   (`make_batched_table`);
 - the losses are the sequential fit's own (models/trainer.py::
   image_losses), stacked: every image keeps its pool, sampler constants
   and patches, the pixel loss (one K4 segment, alpha and scale per
   column: 3B columns), LPIPS-robust and the style loss (a K4 segment per
   layer and image), CX (the mean-shift statistic and the aggregation per
   image). The step's loss is the sum of the images' losses, so each
   image's gradient is its own; the metrics are means over the images,
   as npp_tpu's.

Each image draws its batches from a generator of its own seeded as the
sequential fit seeds its one (cfg.seed + 1): every image sees the batch
its sequential fit_image would draw, the counterpart of the key that
npp_tpu broadcasts to all images (batch.py:108-115). The draws and the
patch gathers run per image on the host's stream; the MLP and the losses
run once for the stack.

Over a mesh (parallel/mesh.py) each rank stacks only its block of the
images (parallel/runner.py::fit_images) and `gather_fit_state` gathers
the stacked state back to every rank; `make_sharded_render` renders one
image with its pixels split over the ranks.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import matmul_precision, to_device_async
from ..kernels.periodic_embed import periodic_embed_batched
from ..losses.robust import AdaptiveLossParams
# fit_step is imported for the name batch.fit_step alone: the steps call
# models/trainer.py's (block_runner), which a caller may replace
from ..models.trainer import (COMPLETION_TASK, RENDER_CHUNK,  # noqa: F401
                              FitConsts, FitParams, FitState, TaskSpec,
                              block_runner, draw_batch, fit_step,
                              image_losses, make_adam, render_rows,
                              uses_table)
from ..nn.embedder import TaskEmbedder, canvas_coords
from ..nn.mlp import StackedLinear, render_activation
from ..utils.debug import span
from .mesh import Mesh, gather_leading_axis


@dataclasses.dataclass
class StackedEmbedder:
    """B TaskEmbedders with the same static fields: angles and periods
    (B, K, 2) and each image's tight dims `res` (B, 2), all on the card."""

    freq_bands: Optional[torch.Tensor]
    angles: torch.Tensor
    periods: torch.Tensor
    res: torch.Tensor
    freq_scales: Tuple[float, ...]
    freq_offsets: Tuple[float, ...]
    angle_offsets: Tuple[float, ...]
    out_dim: int
    top1_dim: int

    def embed(self, coords_yx: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(B, N, 2) -> (B, N, out_dim), one K1 launch on the card."""
        return periodic_embed_batched(coords_yx, self.angles, self.periods,
                                      self.freq_bands, self.freq_scales,
                                      self.freq_offsets, self.angle_offsets,
                                      self.res, out_dtype)


@dataclasses.dataclass
class StackedTableEmbedder:
    """Per-image tables over the shared bucket canvas, (B, H*W, D); rows
    gathered at integer canvas pixels, bf16 tables read back as f32."""

    table: torch.Tensor
    res: Tuple[int, int]
    out_dim: int
    top1_dim: int

    def embed(self, coords_yx: torch.Tensor) -> torch.Tensor:
        b, n = coords_yx.shape[:2]
        hw = self.table.shape[1]
        idx = coords_yx[..., 0].long() * self.res[1] + coords_yx[..., 1].long()
        idx = idx + torch.arange(b, device=idx.device)[:, None] * hw
        return self.table.reshape(b * hw, -1).index_select(
            0, idx.reshape(-1)).float().reshape(b, n, -1)


def stack_embedders(embedders: Sequence[TaskEmbedder]) -> StackedEmbedder:
    """Stack per-image proposal geometry on a leading axis (batch.py:31-42).
    Static fields must agree; `res` is each image's TIGHT loader canvas,
    not the bucket's, so a small image's embedding never depends on the
    bucket's largest image. The bands are the first image's: every image
    draws them from the same seed."""
    e0 = embedders[0]
    for e in embedders[1:]:
        if (e.freq_scales, e.freq_offsets, e.angle_offsets, e.out_dim,
                e.top1_dim) != (e0.freq_scales, e0.freq_offsets,
                                e0.angle_offsets, e0.out_dim, e0.top1_dim) \
                or e.angles.shape != e0.angles.shape:
            raise ValueError('stack_embedders needs embedders of one shape')
    dev = e0.angles.device
    return StackedEmbedder(
        freq_bands=e0.freq_bands,
        angles=torch.stack([e.angles for e in embedders]),
        periods=torch.stack([e.periods for e in embedders]),
        res=torch.tensor([list(e.res) for e in embedders],
                         dtype=torch.float32, device=dev),
        freq_scales=e0.freq_scales, freq_offsets=e0.freq_offsets,
        angle_offsets=e0.angle_offsets, out_dim=e0.out_dim,
        top1_dim=e0.top1_dim)


@torch.no_grad()
def make_batched_table(emb_b: StackedEmbedder, grid_hw: Tuple[int, int],
                       dtype: torch.dtype = torch.float32,
                       chunk: int = 1 << 18) -> StackedTableEmbedder:
    """Each image's embedding table over the shared bucket canvas, its
    values at that image's tight normalisation (batch.py:51-72): one
    batched K1 launch per `chunk` rows (one at 384x512)."""
    h, w = grid_hw
    b = emb_b.angles.shape[0]
    coords = canvas_coords(h, w, emb_b.angles.device)
    table = torch.cat([emb_b.embed(c.expand(b, -1, -1).contiguous(), dtype)
                       for c in coords.split(chunk)], 1)
    return StackedTableEmbedder(table=table, res=(int(h), int(w)),
                                out_dim=emb_b.out_dim,
                                top1_dim=emb_b.top1_dim)


def pad_pools_to_common(pools: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-image (Ni, 2) pixel pools stacked at the longest length, each
    padded by repeating its last row (npp_tpu's _pad_pools_to_common
    'edge' mode): draws are bounded by each image's own count, so the
    padding is never read."""
    n = max(p.shape[0] for p in pools)
    return torch.stack([torch.cat([p, p[-1:].expand(n - p.shape[0], -1)])
                        for p in pools])


@dataclasses.dataclass
class BatchedConsts:
    """The images' FitConsts on a leading axis where the step reads them
    stacked: pixel images and weights (B, H, W, .) on the bucket canvas,
    the pixel pools padded to one length; the sampler constants stay per
    image (each image samples its own patches)."""

    pixel_img: torch.Tensor
    pixel_mask: torch.Tensor
    pool_train: torch.Tensor
    pool_train_n: List[int]
    samplers: list

    @property
    def n(self) -> int:
        return len(self.samplers)


def stack_consts(consts: Sequence[FitConsts]) -> BatchedConsts:
    """Stack per-image FitConsts of one canvas (batch.py:45-48)."""
    return BatchedConsts(
        pixel_img=torch.stack([c.pixel_img for c in consts]),
        pixel_mask=torch.stack([c.pixel_mask for c in consts]),
        pool_train=pad_pools_to_common([c.pool_train for c in consts]),
        pool_train_n=[c.pool_train_n for c in consts],
        samplers=[c.sampler for c in consts])


# ---- stacked parameters ------------------------------------------------

def stack_modules(mods: Sequence[nn.Module]) -> nn.Module:
    """One module holding B copies of a module's parameters: every
    nn.Linear becomes a StackedLinear, every AdaptiveLossParams gets
    latents (B, 1, C); the rest keeps its structure (a deep copy of the
    first, its children replaced)."""
    m0 = mods[0]
    if isinstance(m0, nn.Linear):
        return StackedLinear.from_linears(mods)
    if isinstance(m0, AdaptiveLossParams):
        st = AdaptiveLossParams(m0.latent_alpha.shape[-1], n_stack=len(mods))
        with torch.no_grad():
            st.latent_alpha.copy_(torch.stack([m.latent_alpha for m in mods]))
            st.latent_scale.copy_(torch.stack([m.latent_scale for m in mods]))
        return st.to(m0.latent_alpha.device)
    if any(True for _ in m0.parameters(recurse=False)):
        raise TypeError(f'cannot stack {type(m0).__name__}')
    out = copy.copy(m0)
    out._modules = dict(m0._modules)
    for name, child in m0.named_children():
        setattr(out, name, stack_modules([getattr(m, name) for m in mods]))
    return out


def _param_pairs(stacked: nn.Module, template: nn.Module):
    """(stacked parameter, single parameter, transposed) for every
    parameter, in order: a StackedLinear's kernel (n, in, out) is the
    nn.Linear weight (out, in) transposed."""
    pairs = []
    for (_, sm), (_, tm) in zip(stacked.named_modules(),
                                template.named_modules()):
        for (sn, sp), (_, tp) in zip(sm.named_parameters(recurse=False),
                                     tm.named_parameters(recurse=False)):
            pairs.append((sp, tp, isinstance(sm, StackedLinear)
                          and sn == 'kernel'))
    return pairs


def _piece(t: torch.Tensor, j: int, transposed: bool) -> torch.Tensor:
    return t[j].t() if transposed else t[j]


def unstack_params(params_b: FitParams, template: FitParams,
                   j: int) -> FitParams:
    """Image j's parameters: a copy of the single-image `template` holding
    its slice of the stacked `params_b`."""
    params = copy.deepcopy(template)
    with torch.no_grad():
        for sp, tp, tr in _param_pairs(params_b, params):
            tp.copy_(_piece(sp, j, tr))
    return params


def unstack_fit_state(state_b: FitState, template: FitParams,
                      j: int) -> FitState:
    """Image j's FitState: unstack_params with a fresh Adam that carries
    its slice of the stacked Adam's moments and step."""
    params = unstack_params(state_b.params, template, j)
    pairs = _param_pairs(state_b.params, params)
    opt_b = state_b.optimizer
    opt = make_adam(params.parameters(), opt_b.param_groups[0]['lr'])
    for sp, tp, tr in pairs:
        st = opt_b.state.get(sp)
        if st:
            opt.state[tp] = {
                'step': st['step'].clone(),
                'exp_avg': _piece(st['exp_avg'], j, tr).clone(),
                'exp_avg_sq': _piece(st['exp_avg_sq'], j, tr).clone()}
    return FitState(params, opt, state_b.step)


def gather_fit_state(state_b: FitState, template: FitParams, mesh: Mesh,
                     n: int, axis: str = 'images') -> FitState:
    """The stacked FitState of all n images, on every rank and its device,
    from each rank's block `state_b` along `axis`: every stacked parameter
    and Adam moment all-gathered (mesh.py::gather_leading_axis), the
    padding dropped. Adam's step count is every rank's own (they step
    together)."""
    full = stack_modules([template] * n)
    opt_b = state_b.optimizer
    opt = make_adam(full.parameters(), opt_b.param_groups[0]['lr'])
    with torch.no_grad():
        for p, pb in zip(full.parameters(), state_b.params.parameters()):
            p.copy_(gather_leading_axis(pb, mesh, axis, n))
            st = opt_b.state.get(pb)
            if st:
                opt.state[p] = {
                    'step': st['step'].clone(),
                    'exp_avg': gather_leading_axis(st['exp_avg'], mesh, axis,
                                                   n),
                    'exp_avg_sq': gather_leading_axis(st['exp_avg_sq'], mesh,
                                                      axis, n)}
    return FitState(full, opt, state_b.step)


def init_batched_state(cfg, state0: FitState, n: int) -> FitState:
    """B copies of one image's initial state (batch.py:193-206: every
    image initialises from the same seed, so their inits are equal) with
    one Adam over the stack."""
    params = stack_modules([state0.params] * n)
    return FitState(params, make_adam(params.parameters(), cfg.lrate),
                    state0.step)


# ---- the batched loss and step -----------------------------------------

def normalize_coords_batched(coords: torch.Tensor,
                             res: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) pixel (y, x) to [-1, 1] by each image's dims (B, 2)."""
    return (coords / res[:, None, :] - 0.5) * 2.0


def embed_coords_batched(params: FitParams, emb_b, coords: torch.Tensor,
                         res: torch.Tensor) -> torch.Tensor:
    """The embedding of (B, N, 2) coordinates, warped first when the params
    carry a (stacked) warp field."""
    if params.warp is not None:
        coords = coords + params.warp(normalize_coords_batched(coords, res))
    return emb_b.embed(coords)


def build_batched_loss_fn(cfg, percep, contextual, patch_num: int,
                          patch_size: int, style=None,
                          task: TaskSpec = COMPLETION_TASK,
                          inject: Optional[Tuple[Sequence[torch.Tensor],
                                                 Sequence]] = None,
                          res: Optional[torch.Tensor] = None):
    """Returns loss_fn(params, emb_b, consts_b, gens) -> (loss, metrics):
    models/trainer.py::image_losses of the B images, each on its own
    batch, after one stacked MLP forward. inject: per-image (pixel
    indices, PatchBatch) lists used instead of drawing from `gens`. res:
    the images' tight dims (B, 2) for the warp field's normalisation."""
    n_rand = cfg.N_rand

    def loss_fn(params: FitParams, emb_b, consts_b: BatchedConsts, gens):
        dev = consts_b.pixel_img.device
        nb = consts_b.n
        if inject is not None:
            idx, batches = list(inject[0]), list(inject[1])
        else:
            batches, idx = [], []
            for j in range(nb):
                batch, pix = draw_batch(cfg, gens[j], consts_b.samplers[j],
                                        consts_b.pool_train_n[j], patch_num,
                                        patch_size)
                batches.append(batch)
                idx.append(pix)
        with span('npp.h2d'):
            pix_idx = torch.stack([to_device_async(p, dev) for p in idx])

        # ---- pixel batches (B, N_rand, .)
        bi = torch.arange(nb, device=dev)[:, None]
        pix_coords = consts_b.pool_train[bi, pix_idx]
        gt_rgb = consts_b.pixel_img[bi, pix_coords[..., 0], pix_coords[..., 1]]
        gt_mask = consts_b.pixel_mask[bi, pix_coords[..., 0],
                                      pix_coords[..., 1]]

        # ---- one stacked MLP forward over pixels + patch pixels
        fake = torch.stack([b.fake_coords.reshape(-1, 2) for b in batches])
        all_coords = torch.cat([pix_coords, fake], 1).to(torch.float32)
        with span('npp.embed'):
            emb = embed_coords_batched(params, emb_b, all_coords, res)
        with span('npp.mlp'):
            pred = render_activation(params.mlp(emb), cfg.normalize_type)
        return image_losses(
            cfg, params, pred[:, :n_rand], gt_rgb, gt_mask,
            pred[:, n_rand:].reshape(nb, patch_num, patch_size, patch_size,
                                     3),
            batches, percep, contextual, style, task, stacked=True)

    return loss_fn


def make_batched_fit_block(cfg, emb_b: StackedEmbedder,
                           consts_b: BatchedConsts, percep, contextual,
                           patch_num: int, patch_size: int, block: int,
                           style=None, task: TaskSpec = COMPLETION_TASK,
                           grid_hw: Optional[Tuple[int, int]] = None,
                           table: Optional[torch.dtype] = None):
    """run_block(state, gens) -> the last step's metrics after `block`
    batched steps, the multi-image make_fit_block (batch.py:123-170). With
    `table` (table_guard's dtype for the B tables) where uses_table allows
    one, the images' tables over the bucket canvas `grid_hw` are built
    once per block in one K1 launch."""
    loss_fn = build_batched_loss_fn(cfg, percep, contextual, patch_num,
                                    patch_size, style, task, res=emb_b.res)
    use_table = table is not None and grid_hw is not None and \
        uses_table(cfg, block)
    return block_runner(cfg, block, loss_fn, emb_b, consts_b,
                        (lambda: make_batched_table(emb_b, grid_hw, table))
                        if use_table else None)


def make_sharded_render(cfg, embedder, mesh: Mesh, pixels_axis: str = 'pixels',
                        chunk: int = RENDER_CHUNK):
    """render(params, h, w) -> (H, W, 3) with the coordinate axis split over
    `pixels_axis` (batch.py:209-237): the H*W coordinates padded to a
    multiple of (axis size x chunk), each rank renders its block chunk by
    chunk as models/trainer.py::make_render does, under
    cfg.matmul_precision, and the blocks are all-gathered and cropped. The
    blocks are whole chunks, so chunk boundaries fall where make_render's
    do; only a last partial chunk is rendered at full length here."""
    parts = mesh.shape[pixels_axis]

    @torch.no_grad()
    def render(params: FitParams, h: int, w: int) -> torch.Tensor:
        coords = canvas_coords(h, w, embedder.angles.device)
        n = coords.shape[0]
        per_rank = -(-n // (parts * chunk)) * chunk
        coords = torch.cat([coords, coords.new_zeros(
            (per_rank * parts - n, 2))])
        r = mesh.index(pixels_axis)
        with matmul_precision(cfg.matmul_precision):
            out = render_rows(cfg, params, embedder,
                              coords[r * per_rank:(r + 1) * per_rank], chunk)
        return gather_leading_axis(out, mesh, pixels_axis, n).reshape(h, w, 3)

    return render
