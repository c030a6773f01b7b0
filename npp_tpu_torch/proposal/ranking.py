"""Proposal ranking: fit a light NPP-Net per candidate periodicity and score
the held-out pseudo-mask region (reference: NPP_proposal/search.py:78-219),
a port of `npp_tpu/proposal/ranking.py`.

All candidates advance in lockstep, as in npp_tpu: one stacked model
(nn/mlp.py::NPPNetLight, weights (n_cand, in, out) run by torch.bmm),
every candidate starting from the same init and seeing the same pixel
batches (the reference reseeds per candidate, search.py:91-92). On the
card each step's activated layers go through K2 with a bias per candidate,
and the adaptive robust pixel loss of all candidates through one K4
forward and one K4 backward launch (losses/robust.py::stacked_nll_mean_sum).

npp_tpu pads the candidate axis (rank_pad_candidates) and the pixel pool
and chunk counts to fixed sizes so that its XLA executables are reused
across images; the values do not depend on the padding, and the one-image
ranking here does none.

`rank_proposals_suite` ranks a suite of images with one lockstep fit over
(images x candidates): the light model stacked over B * n_cand (K2 batched
over them, one K4 launch each way over 2,048 x 3 * B * n_cand), each
image drawing its own batches from a generator seeded as its one-image
ranking seeds its one, so each image's fit is its sequential one; then
each image's own eval (npp_tpu ranking.py:326-535). The one-image ranking
is its B = 1 case: both entries set up their inputs, then share the fit,
the eval, the gather and the pick (_rank_core).

Over a mesh (parallel/mesh.py), rank_proposals splits the candidates
over its 'candidates' axis and rank_proposals_suite the images over its
'images' axis (npp_tpu ranking.py:134-170, 326-370): each rank fits and
scores its block, and the score components are gathered to every rank
in order. The candidates and the images are independent (every
candidate starts from the same init and sees its image's draws, which
do not depend on how many candidates share them), so a sharded ranking
equals the unsharded one up to the rounding of stacked products.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import nerf_embed_dim, periodic_embed_dim
from ..device import (graph_home, matmul_precision, resolve_device,
                      to_device_async)
from ..kernels import add_launches, captured_launches
from ..losses.contextual import ContextualLoss
from ..losses.lpips import LPIPS
from ..losses.pixel import img2mse
from ..losses.robust import adaptive_init, stacked_nll_mean_sum
from ..models.trainer import make_adam, make_schedule
from ..nn.embedder import (fourier_encode, gaussian_freq_bands,
                           normalize_coords, periodic_warp)
from ..nn.mlp import NPPNetLight, render_activation
from ..parallel.mesh import (Mesh, gather_leading_axis, image_sharding,
                             mean_over_mesh)
from ..utils.debug import PhaseTimer, span

RENDER_CHUNK = 1 << 14
CX_GROUP_BYTES = 1 << 33   # the CX chain's (P, P) matrices per group
EAGER_STEPS = 4            # a card's fit steps run before the capture


def combine_scores(cfg, comps: dict) -> dict:
    """The per-candidate score components combined into one distance per
    ranking proxy (lower = better); a copy of npp_tpu's (ranking.py:36-64).

      'reference'   30*LPIPS + 1*CX on the zero-canvas bbox crop;
      'window'      the same on the held-out window composited into the
                    true image;
      'mse'         log10 of the held-out pixel MSE;
      'heldout_mse' reference + rank_pix_weight * log10(MSE).
    """
    pw, cw = cfg.perceptual_weight, cfg.contextual_weight
    d_ref = pw * comps['lpips_bbox'] + cw * comps['cx_bbox']
    d_win = pw * comps['lpips_comp'] + cw * comps['cx_comp']
    d_pix = np.log10(np.maximum(comps['val_mse'], 1e-8))
    w_pix = float(getattr(cfg, 'rank_pix_weight', 1.0))
    return {
        'reference': d_ref,
        'window': d_win,
        'mse': d_pix,
        'heldout_mse': d_ref + w_pix * d_pix,
    }


def pad_candidates(a, n: int):
    """a (numpy or torch) with its leading candidate axis padded to n by
    repeating candidate 0 (npp_tpu's padding; the padded scores are
    discarded)."""
    k = len(a)
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.repeat(a[:1], n - k, 0)], 0)
    return torch.cat([a, a[:1].expand((n - k,) + tuple(a.shape[1:]))], 0)


def _eval_inputs(cfg, i_val, norm_res):
    """The held-out region's crop (search.py:150-205): returns
    (crop_y0, crop_x0, crop_h, crop_w).

    The crop spans the val coords with exclusive ends (+1), at least 32 px
    (the deepest VGG taps), rounded up to a multiple of cfg.crop_bucket
    when set, and clamped to the tight image dims `norm_res`."""
    nh, nw = norm_res
    val = np.asarray(i_val, np.int64)
    hmin, hmax = int(val[:, 0].min()), int(val[:, 0].max()) + 1
    wmin, wmax = int(val[:, 1].min()), int(val[:, 1].max()) + 1
    bucket = int(getattr(cfg, 'crop_bucket', 0))

    def _bucketed(lo, hi, limit):
        size = max(hi - lo, 32)
        if bucket:
            size = -(-size // bucket) * bucket
        size = min(size, limit)
        hi = min(limit, lo + size)
        lo = max(0, hi - size)
        return lo, hi
    hmin, hmax = _bucketed(hmin, hmax, nh)
    wmin, wmax = _bucketed(wmin, wmax, nw)
    return hmin, wmin, hmax - hmin, wmax - wmin


class RankParams(nn.Module):
    """Everything the ranking's Adam trains, stacked over the candidates:
    the light MLP and the adaptive pixel-loss latents (n_cand, 1, 3)."""

    def __init__(self, mlp: NPPNetLight, n_cand: int):
        super().__init__()
        self.mlp = mlp
        self.adaptive_pix = adaptive_init(3, n_stack=n_cand)


def init_rank_params(cfg, n_cand: int, device: torch.device) -> RankParams:
    """One init (from a generator seeded cfg.seed) broadcast to every
    candidate (npp_tpu ranking.py:93-98)."""
    gen = torch.Generator().manual_seed(cfg.seed)
    mlp = NPPNetLight(
        n_cand, periodic_embed_dim(cfg, include_input=False),
        nerf_embed_dim(cfg, 2, include_input=True), gen,
        n_scales=len(cfg.freq_scales), n_offsets=len(cfg.freq_offsets),
        n_angle_offsets=len(cfg.angle_offsets), depth=cfg.netdepth,
        width=cfg.netwidth, activation=cfg.activation)
    return RankParams(mlp, n_cand).to(device)


class Lattices:
    """The candidates' lattices and the embedding constants, on one device:
    angles, periods (n_cand, 2), the Fourier bands and the tight dims that
    normalise the coordinates."""

    def __init__(self, cfg, angles, periods, bands, norm_res,
                 device: torch.device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.cfg, self.norm_res = cfg, (int(norm_res[0]), int(norm_res[1]))
        self.angles, self.periods, self.bands = t(angles), t(periods), t(bands)

    def render(self, params: RankParams, coords: torch.Tensor) -> torch.Tensor:
        """coords (M, 2) float (y, x) -> RGB (n_cand, M, 3)."""
        return render_lattices(params, [self], coords[None], self.angles[None],
                               self.periods[None])


def render_lattices(params: RankParams, lats: Sequence[Lattices],
                    coords: torch.Tensor, angles: torch.Tensor,
                    periods: torch.Tensor) -> torch.Tensor:
    """coords (B, M, 2), angles and periods (B, n_cand, 2) -> RGB
    (B * n_cand, M, 3), image-major: every image's positional encoding at
    its own tight dims, shared by its candidates, and each candidate's
    periodic warp."""
    cfg = lats[0].cfg
    nb, n_cand = angles.shape[:2]
    e_pos = [fourier_encode(normalize_coords(coords[j], lat.norm_res),
                            lat.bands, True) for j, lat in enumerate(lats)]
    e_pos = e_pos[0][None] if nb == 1 else torch.stack(e_pos)
    e_per = periodic_warp(coords[:, None], angles, periods, cfg.freq_scales,
                          cfg.freq_offsets, cfg.angle_offsets,
                          lats[0].norm_res, include_input=False)
    x_pos = e_pos[:, None].expand((nb, n_cand) + e_pos.shape[1:]).reshape(
        (nb * n_cand,) + e_pos.shape[1:])
    x_per = e_per.reshape((nb * n_cand,) + e_per.shape[2:])
    return render_activation(params.mlp(x_pos, x_per), cfg.normalize_type)


def lockstep_loss(params: RankParams, lats: Sequence[Lattices],
                  coords: torch.Tensor, gt: torch.Tensor,
                  angles: torch.Tensor, periods: torch.Tensor
                  ) -> torch.Tensor:
    """The sum over (images x candidates) of each candidate's pixel loss
    on its image's batch, coords (B, M, 2) and gt (B, M, 3) (its gradient
    is every candidate's own; npp_tpu ranking.py:118-125)."""
    cfg = lats[0].cfg
    with span('npp.mlp'):
        pred = render_lattices(params, lats, coords, angles, periods)
    with span('npp.loss.pixel'):
        gt = gt.repeat_interleave(angles.shape[1], 0)
        if cfg.loss_type == 'robust_loss_adaptive':
            return stacked_nll_mean_sum(pred - gt, params.adaptive_pix)
        return sum(img2mse(p, g, cfg.loss_type) for p, g in zip(pred, gt))


def rank_loss(params: RankParams, lat: Lattices, coords: torch.Tensor,
              gt: torch.Tensor) -> torch.Tensor:
    """lockstep_loss of one image: coords (M, 2), gt (M, 3)."""
    return lockstep_loss(params, [lat], coords[None], gt[None],
                         lat.angles[None], lat.periods[None])


def draw_indices(gen: torch.Generator, n_pool: int,
                 n_rand: int) -> torch.Tensor:
    """One step's pixel batch: n_rand indices into the training pool."""
    return torch.randint(0, n_pool, (n_rand,), generator=gen)


def draw_block(pools: Sequence[torch.Tensor], gens: Sequence[torch.Generator],
               n_rand: int, n_iters: int) -> torch.Tensor:
    """Every step's pixel batches at once, (n_iters, B, n_rand) on the host:
    draw_indices called step by step and, within a step, image by image,
    as the step loop calls it, so the values are the loop's."""
    return torch.stack([torch.stack([draw_indices(g, len(pool), n_rand)
                                     for pool, g in zip(pools, gens)])
                        for _ in range(n_iters)])


def fit_candidates(params: RankParams, lat: Lattices, img: torch.Tensor,
                   pool: torch.Tensor, gen: torch.Generator,
                   n_iters: int) -> torch.Tensor:
    """fit_candidates_suite of one image."""
    return fit_candidates_suite(params, [lat], img[None], [pool], [gen],
                                lat.angles[None], lat.periods[None], n_iters)


def _per_sample(fn, n: int, group: int):
    """fn(lo, hi) -> (hi - lo,) values, over [0, n) in groups."""
    return torch.cat([fn(lo, min(lo + group, n)) for lo in range(0, n, group)])


@torch.no_grad()
def eval_candidates(cfg, params: RankParams, lat: Lattices,
                    img: torch.Tensor, i_val: np.ndarray, crop,
                    percep: LPIPS, contextual: ContextualLoss,
                    stats: Optional[dict] = None) -> Dict[str, np.ndarray]:
    """Render every held-out pixel per candidate and compute the five score
    components per candidate (npp_tpu ranking.py:197-258), in full f32:
    LPIPS and CX on the bbox crop of the held-out pixels over a zero
    canvas, the same on that crop with the held-out pixels composited into
    the image, and the held-out pixel MSE. CX runs on groups of
    candidates, as many as keep its (P, P) matrices within CX_GROUP_BYTES.
    The render, LPIPS and CX are the PhaseTimer phases npp.search.eval.
    {render,lpips,cx}, each ending with the card's work; their walls go
    into stats ('eval_render_s', 'eval_lpips_s', 'eval_cx_s')."""
    dev = img.device
    h, w = img.shape[:2]
    y0, x0, ch, cw = crop
    val = torch.as_tensor(np.asarray(i_val), dtype=torch.long, device=dev)
    vy, vx = val[:, 0], val[:, 1]
    n_cand = lat.angles.shape[0]
    timer = PhaseTimer()

    def crop_of(x):
        return x[..., y0:y0 + ch, x0:x0 + cw, :]

    with timer.phase('npp.search.eval.render'):
        coords = val.to(torch.float32)
        out = torch.cat([lat.render(params, c) for c in
                         coords.split(RENDER_CHUNK)], dim=1)  # (B, Nv, 3)
        gt_vals = img[vy, vx]
        gt_canvas = torch.zeros((h, w, 3), device=dev)
        gt_canvas[vy, vx] = gt_vals
        in_val = torch.zeros((h, w, 1), device=dev)
        in_val[vy, vx] = 1.0
        pred = torch.zeros((n_cand, h, w, 3), device=dev)
        pred[:, vy, vx] = out
        pred_crop = crop_of(pred)
        gt_crop = crop_of(gt_canvas)[None].expand(n_cand, -1, -1, -1)
        ctx_crop = crop_of(img)[None].expand(n_cand, -1, -1, -1)
        in_crop = crop_of(in_val)
        comp_crop = ctx_crop * (1.0 - in_crop) + pred_crop * in_crop
        val_mse = torch.mean((out - gt_vals) ** 2, dim=(1, 2))
    with timer.phase('npp.search.eval.lpips'):
        lpips_bbox = percep(pred_crop, gt_crop).reshape(n_cand)
        lpips_comp = percep(comp_crop, ctx_crop).reshape(n_cand)
    with timer.phase('npp.search.eval.cx'):
        p = (ch // 4) * (cw // 4)
        group = max(1, min(n_cand, CX_GROUP_BYTES // (4 * 4 * p * p)))
        mask = in_crop[None].expand(n_cand, -1, -1, -1) \
            if getattr(cfg, 'cx_mask_pad', False) else None
        cx_bbox = _per_sample(lambda a, b: contextual(
            pred_crop[a:b], gt_crop[a:b], per_sample=True,
            spatial_mask=None if mask is None else mask[a:b]), n_cand, group)
        cx_comp = _per_sample(lambda a, b: contextual(
            comp_crop[a:b], ctx_crop[a:b], per_sample=True), n_cand, group)
    if stats is not None:
        stats.update({f'eval_{k}_s': timer.phases[f'npp.search.eval.{k}']
                      for k in ('render', 'lpips', 'cx')},
                     cx_positions=p, cx_group=group, crop=(ch, cw))
    comps = {'lpips_bbox': lpips_bbox, 'cx_bbox': cx_bbox,
             'lpips_comp': lpips_comp, 'cx_comp': cx_comp,
             'val_mse': val_mse}
    return {k: v.cpu().numpy().astype(np.float64) for k, v in comps.items()}


def rank_proposals(cfg, masked_img: np.ndarray, i_train: np.ndarray,
                   i_val: np.ndarray, all_angles, all_periods,
                   percep: LPIPS, contextual: ContextualLoss,
                   norm_res=None, return_components: bool = False,
                   params_override: Optional[dict] = None,
                   bands_override: Optional[Sequence[float]] = None,
                   device=None, stats: Optional[dict] = None,
                   mesh: Optional[Mesh] = None,
                   cand_axis: str = 'candidates'):
    """Distance per candidate (lower = better periodicity), as npp_tpu's
    rank_proposals. Runs on the card unless device='cpu' is passed.

    norm_res: the tight per-image dims that normalise the coordinates and
    clamp the crop (default: the canvas). return_components: also return
    the raw per-candidate score components (see combine_scores).
    params_override: a state_dict of RankParams' 'mlp' (utils/convert.py::
    params_from_jax of npp_tpu's stacked tree) to score without fitting;
    bands_override: the Fourier bands. stats: a dict to fill with the
    phases' walls ('fit_s', 'fit_ms_per_step', 'eval_s' and the eval's
    split) and the fit's per-step losses ('fit_losses').

    mesh: split the candidates over its `cand_axis` (padded to a multiple
    of the axis by repeating candidate 0, as npp_tpu pads): each rank
    fits and scores its block from the same init with the same pixel
    draws; the components are gathered to every rank in candidate order
    and the fit's losses averaged over the ranks."""
    device = resolve_device(device)
    h, w = masked_img.shape[:2]
    norm_res = norm_res if norm_res is not None else (h, w)
    n_real = len(all_angles)
    angles = np.asarray(all_angles, np.float32)
    periods = np.asarray(all_periods, np.float32)
    if mesh is not None:
        sh = image_sharding(mesh, cand_axis)
        n_pad, rows = sh.padded(n_real), sh.rows(n_real)
        angles = pad_candidates(angles, n_pad)[rows]
        periods = pad_candidates(periods, n_pad)[rows]
        if params_override is not None:
            params_override = {'mlp': {
                k: pad_candidates(v, n_pad)[rows]
                for k, v in params_override['mlp'].items()}}
    n_cand = len(angles)
    bands = bands_override if bands_override is not None else \
        gaussian_freq_bands(torch.Generator().manual_seed(cfg.seed),
                            cfg.multires)
    lat = Lattices(cfg, angles, periods, bands, norm_res, device)
    img = torch.as_tensor(np.asarray(masked_img), dtype=torch.float32,
                          device=device)
    params = init_rank_params(cfg, n_cand, device)
    pools = None
    if params_override is not None:
        params.mlp.load_state_dict(params_override['mlp'])
    else:
        pools = [torch.as_tensor(np.asarray(i_train), dtype=torch.long,
                                 device=device)]
    [(distances, comps)] = _rank_core(
        cfg, params, [lat], img[None], pools, [i_val], percep,
        contextual, stats, lambda ms, losses: (
            f'[search] fit: {cfg.N_iters} steps of {n_cand} candidates, '
            f'{ms:.2f} ms/step, loss {losses[0]:.4f} -> {losses[-1]:.4f}'),
        [n_real], mesh, (cand_axis, 1, n_real), eval_stats=stats)
    ref = combine_scores(cfg, comps)['reference']
    for c in range(n_real):
        print(f'[search] candidate {c + 1}/{n_real} '
              f'distance={distances[c]:.4f} '
              f'(ref={ref[c]:.4f} mse={comps["val_mse"][c]:.5f})')
    if return_components:
        return distances, comps
    return distances


def fit_candidates_suite(params: RankParams, lats: Sequence[Lattices],
                         imgs: torch.Tensor, pools: Sequence[torch.Tensor],
                         gens: Sequence[torch.Tensor], angles: torch.Tensor,
                         periods: torch.Tensor, n_iters: int) -> torch.Tensor:
    """The lockstep fit over (images x candidates) (npp_tpu ranking.py:
    171-195): each step image j draws N_rand indices of its pool from
    gens[j], as its one-image fit draws them, and one Adam step (b1 0.9,
    b2 0.999) at lrate * 0.1^(step / (lrate_decay * 100)) moves every
    candidate of every image, the forward and backward under
    cfg.matmul_precision. Returns the per-step loss, the mean over all the
    candidates, (n_iters,) on the device. Each step is a span npp.step
    (utils/debug.py) holding npp.draw (and in it npp.h2d, the draws' move
    to the pools' device, which the CPU makes without a copy) and
    _lockstep_step's spans. On a card the same steps run as one CUDA
    graph (_fit_on_card)."""
    if imgs.device.type == 'cuda':
        return _fit_on_card(params, lats, imgs, pools, gens, angles,
                            periods, n_iters)
    cfg = lats[0].cfg
    opt = make_adam(params.parameters(), cfg.lrate)
    schedule = make_schedule(cfg)
    nb, n_cand = angles.shape[:2]
    bi = torch.arange(nb, device=imgs.device)[:, None]
    losses = []
    with matmul_precision(cfg.matmul_precision):
        for step in range(n_iters):
            with span('npp.step', step):
                for group in opt.param_groups:
                    group['lr'] = schedule(step)
                with span('npp.draw'):
                    idx = [draw_indices(g, len(pool), cfg.N_rand)
                           for pool, g in zip(pools, gens)]
                    with span('npp.h2d'):
                        idx = [i.to(pool.device) for i, pool in
                               zip(idx, pools)]
                opt.zero_grad(set_to_none=True)
                loss = _lockstep_step(params, lats, imgs, bi, pools, idx,
                                      angles, periods, opt)
                losses.append(loss / (nb * n_cand))
    return torch.stack(losses)


def _lockstep_step(params: RankParams, lats: Sequence[Lattices],
                   imgs: torch.Tensor, bi: torch.Tensor,
                   pools: Sequence[torch.Tensor], idx, angles: torch.Tensor,
                   periods: torch.Tensor, opt: torch.optim.Optimizer
                   ) -> torch.Tensor:
    """One step of the lockstep fit on the gradients the caller zeroed:
    each image's batch gathered at its drawn pool indices idx[j],
    lockstep_loss (npp.mlp, npp.loss.pixel), npp.backward, npp.adam.
    bi is arange(B)[:, None] on the device. Returns the summed loss,
    detached."""
    pix = torch.stack([pool[i] for pool, i in zip(pools, idx)])
    gt = imgs[bi, pix[..., 0], pix[..., 1]]                    # (B, M, 3)
    loss = lockstep_loss(params, lats, pix.to(torch.float32), gt, angles,
                         periods)
    with span('npp.backward'):
        loss.backward()
    with span('npp.adam'):
        opt.step()
    return loss.detach()


def _fit_on_card(params: RankParams, lats: Sequence[Lattices],
                 imgs: torch.Tensor, pools: Sequence[torch.Tensor],
                 gens: Sequence[torch.Generator], angles: torch.Tensor,
                 periods: torch.Tensor, n_iters: int) -> torch.Tensor:
    """fit_candidates_suite on a card, its steps replayed from one CUDA
    graph so that the card, not the host's dispatch, sets their pace.

    Every step's draws (draw_block) and learning rate are made on the host
    first and copied in one non-blocking copy each (npp.draw > npp.h2d); a
    step counter on the card picks each step's from them. The first
    EAGER_STEPS steps run eagerly on the current stream: they build K2's
    Triton kernels and Adam's state, and whoever patches lockstep_loss
    sees real calls; their freed blocks stay with the current stream,
    where the eval reuses them. The next step is captured on the card's
    side stream into the pool its captures share (device.py::graph_home;
    npp.graph.capture), and it and every later step is a replay of that
    graph (npp.graph.replay, inside the step's npp.step), each adding the
    capture's launches to the kernels' counts. Adam is capturable, its
    learning rate a card tensor: the loop's f32 arithmetic, in another
    order. Nothing of the fit stays allocated into the eval: the graph and
    the gradients it allocated go back to the shared pool before it
    returns, and the cuBLAS workspaces are freed."""
    cfg = lats[0].cfg
    dev = imgs.device
    schedule = make_schedule(cfg)
    nb, n_cand = angles.shape[:2]
    with span('npp.draw'):
        draws = draw_block(pools, gens, cfg.N_rand, n_iters)
        lrs = torch.tensor([schedule(s) for s in range(n_iters)],
                           dtype=torch.float32)
        with span('npp.h2d'):
            draws, lrs = to_device_async(draws, dev), to_device_async(lrs, dev)
    bi = torch.arange(nb, device=dev)[:, None]
    t = torch.zeros(1, dtype=torch.long, device=dev)
    lr = torch.empty(1, device=dev)
    losses = torch.empty(n_iters, device=dev)
    opt = make_adam(params.parameters(), cfg.lrate, capturable=True)
    for group in opt.param_groups:   # not in the constructor: its check
        group['lr'] = lr             # of a card tensor would sync

    def step():
        lr.copy_(lrs.index_select(0, t))
        loss = _lockstep_step(params, lats, imgs, bi, pools,
                              draws.index_select(0, t)[0], angles, periods,
                              opt)
        losses.index_copy_(0, t, loss.reshape(1) / (nb * n_cand))
        t.add_(1)

    def capture():
        graph.capture_begin(pool=keeper.pool(),
                            capture_error_mode='thread_local')
        try:
            step()
        finally:
            graph.capture_end()

    stream, keeper = graph_home(dev)
    here = torch.cuda.current_stream(dev)
    graph = torch.cuda.CUDAGraph()
    with matmul_precision(cfg.matmul_precision):
        for i in range(n_iters):
            with span('npp.step', i):
                if i < EAGER_STEPS:
                    opt.zero_grad(set_to_none=True)
                    step()
                    continue
                with torch.cuda.stream(stream):
                    if i == EAGER_STEPS:
                        opt.zero_grad(set_to_none=True)
                        stream.wait_stream(here)
                        with span('npp.graph.capture'):
                            launched = captured_launches(capture)
                    with span('npp.graph.replay'):
                        graph.replay()
                        add_launches(launched)
    opt.zero_grad(set_to_none=True)
    del graph
    # cuBLAS keeps a workspace for each stream it ran on, the side stream's
    # allocated in the capture; PyTorch frees them only all at once, as its
    # own CUDA-graph trees do (torch/_inductor/cudagraph_trees.py). The
    # current stream's is allocated again at its next GEMM.
    torch._C._cuda_clearCublasWorkspaces()
    here.wait_stream(stream)
    return losses


def slice_rank_params(params: RankParams, j: int,
                      n_cand: int) -> RankParams:
    """Image j's candidates (rows j*n_cand .. (j+1)*n_cand) of a suite's
    stacked RankParams, as a RankParams of n_cand whose parameters are
    views of the stack's rows: nothing is drawn or copied."""
    rows = slice(j * n_cand, (j + 1) * n_cand)
    views = {id(p): nn.Parameter(p.detach()[rows], requires_grad=False)
             for p in params.parameters()}
    out = copy.deepcopy(params, views)
    out.mlp.n_cand = n_cand
    return out


def rank_proposals_suite(cfg, items, percep: LPIPS,
                         contextual: ContextualLoss, device=None,
                         stats: Optional[dict] = None,
                         mesh: Optional[Mesh] = None,
                         images_axis: str = 'images'):
    """Rank every image of a suite with one lockstep fit over (images x
    candidates), then score each image with its own eval_candidates
    (npp_tpu ranking.py:412::rank_proposals_suite). items: per image
    'masked_img' (H, W, 3) on one shared canvas, 'i_train', 'i_val',
    'all_angles', 'all_periods', 'norm_res' (its tight dims). Runs on the
    card unless device='cpu' is passed. Returns [(distances, comps)] in
    item order. stats: 'fit_s', 'fit_ms_per_step', 'eval_s' and the
    fit's per-step losses ('fit_losses').

    mesh: split the images over its `images_axis` (padded to a multiple
    of the axis by repeating the last image): each rank fits its block
    with each image's own generator and scores each of its images; the
    components are gathered to every rank in item order and the losses
    averaged over the ranks."""
    device = resolve_device(device)
    if not items:
        raise ValueError('rank_proposals_suite needs at least one item')
    h, w = items[0]['masked_img'].shape[:2]
    if any(it['masked_img'].shape[:2] != (h, w) for it in items):
        raise ValueError('suite ranking needs one shared canvas (pad first)')
    n_reals = [len(it['all_angles']) for it in items]
    n_cand = max(max(n_reals), int(getattr(cfg, 'rank_pad_candidates', 0)))
    n_img = len(items)
    if mesh is not None:
        sh = image_sharding(mesh, images_axis)
        items = (list(items) + [items[-1]] * (sh.padded(n_img) - n_img))[
            sh.rows(n_img)]
    nb = len(items)
    bands = gaussian_freq_bands(torch.Generator().manual_seed(cfg.seed),
                                cfg.multires)

    def padded(a):   # pad by repeating candidate 0 (discarded)
        return pad_candidates(np.asarray(a, np.float32), n_cand)

    lats = [Lattices(cfg, padded(it['all_angles']), padded(it['all_periods']),
                     bands, it['norm_res'], device) for it in items]
    imgs = torch.stack([torch.as_tensor(np.asarray(it['masked_img']),
                                        dtype=torch.float32, device=device)
                        for it in items])
    pools = [torch.as_tensor(np.asarray(it['i_train']), dtype=torch.long,
                             device=device) for it in items]
    params = init_rank_params(cfg, nb * n_cand, device)
    return _rank_core(
        cfg, params, lats, imgs, pools, [it['i_val'] for it in items],
        percep, contextual, stats,
        lambda ms, losses: (
            f'[search-suite] fit: {cfg.N_iters} steps of {nb} x {n_cand} '
            f'candidates, {ms:.2f} ms/step'),
        n_reals, mesh, (images_axis, 0, n_img))


def _rank_core(cfg, params: RankParams, lats: Sequence[Lattices],
               imgs: torch.Tensor, pools, i_vals, percep: LPIPS,
               contextual: ContextualLoss, stats: Optional[dict], fit_line,
               n_reals: Sequence[int], mesh: Optional[Mesh],
               split: Tuple[str, int, int],
               eval_stats: Optional[dict] = None) -> list:
    """What both rank entries do after their set-up, in full f32: the
    synced fit phase (none without pools: params_override), each image
    drawing from a generator seeded cfg.seed + 1, into stats and
    the printed fit_line(ms per step, losses), each image's eval into
    eval_stats, the components gathered over the mesh along split = (its
    axis, the split dimension of (images, candidates), that dimension's
    unpadded length), and each image's distances under cfg.rank_proxy.
    Returns [(distances, comps)], image j's cut to n_reals[j] candidates."""
    dev = imgs.device
    nb, n_cand = len(lats), lats[0].angles.shape[0]
    stats = {} if stats is None else stats
    timer = PhaseTimer()

    def stacked(ts):   # one image's as a view, as its fit always took it
        return ts[0][None] if nb == 1 else torch.stack(ts)

    with matmul_precision('float32'):    # the fit sets its own
        if pools is not None:
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
            with timer.phase('npp.search.rank_fit'):
                losses = fit_candidates_suite(
                    params, lats, imgs, pools,
                    [torch.Generator().manual_seed(cfg.seed + 1)
                     for _ in lats],
                    stacked([lat.angles for lat in lats]),
                    stacked([lat.periods for lat in lats]), cfg.N_iters)
                if mesh is not None:
                    losses = mean_over_mesh(losses, mesh)
                losses = losses.cpu().numpy()
            fit_s = timer.phases['npp.search.rank_fit']
            stats.update(fit_s=fit_s, fit_losses=losses,
                         fit_ms_per_step=1e3 * fit_s / max(cfg.N_iters, 1))
            print(fit_line(stats['fit_ms_per_step'], losses), flush=True)
        with timer.phase('npp.search.rank_eval'):
            comps = [eval_candidates(
                cfg, params if nb == 1 else slice_rank_params(params, j,
                                                              n_cand),
                lat, imgs[j], i_val, _eval_inputs(cfg, i_val, lat.norm_res),
                percep, contextual, eval_stats)
                for j, (lat, i_val) in enumerate(zip(lats, i_vals))]
        stats['eval_s'] = timer.phases['npp.search.rank_eval']
    comps = {k: np.stack([c[k] for c in comps]) for k in comps[0]}
    if mesh is not None:
        axis, dim, n = split
        comps = gather_leading_axis(
            {k: torch.as_tensor(v, device=dev).movedim(dim, 0)
             for k, v in comps.items()}, mesh, axis, n)
        comps = {k: v.movedim(0, dim).cpu().numpy() for k, v in comps.items()}
    out = []
    for j, n_real in enumerate(n_reals):
        cj = {k: v[j, :n_real] for k, v in comps.items()}
        scores = combine_scores(cfg, cj)
        out.append((np.asarray(scores[getattr(cfg, 'rank_proxy',
                                              'reference')]), cj))
    return out
