"""The plain reference of the first steps of a fit, from the benchmark's
inputs alone: the pixel pools, the periodicity-guided patch sampler and
its draws, the embedding's bands, the MLP's initial weights, the blur map
and clear mask of remapping, the losses, the backward pass and Adam.

It works out again everything the port derives from the inputs. Its
random draws come from CPU generators seeded as the port's fit seeds its
own (the bands and the MLP from the fit's seed, the batches from the seed
plus one), drawn in the same order, so that both sides see the same
batches; the rest is arithmetic on those draws.

`reference_steps` returns, per image, each step's loss, each leaf's
first gradient (from Adam's first moment after one step, as the program's
is read) and each leaf's change after the last step followed.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import scipy.ndimage as ndimage
import torch

from . import model as M

SOURCE_VAL, SOURCE_TRAIN, SOURCE_SAME = 0, 1, 2
MAX_SHIFT_IDX = 10
SELF_DISTANCE = 1e4


# ---- pools and the sampler -------------------------------------------------


def pad_pool_pow2(pool: np.ndarray, fallback_row):
    """(N, 2) coordinates padded to a power of two by repeating the first
    row; the true count bounds the draws (an empty pool: one fallback row,
    count 0)."""
    pool = np.asarray(pool)
    n = len(pool)
    if n == 0:
        return np.asarray(fallback_row, np.int64).reshape(1, 2), 0
    target = int(2 ** np.ceil(np.log2(n)))
    if target > n:
        pool = np.concatenate([pool, np.repeat(pool[:1], target - n, 0)])
    return pool.astype(np.int64), n


@dataclass
class Sampler:
    img: torch.Tensor
    mask: torch.Tensor
    known_sat: torch.Tensor
    pool_train: torch.Tensor
    n_train: int
    pool_val: torch.Tensor
    n_val: int
    shift1: torch.Tensor
    shift2: torch.Tensor


def make_sampler(img, mask2d, i_train, i_val, shifts, patch_size, device):
    """The sampler's constants: centroids whose patch stays inside the
    image, the known-area table, the top-1 lattice's two vectors (y, x)."""
    h, w = img.shape[:2]
    half = patch_size // 2

    def inside(pool):
        pool = np.asarray(pool)
        ok = ((pool[:, 0] > half) & (pool[:, 0] < h - (half + 1)) &
              (pool[:, 1] > half) & (pool[:, 1] < w - (half + 1)))
        return pool[ok]

    pt, nt = pad_pool_pow2(inside(i_train), (h // 2, w // 2))
    pv, nv = pad_pool_pow2(inside(i_val), (h // 2, w // 2))
    s = np.asarray(shifts, np.float32).reshape(-1, 2, 2)[0]
    mask_t = torch.as_tensor(np.asarray(mask2d, np.float32), device=device)
    known = (mask_t >= 0.5).to(torch.float32)
    sat = torch.nn.functional.pad(torch.cumsum(torch.cumsum(known, 0), 1),
                                  (1, 0, 1, 0))

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Sampler(img=dev(np.asarray(img, np.float32)[..., :3]), mask=mask_t,
                   known_sat=sat, pool_train=dev(pt, torch.long),
                   n_train=max(nt, 1), pool_val=dev(pv, torch.long),
                   n_val=max(nv, 1), shift1=dev([s[0][1], s[0][0]]),
                   shift2=dev([s[1][1], s[1][0]]))


def grid(cents: torch.Tensor, size: int) -> torch.Tensor:
    offs = torch.arange(size, dtype=cents.dtype, device=cents.device) \
        - size // 2
    gy = cents[..., None, None, 0] + offs[:, None]
    gx = cents[..., None, None, 1] + offs[None, :]
    shape = gy.shape[:-2] + (size, size)
    return torch.stack([gy.expand(shape), gx.expand(shape)], -1)


def patches(img: torch.Tensor, cents: torch.Tensor, size: int):
    """(..., S, S, C) windows around integer centres, zeros outside."""
    h, w = img.shape[:2]
    g = grid(cents.long(), size)
    gy, gx = g[..., 0], g[..., 1]
    inb = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    return img[gy.clamp(0, h - 1), gx.clamp(0, w - 1)] * \
        inb[..., None].to(img.dtype)


def window_known(sat: torch.Tensor, cents: torch.Tensor, size: int):
    h, w = sat.shape[0] - 1, sat.shape[1] - 1
    c = cents.long()
    y0 = (c[..., 0] - size // 2).clamp(0, h)
    y1 = (c[..., 0] - size // 2 + size).clamp(0, h)
    x0 = (c[..., 1] - size // 2).clamp(0, w)
    x1 = (c[..., 1] - size // 2 + size).clamp(0, w)
    return sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]


@dataclass
class Batch:
    fake_coords: torch.Tensor
    fake_rgb: torch.Tensor
    fake_mask: torch.Tensor
    real_rgb: torch.Tensor
    real_mask: torch.Tensor
    valid: torch.Tensor
    source: int


def draw(gen: torch.Generator, sp: Sampler, patch_num: int, size: int,
         topk: int, invalid_ratio: float) -> Batch:
    """One step's patches: the branch (val 0.5, train 0.3, same 0.2), the
    fake centroids, and for val / train the top-k real patches along the
    top-1 lattice by L1 lattice distance (ties to the lower index),
    among candidates inside the image with at most `invalid_ratio`
    unknown pixels; for 'same' the fake patch itself, one valid slot."""
    u = float(torch.rand((), generator=gen))
    source = SOURCE_VAL if u < 0.5 else (SOURCE_TRAIN if u < 0.8
                                         else SOURCE_SAME)
    dev = sp.img.device
    pool, n = (sp.pool_val, sp.n_val) if source == SOURCE_VAL \
        else (sp.pool_train, sp.n_train)
    cents = pool[torch.randint(0, n, (patch_num,), generator=gen).to(dev)]
    coords = grid(cents, size)
    rgb = patches(sp.img, cents, size)
    msk = patches(sp.mask[..., None], cents, size)
    if source == SOURCE_SAME:
        valid = (torch.arange(topk, device=dev)[None] < 1).expand(
            patch_num, topk)
        return Batch(coords, rgb, msk,
                     rgb[:, None].expand((patch_num, topk) + rgb.shape[1:]),
                     msk[:, None].expand((patch_num, topk) + msk.shape[1:]),
                     valid, source)
    h, w = sp.img.shape[:2]
    r = torch.arange(-MAX_SHIFT_IDX, MAX_SHIFT_IDX, device=dev)
    ii, jj = torch.meshgrid(r, r, indexing='ij')
    ii = ii.reshape(-1).to(torch.float32)
    jj = jj.reshape(-1).to(torch.float32)
    offsets = ii[:, None] * sp.shift1 + jj[:, None] * sp.shift2
    cand = (cents[:, None, :].to(torch.float32) + offsets).to(torch.long)
    in_bounds = ((cand[..., 0] > 0) & (cand[..., 0] < h - 1) &
                 (cand[..., 1] > 0) & (cand[..., 1] < w - 1))
    n_known = window_known(sp.known_sat, cand, size)
    ok = size * size - n_known <= size * size * invalid_ratio
    dist = torch.abs(ii) + torch.abs(jj)
    dist = torch.where(dist == 0, torch.full_like(dist, SELF_DISTANCE), dist)
    dist = torch.where(in_bounds & ok, dist.expand(cand.shape[:2]),
                       torch.full_like(n_known, float('inf')))
    top, idx = torch.sort(dist, dim=1, stable=True)
    top, idx = top[:, :topk], idx[:, :topk]
    sel = torch.gather(cand, 1, idx[..., None].expand(-1, -1, 2))
    return Batch(coords, rgb, msk, patches(sp.img, sel, size),
                 patches(sp.mask[..., None], sel, size), torch.isfinite(top),
                 source)


# ---- the blur map of remapping ---------------------------------------------

GRAY = (9798, 19235, 3735, 15)   # OpenCV's fixed-point RGB2GRAY


def clear_mask(img: np.ndarray, thresh: float, device,
               win_size: int = 10, sv_num: int = 3,
               chunk: int = 1 << 14) -> np.ndarray:
    """(H, W) clear mask in {0, 1} of the reference's blur detection
    (NPP_remapping/blur_detection.py): each pixel's 20x20 window of the
    8-bit gray image (edges mirrored), the share of its top 3 singular
    values (from the eigenvalues of the window's Gram, f32, in batches of
    `chunk` windows), normalised, above the `thresh`-th percentile,
    eroded 20 and dilated 40 times; the mask is the rest."""
    u8 = np.uint8(img * 255).astype(np.int32)
    r, g, b, shift = GRAY
    gray = ((u8[..., 0] * r + u8[..., 1] * g + u8[..., 2] * b +
             (1 << (shift - 1))) >> shift).astype(np.float64)
    h, w = gray.shape
    i = np.arange(h + 2 * win_size)
    p = np.where(i < win_size, win_size - i,
                 np.where(i > h + win_size - 1, 2 * h - i, i - win_size))
    j = np.arange(w + 2 * win_size)
    q = np.where(j < win_size, win_size - j,
                 np.where(j > w + win_size - 1, 2 * w - j, j - win_size))
    padded = gray[np.clip(p, 0, h - 1)][:, np.clip(q, 0, w - 1)]
    win = 2 * win_size
    pt = torch.as_tensor(padded, dtype=torch.float32, device=device)
    windows = pt.unfold(0, win, 1).unfold(1, win, 1)[:h, :w]
    rows = max(1, chunk // w)
    out = []
    for r0 in range(0, h, rows):
        wnd = windows[r0:r0 + rows].reshape(-1, win, win)
        gram = torch.bmm(wnd.transpose(1, 2), wnd)
        s = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(gram), min=0.0))
        out.append(torch.sum(s[:, -sv_num:], 1) / (torch.sum(s, 1) + 1e-6))
    degree = torch.cat(out).reshape(h, w).cpu().numpy()
    degree = (degree - degree.min()) / (degree.max() - degree.min())
    binary = degree > np.percentile(degree, thresh)
    binary = ndimage.binary_erosion(binary, iterations=20)
    binary = ndimage.binary_dilation(binary, iterations=40)
    return (~binary).astype(np.float64)


# ---- the task's arrays, as the fit reads them ------------------------------


@dataclass
class Task:
    pixel_img: np.ndarray      # (H, W, 3) the pixel loss's target
    pixel_mask: np.ndarray     # (H, W, 1) its weights
    sampler_img: np.ndarray
    sampler_mask: np.ndarray   # (H, W)
    i_train: np.ndarray
    i_val: np.ndarray
    shifts: list
    angles: list
    periods: list
    patch_size: int


def patch_size_from_periods(periods) -> int:
    m = max(periods[0])
    return int(np.clip(m + (32 - m % 32), 64, 160))


def task_of(kind: str, arrays: dict, cfg: dict, device) -> Task:
    """Completion fits the masked image where it is known (unit pixel
    weights); remapping fits the whole image, weighted by the clear mask
    of its blur map, and samples where that mask is set."""
    k = cfg['p_topk']
    if kind == 'completion':
        known = (arrays['mask'] * arrays['valid_mask'])[..., 0]
        return Task(arrays['masked_img'], np.ones_like(arrays['mask']),
                    arrays['masked_img'], known, arrays['i_train'],
                    arrays['i_val'], arrays['selected_shifts'][:k],
                    arrays['selected_angles'][:k],
                    arrays['selected_periods'][:k], arrays['patch_size'])
    img = np.asarray(arrays['gt_img'], np.float64)
    valid = np.asarray(arrays['valid_mask'], np.float64)
    clear = clear_mask(img, cfg['blur_thresh'], device)[..., None] * valid
    periods = arrays['selected_periods'][:k]
    return Task(img, clear, img, clear[..., 0],
                np.stack(np.nonzero(valid[..., 0]), 1),
                np.stack(np.nonzero((clear * valid)[..., 0]), 1),
                arrays['selected_shifts'][:k], arrays['selected_angles'][:k],
                periods, patch_size_from_periods(periods))


# ---- the steps ---------------------------------------------------------------


class Params(torch.nn.Module):
    """The trained leaves, named as the port's FitParams names them."""

    def __init__(self, mlp, n_pix, percep_chns, style_chns):
        super().__init__()
        self.mlp = mlp
        self.adaptive_pix = M.Latents(n_pix)
        self.adaptive_percep = None if percep_chns is None else \
            torch.nn.ModuleList(M.Latents(c) for c in percep_chns)
        self.adaptive_style = None if style_chns is None else \
            torch.nn.ModuleList(M.Latents(c * c) for c in style_chns)


@dataclass
class Readings:
    """One image's reference readings."""
    losses: List[float]
    sources: List[int]
    first_grad: Dict[str, float]     # leaf -> norm of its first gradient
    grad_max: Dict[str, float]       # leaf -> largest gradient norm seen
    change: Dict[str, float]         # leaf -> norm of its change
    terms: List[Dict[str, float]]    # each step's loss terms, unweighted
    pred: torch.Tensor               # step 1's MLP output (N, 3), host
    cx_feats: Optional[tuple] = None  # step 1's CX (xn, yn), host


def init_params(cfg: dict, task: Task, device, use_style: bool) -> Params:
    """The MLP's nn.Linear layers under the global seed cfg['seed'] (the
    RNG state outside is kept), the latents at zero."""
    p_dim = 2 + len(cfg['freq_scales']) * len(cfg['freq_offsets']) * \
        len(cfg['angle_offsets']) * 4
    d_top1 = p_dim * (1 + 2 * cfg['multires'])
    k = len(task.angles)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg['seed'])
        mlp = M.NPPNet(d_top1, (k - 1) * d_top1, cfg['netdepth'],
                       cfg['netwidth'])
    percep = (64, 128, 256, 512, 512) if cfg['use_perceptual_loss'] else None
    styl = (64, 128, 256) if use_style else None
    return Params(mlp, 3, percep, styl).to(device)


def reference_steps(kind: str, arrays: dict, cfg: dict, weights: dict,
                    n_steps: int, device, control: bool = False,
                    fault: Optional[str] = None) -> Readings:
    """Follow the first `n_steps` steps of the fit of one image.

    control: compute in bf16 (autocast) instead of f32, the precision
    below the configuration's TF32. Planted faults, to read what they do
    to the compared numbers: fault='half_batch' leaves out half of the
    pixel rows and of the patches, the means taken over the rest;
    fault='frozen' is a step that returns its state unchanged."""
    use_style = kind == 'remapping' and cfg.get('use_style_loss', False)
    task = task_of(kind, arrays, cfg, device)
    h, w = task.pixel_img.shape[:2]
    res = (h, w)
    bands_gen = torch.Generator().manual_seed(cfg['seed'])
    bands = (torch.randn((cfg['multires'],), generator=bands_gen) * 10.0
             ).to(device)
    angles = torch.as_tensor(np.asarray(task.angles, np.float32)
                             ).reshape(-1, 2).to(device)
    periods = torch.as_tensor(np.asarray(task.periods, np.float32)
                              ).reshape(-1, 2).to(device)
    params = init_params(cfg, task, device, use_style)
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = torch.optim.Adam(params.parameters(), lr=cfg['lrate'],
                           betas=(0.9, 0.999), eps=1e-8)
    size, patch_num = task.patch_size, cfg['patch_num']
    topk = cfg['num_real_patch_per_sample']
    sp = make_sampler(task.sampler_img, task.sampler_mask, task.i_train,
                      task.i_val, task.shifts, size, device)
    pool, n_pool = pad_pool_pow2(task.i_train, (0, 0))
    pool = torch.as_tensor(pool, device=device)
    n_pool = max(n_pool, 1)
    pix_img = torch.as_tensor(task.pixel_img, dtype=torch.float32,
                              device=device)
    pix_mask = torch.as_tensor(task.pixel_mask, dtype=torch.float32,
                               device=device)
    gen = torch.Generator().manual_seed(cfg['seed'] + 1)
    n_rand = cfg['N_rand']
    pk = patch_num * topk
    losses, sources, terms, pred, cx_feats = [], [], [], None, []
    first_grad: Dict[str, float] = {}
    grad_max: Dict[str, float] = {n: 0.0 for n in start}
    ctx = (lambda: torch.autocast(torch.device(device).type,
                                  dtype=torch.bfloat16)) if control \
        else contextlib.nullcontext
    for step in range(n_steps):
        for g in opt.param_groups:
            g['lr'] = cfg['lrate'] * 0.1 ** (step / (cfg['lrate_decay'] * 100.0))
        opt.zero_grad(set_to_none=True)
        batch = draw(gen, sp, patch_num, size, topk, cfg['invalid_ratio'])
        idx = torch.randint(0, n_pool, (n_rand,), generator=gen).to(device)
        sources.append(batch.source)
        coords = pool[idx]
        if fault == 'half_batch':
            coords = coords[:n_rand // 2]
        with ctx():
            loss, parts, raw = step_loss(
                cfg, params, coords, batch, pix_img, pix_mask, bands, angles,
                periods, res, size, patch_num, topk, pk, use_style, weights,
                fault, cx_feats if step == 0 else None)
        loss.backward()
        for n, p in params.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grad_max[n] = max(grad_max[n], float(p.grad.norm()))
        if fault != 'frozen':
            opt.step()
        losses.append(float(loss.detach()))
        terms.append({k: float(v.detach()) for k, v in parts.items()})
        if step == 0:
            pred = raw.detach().float().cpu()
            first_grad = {n: float(opt.state[p]['exp_avg'].norm()) / 0.1
                          if p in opt.state else 0.0
                          for n, p in params.named_parameters()}
    change = {n: float((p.detach() - start[n]).norm())
              for n, p in params.named_parameters()}
    return Readings(losses, sources, first_grad, grad_max, change, terms,
                    pred, tuple(t.float().cpu() for t in cx_feats[0])
                    if cx_feats else None)


def step_loss(cfg, params, coords, batch: Batch, pix_img, pix_mask, bands,
              angles, periods, res, size, patch_num, topk, pk, use_style,
              weights, fault, cx_capture=None):
    n_pix = coords.shape[0]
    if fault == 'half_batch':
        keep = max(patch_num // 2, 1)
        batch = Batch(batch.fake_coords[:keep], batch.fake_rgb[:keep],
                      batch.fake_mask[:keep], batch.real_rgb[:keep],
                      batch.real_mask[:keep], batch.valid[:keep],
                      batch.source)
        patch_num, pk = keep, keep * topk
    gt = pix_img[coords[:, 0], coords[:, 1]]
    gt_mask = pix_mask[coords[:, 0], coords[:, 1]]
    all_coords = torch.cat([coords, batch.fake_coords.reshape(-1, 2)], 0)
    x = M.embed(all_coords.to(torch.float32), angles, periods, bands, cfg, res)
    raw = params.mlp(x)
    pred = torch.sigmoid(raw.float())
    loss = M.pixel_loss(pred[:n_pix], gt, gt_mask, params.adaptive_pix,
                        cfg['adaptive_scale_lo'])
    parts = {'pixel': loss}

    def per_slot(t):
        return t[:, None].expand((patch_num, topk) + t.shape[1:]).reshape(
            (pk,) + t.shape[1:])

    pred_t = per_slot(pred[n_pix:].reshape(patch_num, size, size, 3))
    real_rgb = batch.real_rgb.reshape(pk, size, size, 3)
    real_mask = batch.real_mask.reshape(pk, size, size, 1)
    fake_rgb, fake_mask = per_slot(batch.fake_rgb), per_slot(batch.fake_mask)
    valid = batch.valid.reshape(pk)
    cx_pred = pred_t
    if cfg['use_comp'] and batch.source == SOURCE_VAL:
        cx_pred = fake_rgb * fake_mask + pred_t * (1.0 - fake_mask)
    if cfg['use_contextual_loss']:
        parts['contextual'] = M.contextual(cx_pred * real_mask,
                                           real_rgb * real_mask, valid,
                                           weights['vgg19'],
                                           capture=cx_capture)
        loss = loss + parts['contextual'] * cfg['contextual_weight']
    if cfg['use_perceptual_loss']:
        parts['perceptual'] = torch.zeros((), device=loss.device)
        if batch.source == SOURCE_SAME:
            per = M.lpips_robust(pred_t * real_mask, fake_rgb * real_mask,
                                 params.adaptive_percep, weights['vgg16'])
            v = valid.to(per.dtype)
            parts['perceptual'] = torch.sum(per * v) / \
                torch.clamp(torch.sum(v), min=1.0)
            loss = loss + parts['perceptual'] * cfg['perceptual_weight']
    if use_style:
        parts['style'] = M.style(cx_pred * real_mask, real_rgb * real_mask,
                                 valid, params.adaptive_style,
                                 weights['vgg16'])
        loss = loss + parts['style'] * cfg['style_weight']
    return loss, parts, raw


# ---- K3's stage, from the program's own inputs -----------------------------


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's ten mantissa bits, to nearest with
    ties away from zero (PTX cvt.rna.tf32.f32)."""
    b = t.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def cx_stage(xn: torch.Tensor, yn: torch.Tensor, dz: torch.Tensor,
             band_width: float, device, control: bool = False,
             tf32_inputs: bool = False) -> dict:
    """The chain of CX from its normalised features to the per-target
    column max (model.cx_colmax) on the xn, yn (N, P, C) that the program
    handed its kernel: its z (N, Q) and the gradient dx (N, P, C) in xn
    for the upstream gradient dz (N, Q) it handed back. In float64, or
    for the control in f32 with the product under bf16 autocast.
    tf32_inputs: xn and yn rounded to TF32 first (what the chain's answer
    moves by when only its inputs are rounded as a TF32 product rounds
    them)."""
    dtype = torch.float32 if control else torch.float64
    if tf32_inputs:
        xn, yn = tf32_round(xn), tf32_round(yn)
    x = xn.to(device, dtype, copy=True).requires_grad_(True)
    y, g = yn.to(device, dtype), dz.to(device, dtype)
    ctx = torch.autocast(torch.device(device).type, dtype=torch.bfloat16) \
        if control else contextlib.nullcontext()
    with ctx:
        z = M.cx_colmax(x, y, band_width)
    (dx,) = torch.autograd.grad(z, x, g.to(z.dtype))
    return {'z': z.detach().double().cpu(), 'dx': dx.detach().double().cpu()}
