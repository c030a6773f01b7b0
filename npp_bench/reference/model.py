"""The plain reference of one NPP-Net fit step, in plain PyTorch: the
embedding, the MLP, the adaptive robust losses, the VGG towers, CX, LPIPS
and the style loss. It imports nothing of the port and uses no kernel: it
follows the published method (the reference repository's
NPP_completion/train.py and NPP_remapping/train.py, the robust loss of
Barron, arXiv:1701.03077, the contextual loss of Mechrez et al.,
arXiv:1803.02077, LPIPS of Zhang et al., arXiv:1801.03924) as the port's
plain versions write it down, so that the same inputs give the same
values up to rounding.

Everything runs in the dtype of its inputs; `fit.py` runs it in f32 with
TF32 off, and under bf16 autocast for the control.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

HERE = os.path.dirname(os.path.abspath(__file__))
F32_EPS = float(np.finfo(np.float32).eps)

# ---- the embedding (periodic warp of each lattice, Fourier re-encoded) --


def fourier_encode(x: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """[x, sin(b1 x), cos(b1 x), sin(b2 x), ...], each block over all of
    x's channels."""
    xf = x[..., None, :] * bands[:, None]
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    return torch.cat([x, sc.reshape(*x.shape[:-1], -1)], dim=-1)


def periodic_warp(coords: torch.Tensor, angles: torch.Tensor,
                  periods: torch.Tensor, scales, offsets, angle_offsets,
                  res: Tuple[int, int]) -> torch.Tensor:
    """Eq. 1 of the NPP-Net paper: [x/w, fns of orientation 0, y/h, fns of
    orientation 1], each fn sin / cos(2 pi ((y cos th + x sin th) mod f) /
    f), f = (period + o) * s, th = angle + a, the modulo floored."""
    h, w = res
    y, x = coords[..., 0:1], coords[..., 1:2]

    def orient(idx):
        chans = []
        for s in scales:
            for o in offsets:
                for a in angle_offsets:
                    f = (periods[idx] + o) * s
                    th = torch.deg2rad(angles[idx] + a)
                    proj = y * torch.cos(th) + x * torch.sin(th)
                    phase = (proj - f * torch.floor(proj / f)) / f * (2 * np.pi)
                    chans += [torch.sin(phase), torch.cos(phase)]
        return torch.cat(chans, -1)

    return torch.cat([(x / w - 0.5) * 2.0, orient(0), (y / h - 0.5) * 2.0,
                      orient(1)], -1)


def embed(coords, angles, periods, bands, cfg, res) -> torch.Tensor:
    """(N, 2) pixel coordinates -> (N, K * D), lattice-major."""
    return torch.cat([
        fourier_encode(periodic_warp(coords, angles[k], periods[k],
                                     cfg['freq_scales'], cfg['freq_offsets'],
                                     cfg['angle_offsets'], res), bands)
        for k in range(angles.shape[0])], -1)


# ---- the MLP -------------------------------------------------------------


def snake(x: torch.Tensor) -> torch.Tensor:
    return x + torch.square(torch.sin(x))


class NPPNet(nn.Module):
    """NPP-Net (the reference's models/networks.py): a periodic trunk of
    `depth` snake layers with the input concatenated after layer 4, the
    feature, the aux lattices' scale branch, the position head and rgb.
    Layers are created in the order the port creates them, so that the
    same global seed gives the same nn.Linear draws."""

    def __init__(self, d_top1: int, d_aux: int, depth: int, width: int,
                 skips=(4,)):
        super().__init__()
        self.d_top1, self.depth, self.skips = d_top1, depth, tuple(skips)
        d_in = d_top1
        for i in range(depth):
            setattr(self, f'periodic_{i}', nn.Linear(d_in, width))
            d_in = width + (d_top1 if i in self.skips else 0)
        self.feature1 = nn.Linear(d_in, width)
        self.scale_0 = nn.Linear(width + d_aux, width)
        self.feature2 = nn.Linear(width, width)
        self.pos_0 = nn.Linear(2 * width, width // 2)
        self.rgb = nn.Linear(width // 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp, aux = x[..., :self.d_top1], x[..., self.d_top1:]
        h = inp
        for i in range(self.depth):
            h = snake(getattr(self, f'periodic_{i}')(h))
            if i in self.skips:
                h = torch.cat([inp, h], -1)
        f1 = self.feature1(h)
        h = snake(self.scale_0(torch.cat([f1, aux], -1)))
        f2 = self.feature2(h)
        h = snake(self.pos_0(torch.cat([f1, f2], -1)))
        return self.rgb(h)


# ---- the adaptive robust loss --------------------------------------------


@functools.lru_cache(maxsize=1)
def _spline():
    with np.load(os.path.join(HERE, 'partition_spline.npz')) as f:
        return (float(f['x_scale']), np.asarray(f['values'], np.float32),
                np.asarray(f['tangents'], np.float32))


def log_partition(alpha: torch.Tensor) -> torch.Tensor:
    """log Z(alpha) from the robust loss's published cubic spline
    (robust_loss_pytorch's distribution.py and cubic_spline.py), in the
    order of operations of the spline's own code, in float64: its
    derivative is a sum of products of neighbouring table values that
    nearly cancel, which in f32 keeps only about three digits of the alpha
    gradient."""
    out_dtype = alpha.dtype
    alpha = alpha.double()
    x_scale, values, tangents = _spline()
    v = torch.as_tensor(values, device=alpha.device).double()
    tg = torch.as_tensor(tangents, device=alpha.device).double()
    x = torch.where(
        alpha < 4,
        (2.25 * alpha - 4.5) / (torch.abs(alpha - 2.0) + 0.25) + alpha + 2.0,
        5.0 / 18.0 * torch.log(torch.clamp(4.0 * alpha - 15.0, max=33e37))
        + 8.0) * x_scale
    n = v.shape[0]
    lo = torch.floor(torch.clamp(x, 0.0, n - 2)).long()
    t = x - lo.to(x.dtype)
    t_sq = t * t
    t_cu = t * t_sq
    h01 = -2.0 * t_cu + 3.0 * t_sq
    h00 = 1.0 - h01
    h11 = t_cu - t_sq
    h10 = h11 - t_sq + t
    before = tg[0] * t + v[0]
    after = tg[-1] * (t - 1.0) + v[-1]
    mid = v[lo] * h00 + v[lo + 1] * h01 + tg[lo] * h10 + tg[lo + 1] * h11
    return torch.where(t < 0.0, before,
                       torch.where(t > 1.0, after, mid)).to(out_dtype)


class Latents(nn.Module):
    """The adaptive loss's trainable latents, zeros: alpha 1, scale 1."""

    def __init__(self, c: int):
        super().__init__()
        self.latent_alpha = nn.Parameter(torch.zeros(1, c))
        self.latent_scale = nn.Parameter(torch.zeros(1, c))

    def alpha(self) -> torch.Tensor:
        return torch.sigmoid(self.latent_alpha[0]) * 1.998 + 0.001

    def scale(self, lo: float = 1e-5) -> torch.Tensor:
        shift = float(np.log(np.expm1(1.0)))
        return (1.0 - lo) * F.softplus(self.latent_scale[0] + shift) + lo


def nll(x: torch.Tensor, p: Latents, scale_lo: float = 1e-5) -> torch.Tensor:
    """-log p(x | alpha, c) per element of x (M, C), alpha in (0, 2)."""
    alpha, scale = p.alpha(), p.scale(scale_lo)
    sq = torch.square(x / scale)
    beta = torch.clamp(torch.abs(alpha - 2.0), min=F32_EPS)
    alpha_s = torch.where(alpha >= 0, 1.0, -1.0) * \
        torch.clamp(torch.abs(alpha), min=F32_EPS)
    # (sq / beta + 1)^(alpha / 2) - 1, written without its cancellation
    # for small residuals, which would cost the alpha gradient digits
    rho = beta / alpha_s * torch.expm1(0.5 * alpha * torch.log1p(sq / beta))
    return rho + torch.log(scale) + log_partition(alpha)


# ---- the towers ------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg(x_nchw: torch.Tensor, weights: Dict[str, tuple], blocks,
        taps: Sequence[str]) -> Dict[str, torch.Tensor]:
    """A VGG tower (3x3 convs with ReLU, 2x2 max-pools after each block)
    up to the deepest of `taps` (relu<block>_<i>, pool<block>)."""
    wanted, outs, idx, x = set(taps), {}, 0, x_nchw
    for b, (n_convs, _) in enumerate(blocks, start=1):
        for i in range(1, n_convs + 1):
            w, bias = weights[f'conv{idx}']
            x = torch.relu(F.conv2d(x, w, bias, padding=1))
            idx += 1
            outs[f'relu{b}_{i}'] = x
            if wanted <= outs.keys():
                return outs
        x = F.max_pool2d(x, 2, 2)
        outs[f'pool{b}'] = x
        if wanted <= outs.keys():
            return outs
    raise KeyError(sorted(wanted - outs.keys()))


VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
VGG19 = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))


def nchw(img_nhwc: torch.Tensor) -> torch.Tensor:
    return img_nhwc.permute(0, 3, 1, 2).contiguous()


# ---- CX --------------------------------------------------------------------


def cx_features(x_img, y_img, weights):
    """xn, yn (N, HW, C): the VGG19 relu3_4 features (f32) of both
    sides, shifted by the mean of y's features over the batch and space
    and normalised per position."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x_img.device)
    std = torch.as_tensor(IMAGENET_STD, device=x_img.device)

    def feats(img):
        f = vgg(nchw((img - mean) / std), weights, VGG19, ('relu3_4',))
        return f['relu3_4'].permute(0, 2, 3, 1).float()

    fx, fy = feats(x_img), feats(y_img)
    n, h, w, c = fy.shape
    mu = torch.mean(fy, dim=(0, 1, 2), keepdim=True)
    xc, yc = fx - mu, fy - mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=-1, keepdim=True) + 1e-12)
    yn = yc / (torch.linalg.vector_norm(yc, dim=-1, keepdim=True) + 1e-12)
    return xn.reshape(n, -1, c), yn.reshape(n, -1, c)


def cx_colmax(xn, yn, band_width: float = 0.5):
    """z (N, Q): d = 1 - clamp(cos) of every x position p against every y
    position q, relative to p's nearest q, softmax over q, max over p."""
    sim = torch.bmm(xn, yn.transpose(1, 2))
    dist = 1.0 - torch.clamp(sim.to(xn.dtype), 0.0, 1.0)
    rel = dist / (torch.amin(dist, dim=2, keepdim=True) + 1e-5)
    e = torch.exp((1.0 - rel) / band_width)
    return torch.amax(e / torch.sum(e, dim=2, keepdim=True), dim=1)


def contextual(x_img, y_img, valid, weights, band_width: float = 0.5,
               capture: Optional[list] = None):
    """The cosine contextual loss: cx_colmax of cx_features, -log(mean +
    1e-5) per sample, averaged over the valid samples. `capture`, if
    given, receives the (xn, yn) the chain took."""
    xn, yn = cx_features(x_img, y_img, weights)
    if capture is not None:
        capture.append((xn.detach(), yn.detach()))
    cx = cx_colmax(xn, yn, band_width)
    term = -torch.log(torch.mean(cx, dim=1) + 1e-5)
    v = valid.to(term.dtype)
    return torch.sum(term * v) / torch.clamp(torch.sum(v), min=1.0)


# ---- LPIPS (VGG16, the per-layer adaptive robust distance) -----------------

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_TAPS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')


@functools.lru_cache(maxsize=1)
def _lins():
    with np.load(os.path.join(HERE, 'lpips_lin_vgg.npz')) as f:
        return [np.asarray(f[f'lin{i}'], np.float32) for i in range(5)]


def lpips_robust(in0, in1, latents: Sequence[Latents], weights):
    """(N,) LPIPS of [0, 1] images with each layer's unit-normalised
    feature difference scored by the adaptive robust NLL, weighted per
    channel by the published linear head, averaged over space and summed
    over the five layers."""
    dev = in0.device
    shift = torch.as_tensor(LPIPS_SHIFT, device=dev)
    scale = torch.as_tensor(LPIPS_SCALE, device=dev)

    def feats(img):
        x = ((2.0 * img - 1.0) - shift) / scale
        outs = vgg(nchw(x), weights, VGG16, LPIPS_TAPS)
        return [outs[t].permute(0, 2, 3, 1) for t in LPIPS_TAPS]

    total = 0.0
    for f0, f1, p, lin in zip(feats(in0), feats(in1), latents, _lins()):
        d = (f0 / (torch.sqrt(torch.sum(f0 * f0, -1, keepdim=True)) + 1e-10)
             - f1 / (torch.sqrt(torch.sum(f1 * f1, -1, keepdim=True))
                     + 1e-10)).float()
        n, h, w, c = d.shape
        rows = torch.sum(nll(d.reshape(-1, c), p) *
                         torch.as_tensor(lin, device=dev), -1)
        total = total + torch.mean(rows.reshape(n, h * w), dim=1)
    return total


# ---- the style loss (VGG16 pool1..3 Grams, adaptive robust) ---------------

STYLE_TAPS = ('pool1', 'pool2', 'pool3')


def style(a_img, b_img, valid, latents: Sequence[Latents], weights):
    """The adaptive style loss: for each of pool1..pool3 of VGG16 on raw
    [0, 1] patches, the Gram difference's mean robust NLL over its C^2
    entries over C*H*W, averaged over the valid samples, summed over the
    layers."""
    fa = vgg(nchw(a_img), weights, VGG16, STYLE_TAPS)
    fb = vgg(nchw(b_img), weights, VGG16, STYLE_TAPS)
    v = valid.to(torch.float32)
    total = 0.0
    for tap, p in zip(STYLE_TAPS, latents):
        a, b = fa[tap], fb[tap]
        n, c, h, w = a.shape
        av, bv = a.reshape(n, c, h * w), b.reshape(n, c, h * w)
        diff = (torch.bmm(av, av.transpose(1, 2)) -
                torch.bmm(bv, bv.transpose(1, 2))).float().reshape(n, c * c)
        per = torch.mean(nll(diff, p), -1) / (c * h * w)
        total = total + torch.sum(per * v) / torch.clamp(torch.sum(v),
                                                         min=1.0)
    return total


def pixel_loss(pred, gt, mask, p: Latents, scale_lo: float):
    """The masked adaptive robust pixel loss: known pixels weigh 1,
    unknown 0.3, the mean NLL over the rows and channels."""
    diff = pred - gt
    diff = diff * mask + (1.0 - mask) * diff * 0.3
    return torch.mean(nll(diff, p, scale_lo))
