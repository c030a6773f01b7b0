"""General and adaptive robust loss (Barron, arXiv:1701.03077) in PyTorch.

Port of `npp_tpu/losses/robust.py` (reference:
externel_lib/robust_loss_pytorch/{general.py:32-120, adaptive.py:37-204,
distribution.py:136-204, cubic_spline.py:24-100}). The adaptive latents are
an `nn.Module` (AdaptiveLossParams) whose parameters ride the fit's Adam.

The log-partition spline is the reference's `partition_spline.npz`, with
the port's own copy under npp_tpu_torch/assets/.

`weighted_nll_rows` (and `weighted_nll_rows_group`, several at once) is the
adaptive losses' hot path: its per-element rho goes through K4
(kernels/robust_rho.py) for CUDA tensors, and the per-channel constant
log s + log Z(alpha) stays here with autograd. `stacked_nll_mean_sum` is
the search's pixel loss over all its candidates in one K4 launch.
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..kernels.robust_rho import (MAX_SEGMENTS, rho_otherwise, rho_rows,
                                  rho_rows_group)

_LOG_MAX = 33e37
_EXP_MAX = 87.5
ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'assets')


def log1p_safe(x):
    return torch.log1p(torch.clamp(x, max=_LOG_MAX))


def log_safe(x):
    return torch.log(torch.clamp(x, max=_LOG_MAX))


def expm1_safe(x):
    return torch.expm1(torch.clamp(x, max=_EXP_MAX))


def exp_safe(x):
    return torch.exp(torch.clamp(x, max=_EXP_MAX))


def affine_sigmoid(logits, lo=0.0, hi=1.0):
    """Maps reals to (lo, hi); 0 -> (lo+hi)/2 (reference: util.py:64-72)."""
    return torch.sigmoid(logits) * (hi - lo) + lo


def inv_affine_sigmoid(probs, lo=0.0, hi=1.0):
    """The inverse of affine_sigmoid (reference: util.py:75-84), numpy."""
    p = (probs - lo) / (hi - lo)
    return -np.log(1.0 / p - 1.0)


def affine_softplus(x, lo=0.0, ref=1.0):
    """Maps reals to (lo, inf); 0 -> ref (reference: util.py:87-96)."""
    shift = float(np.log(np.expm1(1.0)))  # inv_softplus(1)
    return (ref - lo) * torch.nn.functional.softplus(x + shift) + lo


def general_lossfun(x, alpha, scale):
    """rho(x, alpha, c), exact form with every special alpha
    (reference: general.py:32-120)."""
    sq = torch.square(x / scale)
    loss_two = 0.5 * sq
    loss_zero = log1p_safe(0.5 * sq)
    loss_neginf = -torch.expm1(-0.5 * sq)
    loss_posinf = expm1_safe(0.5 * sq)
    loss_otherwise = rho_otherwise(x, alpha, scale)
    return torch.where(
        alpha == -np.inf, loss_neginf,
        torch.where(alpha == 0.0, loss_zero,
                    torch.where(alpha == 2.0, loss_two,
                                torch.where(alpha == np.inf, loss_posinf,
                                            loss_otherwise))))


def interpolate1d(x, values, tangents):
    """Cubic Hermite spline with linear extrapolation
    (reference: cubic_spline.py:24-119)."""
    n = values.shape[0]
    x_lo = torch.floor(torch.clamp(x, 0.0, n - 2)).long()
    x_hi = x_lo + 1
    t = x - x_lo.to(x.dtype)
    t_sq = t * t
    t_cu = t * t_sq
    h01 = -2.0 * t_cu + 3.0 * t_sq
    h00 = 1.0 - h01
    h11 = t_cu - t_sq
    h10 = h11 - t_sq + t

    value_before = tangents[0] * t + values[0]
    value_after = tangents[-1] * (t - 1.0) + values[-1]
    value_mid = (values[x_lo] * h00 + values[x_hi] * h01 +
                 tangents[x_lo] * h10 + tangents[x_hi] * h11)
    return torch.where(t < 0.0, value_before,
                       torch.where(t > 1.0, value_after, value_mid))


def partition_spline_curve(alpha):
    """Nonlinearity applied to alpha before spline lookup
    (reference: distribution.py:79-115)."""
    return torch.where(
        alpha < 4,
        (2.25 * alpha - 4.5) / (torch.abs(alpha - 2.0) + 0.25) + alpha + 2.0,
        5.0 / 18.0 * log_safe(4.0 * alpha - 15.0) + 8.0)


@functools.lru_cache(maxsize=1)
def _load_spline():
    with np.load(os.path.join(ASSET_DIR, 'partition_spline.npz'),
                 allow_pickle=False) as f:
        return (float(f['x_scale']), np.asarray(f['values'], np.float32),
                np.asarray(f['tangents'], np.float32))


def log_base_partition_function(alpha):
    """log(Z(alpha)) via the precomputed spline (reference:
    distribution.py:144-170)."""
    x_scale, values, tangents = _load_spline()
    x = partition_spline_curve(alpha)
    return interpolate1d(x * x_scale,
                         torch.as_tensor(values, device=alpha.device),
                         torch.as_tensor(tangents, device=alpha.device))


def nllfun(x, alpha, scale):
    """-log p(x | 0, alpha, c) (reference: distribution.py:172-204)."""
    loss = general_lossfun(x, alpha, scale)
    return loss + torch.log(scale) + log_base_partition_function(alpha)


class AdaptiveLossParams(nn.Module):
    """Trainable latents of AdaptiveLossFunction (reference:
    adaptive.py:138-181), each (1, num_dims), or (n, 1, num_dims) for n
    stacked copies (the search's candidates). Both initialise to zeros:
    latent_alpha=0 maps to alpha 1.0 and latent_scale=0 to scale 1.0."""

    def __init__(self, num_dims: int, n_stack: Optional[int] = None):
        super().__init__()
        shape = (1, num_dims) if n_stack is None else (n_stack, 1, num_dims)
        self.latent_alpha = nn.Parameter(torch.zeros(shape))
        self.latent_scale = nn.Parameter(torch.zeros(shape))


def adaptive_init(num_dims: int,
                  n_stack: Optional[int] = None) -> AdaptiveLossParams:
    return AdaptiveLossParams(num_dims, n_stack)


def adaptive_alpha(p: AdaptiveLossParams, alpha_lo=0.001, alpha_hi=1.999):
    return affine_sigmoid(p.latent_alpha, alpha_lo, alpha_hi)


def adaptive_scale(p: AdaptiveLossParams, scale_lo=1e-5, scale_init=1.0):
    return affine_softplus(p.latent_scale, scale_lo, scale_init)


def adaptive_lossfun(x: torch.Tensor, p: AdaptiveLossParams,
                     alpha_lo=0.001, alpha_hi=1.999,
                     scale_lo=1e-5, scale_init=1.0) -> torch.Tensor:
    """Element-wise NLL of a rank-2 residual [batch, num_dims]
    (reference: adaptive.py:182-204), plain PyTorch; the fits' hot paths
    take weighted_nll_rows instead, whose rho goes through K4."""
    return nllfun(x, adaptive_alpha(p, alpha_lo, alpha_hi),
                  adaptive_scale(p, scale_lo, scale_init))


def weighted_nll_rows_group(xs: Sequence[torch.Tensor],
                            ps: Sequence[AdaptiveLossParams],
                            ws: Sequence[torch.Tensor],
                            scale_lo: float = 1e-5,
                            images: Optional[Sequence[int]] = None
                            ) -> List[torch.Tensor]:
    """weighted_nll_rows of each (x, p, w): the rho terms of all of them go
    through one K4 forward launch on the card (rho_rows_group), or one per
    MAX_SEGMENTS of them. images: with latents stacked over images
    ((B, 1, C), parallel/batch.py), segment i takes image images[i]'s."""
    def pick(t, i):
        return t[0] if images is None else t[images[i], 0]
    alphas = [pick(adaptive_alpha(p), i) for i, p in enumerate(ps)]
    scales = [pick(adaptive_scale(p, scale_lo=scale_lo), i)
              for i, p in enumerate(ps)]
    rows: List[torch.Tensor] = []
    for lo in range(0, len(xs), MAX_SEGMENTS):
        hi = lo + MAX_SEGMENTS
        rows += rho_rows_group(xs[lo:hi], alphas[lo:hi], scales[lo:hi],
                               ws[lo:hi])
    return [r + torch.sum(w * (torch.log(s) + log_base_partition_function(a)))
            for r, a, s, w in zip(rows, alphas, scales, ws)]


def weighted_nll_rows(x: torch.Tensor, p: AdaptiveLossParams,
                      w: torch.Tensor, scale_lo: float = 1e-5) -> torch.Tensor:
    """x (M, C) -> (M,) sum_c w_c * nll(x[m, c], alpha_c, s_c) with the
    adaptive alpha and scale of `p` (adaptive.py:182-204 summed over
    channels with weights w). The rho term goes through K4; the
    per-channel constant is added once per row."""
    return weighted_nll_rows_group((x,), (p,), (w,), scale_lo)[0]


def stacked_nll_mean_sum(diff: torch.Tensor, p: AdaptiveLossParams,
                         scale_lo: float = 1e-5) -> torch.Tensor:
    """Sum over n stacked copies of mean(nll(diff[i], alpha_i, s_i)):
    diff (n, M, C), p with latents (n, 1, C). The n*C channels are laid
    out side by side as one (M, n*C) matrix with alpha and s per column,
    so the rho terms of every copy go through one K4 forward (and one
    backward) launch. Its row sums mix the copies, which is harmless for
    the gradient: each copy's parameters reach only its own terms."""
    n, m, c = diff.shape
    x = diff.permute(1, 0, 2).reshape(m, n * c)
    alpha = adaptive_alpha(p).reshape(n * c)
    scale = adaptive_scale(p, scale_lo=scale_lo).reshape(n * c)
    rows = rho_rows(x, alpha, scale, torch.ones_like(alpha))
    const = torch.sum(torch.log(scale) + log_base_partition_function(alpha))
    return (torch.sum(rows) + m * const) / (m * c)
