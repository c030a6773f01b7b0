"""K4: row-wise weighted Barron rho, forward and backward in CUDA C++
(csrc/robust_rho_fwd.cu, csrc/robust_rho_bwd.cu).

Replaces the per-element rho of `nllfun` (npp_tpu/losses/robust.py:63-81,
134-138) that XLA fused into the adaptive pixel loss (losses/pixel.py) and
the LPIPS robust path (losses/lpips.py), and its backward:

    r[m] = sum_c w_c * rho(x[m, c], alpha_c, s_c)

with the `loss_otherwise` branch of general_lossfun and its beta_safe /
alpha_safe. Adaptive alpha lies in (0.001, 1.999), where that branch is the
whole function. The per-channel constant log s_c + log Z(alpha_c) and the
latent -> (alpha, s) maps stay plain torch with autograd (losses/robust.py).

Bound: memory. The forward reads x (M, C) once and writes r (M,), for up
to sixteen (x, alpha, s, w) segments in one launch (`rho_rows_group`: the
five LPIPS layers of a step, of up to three images in the multi-image fit,
or the style loss's three layers). The backward
reads x and g and writes dx, one launch per segment, and sums dalpha and ds
per channel on the device in a fixed order. Rows wider than 1,024 channels
(the style loss's flattened Grams, (6, 4,096) to (6, 65,536)) take each
kernel's wide path: the forward cuts a row into chunks of WIDE_CHUNK
columns with a partial sum each, the backward runs a thread per channel
down the rows. Each source's note gives its design. The backward's alpha
derivative is computed in f32 in forms without the cancellation of the
direct one; `rho_bwd_plain` is the same arithmetic in PyTorch, line by
line.

A CUDA tensor goes through the kernels or the call raises; a CPU tensor goes
through `rho_rows_plain` with autograd.
"""
import collections
import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from .build import check_cuda, load_library, sm_count

# launches by kernel and shape, keyed 'robust_rho_fwd[MxC]',
# 'robust_rho_fwd_group[MxC,MxC,...]' or 'robust_rho_bwd[MxC]'
LAUNCHES = collections.Counter()
F32_EPS = float(np.finfo(np.float32).eps)
MAX_SEGMENTS = 16    # segments of one forward launch (csrc/robust_rho_fwd.cu)
MAX_NARROW = 1024    # wider rows take the forward's wide path, whose
WIDE_CHUNK = 2048    # blocks each sum this many columns of a row


def rho_otherwise(x: torch.Tensor, alpha: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The `loss_otherwise` branch of general_lossfun (robust.py:71-74)."""
    sq = torch.square(x / scale)
    beta_safe = torch.clamp(torch.abs(alpha - 2.0), min=F32_EPS)
    alpha_safe = torch.where(alpha >= 0, 1.0, -1.0) * \
        torch.clamp(torch.abs(alpha), min=F32_EPS)
    return (beta_safe / alpha_safe) * (
        torch.pow(sq / beta_safe + 1.0, 0.5 * alpha) - 1.0)


def rho_rows_plain(x: torch.Tensor, alpha: torch.Tensor, scale: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """x (M, C); alpha, scale, w (C,) -> (M,) sum_c w_c rho(x, alpha_c, s_c)."""
    return torch.sum(rho_otherwise(x, alpha, scale) * w, dim=-1)


def _phi_poly(t: torch.Tensor) -> torch.Tensor:
    """phi(t) / t^2 = sum_{n>=2} (n-1) t^(n-2) / n!, phi(t) = t e^t - expm1(t)."""
    p = torch.full_like(t, 1.0 / 403200.0)
    for coef in (1 / 45360, 1 / 5760, 1 / 840, 1 / 144, 1 / 30, 1 / 8, 1 / 3,
                 0.5):
        p = p * t + coef
    return p


def rho_bwd_plain(g: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor,
                  scale: torch.Tensor, w: torch.Tensor):
    """The backward kernel's arithmetic in PyTorch, line by line: g (M,),
    x (M, C); alpha, scale, w (C,) -> (dx (M, C), dalpha (C,), dscale (C,)),
    the gradient of rho_rows_plain. The alpha derivative avoids the direct
    form's cancellation (the forms are derived in csrc/robust_rho_bwd.cu);
    off the interior of (0, 2) it is the direct form through the clamps."""
    a, eps = alpha, F32_EPS
    b = torch.clamp(torch.abs(a - 2.0), min=eps)
    asafe = torch.where(a >= 0, 1.0, -1.0) * torch.clamp(torch.abs(a), min=eps)
    inv_b, inv_a, inv_s = 1.0 / b, 1.0 / asafe, 1.0 / scale
    z = x * inv_s
    sq = z * z
    q = sq * inv_b
    u = 1.0 + q
    L = torch.log1p(q)
    # interior of (0, 2): one expm1 for both forms
    interior = (a > eps) & (2.0 - a > eps)
    lo = a < 1.0
    t = 0.5 * a * L
    em1 = torch.expm1(torch.where(lo, t, -0.5 * b * L))
    # 0 < alpha < 1
    pw = 1.0 + em1
    e_lo = pw * (1.0 / u)
    two_phi_a2 = torch.where(t < 0.5, 0.5 * L * L * _phi_poly(t),
                             2.0 * (t * pw - em1) * inv_a * inv_a)
    da_lo = two_phi_a2 - 0.5 * L * pw + 0.5 * e_lo * q
    # 1 <= alpha < 2
    e_hi = 1.0 + em1
    da_hi = (-0.5 * e_hi * sq * (2.0 + a) - 2.0 * em1) * inv_a * inv_a + \
        (b + sq) * e_hi * L * (0.5 * inv_a)
    # the clamps and alpha outside (0, 2): the direct terms
    em1_d = torch.expm1(t)
    pw_d = 1.0 + em1_d
    am2 = a - 2.0
    dbeta = torch.where(am2 > eps, 1.0, torch.where(am2 < -eps, -1.0, 0.0))
    dasafe = torch.where(torch.abs(a) > eps, 1.0, 0.0)
    dcoef = (dbeta * (1.0 / inv_a) - b * dasafe) * inv_a * inv_a
    dpw = pw_d * (0.5 * L - 0.5 * a * q * inv_b * dbeta / u)
    da_d = dcoef * em1_d + b * inv_a * dpw

    e = torch.where(interior, torch.where(lo, e_lo, e_hi), pw_d / u)
    da = torch.where(interior, torch.where(lo, da_lo, da_hi), da_d)
    gw = g[:, None] * w
    gsq2 = gw * (a / asafe) * e      # twice g w d rho/d sq
    return (gsq2 * z * inv_s, torch.sum(gw * da, 0),
            torch.sum(-(gsq2 * sq * inv_s), 0))


class _Segment(ctypes.Structure):
    """csrc/robust_rho_fwd.cu's RhoSegment: x, alpha, scale, w, r, m, c,
    and part, the wide path's scratch."""
    _fields_ = [('x', ctypes.c_void_p), ('alpha', ctypes.c_void_p),
                ('scale', ctypes.c_void_p), ('w', ctypes.c_void_p),
                ('r', ctypes.c_void_p), ('m', ctypes.c_longlong),
                ('c', ctypes.c_longlong), ('part', ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    fn = load_library('robust_rho_fwd').npp_robust_rho_fwd_group
    fn.argtypes = [ctypes.POINTER(_Segment), ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fwd_key(shapes) -> str:
    """The launch count's key for segments of these (M, C) shapes."""
    names = ','.join(f'{m}x{c}' for m, c in shapes)
    return (f'robust_rho_fwd[{names}]' if len(shapes) == 1
            else f'robust_rho_fwd_group[{names}]')


def rho_fwd_group_launch(segments):
    """r of each (x, alpha, scale, w) in `segments` (1 to MAX_SEGMENTS), in
    one launch of csrc/robust_rho_fwd.cu. Counted under
    'robust_rho_fwd[MxC]' for one segment and
    'robust_rho_fwd_group[MxC,MxC,...]' for more. The host's work per
    call is most of the launch's time at the main path's small shapes, so
    it is kept to the pointers, one torch.empty per output and the call."""
    n = len(segments)
    dev = segments[0][0].device
    outs = []
    arr = (_Segment * n)()
    for i, (x, alpha, scale, w) in enumerate(segments):
        m, c = x.shape
        # a wide row's partials go after the m outputs
        n_part = m * -(-c // WIDE_CHUNK) if c > MAX_NARROW else 0
        buf = torch.empty((m + n_part,), dtype=torch.float32, device=dev)
        r = buf[:m]
        arr[i] = _Segment(x.data_ptr(), alpha.data_ptr(), scale.data_ptr(),
                          w.data_ptr(), r.data_ptr(), m, c,
                          buf[m:].data_ptr() if n_part else None)
        outs.append(r)
    status = _fwd_fn()(
        arr, n, sm_count(dev.index),
        torch._C._cuda_getCurrentRawStream(dev.index))
    check_cuda(status, 'robust_rho_fwd')
    LAUNCHES[_fwd_key(tuple(s[0].shape for s in segments))] += 1
    return outs


def rho_fwd_launch(x, alpha, scale, w):
    """r of one (x, alpha, scale, w) on the card; csrc/robust_rho_fwd.cu."""
    return rho_fwd_group_launch(((x, alpha, scale, w),))[0]


def _bwd_lib() -> ctypes.CDLL:
    lib = load_library('robust_rho_bwd')
    fn = lib.npp_robust_rho_bwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 p]
        fn.restype = ctypes.c_int
    return lib


def bwd_max_channels(c: int) -> int:
    """The largest C of the backward's row path: one sweep of 256 threads
    (4 values each where C % 4 == 0, and x is 16-byte aligned, which the
    launcher checks) holds a whole row. Wider rows take its wide path."""
    return 1024 if c % 4 == 0 else 256


def rho_bwd_launch(g, x, alpha, scale, w):
    """(dx, dalpha, dscale) of rho_rows on the card; csrc/robust_rho_bwd.cu."""
    m, c = x.shape
    g = g.contiguous()
    dev = x.device
    sms = sm_count(dev.index)
    dx = torch.empty_like(x)
    # dalpha, dscale, then the row path's (2, 8 * SMs, C) partial sums (the
    # wide path needs none)
    n_part = 16 * sms * c if c <= bwd_max_channels(c) else 0
    buf = torch.empty((2 * c + n_part,), dtype=torch.float32, device=dev)
    da, ds, part = buf[:c], buf[c:2 * c], buf[2 * c:]
    status = _bwd_lib().npp_robust_rho_bwd(
        x.data_ptr(), alpha.data_ptr(), scale.data_ptr(), w.data_ptr(),
        g.data_ptr(), dx.data_ptr(), part.data_ptr() if n_part else None,
        da.data_ptr(), ds.data_ptr(), m, c, sms,
        torch.cuda.current_stream(dev).cuda_stream)
    check_cuda(status, 'robust_rho_bwd')
    LAUNCHES[f'robust_rho_bwd[{m}x{c}]'] += 1
    return dx, da, ds


class _RhoRowsGroup(torch.autograd.Function):
    """Segments flattened as (x, alpha, scale, w, x, alpha, ...): one
    forward launch for all of them, one backward launch per segment."""

    @staticmethod
    def forward(ctx, *flat):
        ctx.save_for_backward(*flat)
        return tuple(rho_fwd_group_launch(
            [flat[i:i + 4] for i in range(0, len(flat), 4)]))

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        grads = []
        for i, g in enumerate(gs):
            x, alpha, scale, w = saved[4 * i:4 * i + 4]
            grads += [*rho_bwd_launch(g, x, alpha, scale, w), None]
        return tuple(grads)


def rho_rows_group_plain(xs, alphas, scales, ws) -> List[torch.Tensor]:
    """rho_rows_plain of each segment."""
    return [rho_rows_plain(*seg) for seg in zip(xs, alphas, scales, ws)]


def rho_rows_group(xs: Sequence[torch.Tensor], alphas: Sequence[torch.Tensor],
                   scales: Sequence[torch.Tensor],
                   ws: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """rho_rows of up to MAX_SEGMENTS segments: x_i (M_i, C_i); alpha_i,
    scale_i, w_i (C_i,) -> [(M_i,)]. On the card, one forward launch for
    all of them. Differentiable in x, alpha and scale; w is a constant."""
    segs = list(zip(xs, alphas, scales, ws))
    if not 1 <= len(segs) <= MAX_SEGMENTS or \
            not len(xs) == len(alphas) == len(scales) == len(ws):
        raise ValueError(f'rho_rows_group takes 1 to {MAX_SEGMENTS} '
                         'segments of (x, alpha, scale, w)')
    kinds = {t.device.type for seg in segs for t in seg}
    if kinds == {'cpu'}:
        return rho_rows_group_plain(xs, alphas, scales, ws)
    if kinds != {'cuda'}:
        raise RuntimeError(f'rho_rows: unsupported devices {kinds}')
    flat = []
    for x, alpha, scale, w in segs:
        c = x.shape[-1]
        if x.dim() != 2 or any(t.shape != (c,) for t in (alpha, scale, w)):
            raise ValueError('rho_rows takes x (M, C) and alpha, scale, w '
                             '(C,)')
        if any(t.dtype != torch.float32 for t in (x, alpha, scale, w)):
            raise ValueError('rho_rows takes float32 tensors')
        flat += [x.contiguous(), alpha.contiguous(), scale.contiguous(),
                 w.detach().contiguous()]
    return list(_RhoRowsGroup.apply(*flat))


def rho_rows(x: torch.Tensor, alpha: torch.Tensor, scale: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """x (M, C); alpha, scale, w (C,) -> (M,) sum_c w_c rho(x, alpha_c, s_c).
    Differentiable in x, alpha and scale; w is a constant."""
    return rho_rows_group((x,), (alpha,), (scale,), (w,))[0]
