"""K4: row-wise weighted Barron rho, Triton.

Replaces the per-element rho of `nllfun` (npp_tpu/losses/robust.py:63-81,
134-138) that XLA fused into the adaptive pixel loss (losses/pixel.py) and
the LPIPS robust path (losses/lpips.py):

    r[m] = sum_c w_c * rho(x[m, c], alpha_c, s_c)

with the `loss_otherwise` branch of general_lossfun and its beta_safe /
alpha_safe. Adaptive alpha lies in (0.001, 1.999), where that branch is the
whole function. The per-channel constant log s_c + log Z(alpha_c) and the
latent -> (alpha, s) maps stay plain torch with autograd (losses/robust.py).

Bound: memory. The forward reads x (M, C) once and writes r (M,); the
backward reads x and g and writes dx, plus per-channel partial sums of
dalpha and ds. Design: a (BLOCK_M, BLOCK_C) tile per program with the whole
channel row in registers, so the channel sum is a register reduction; the
backward writes one row of partial dalpha/ds per program and torch sums the
(programs, C) partials (deterministic, no atomics). The dalpha terms are
computed and summed in float64 (see the kernel): they cancel badly in f32
for small alpha, and the extra arithmetic is small beside the memory
traffic.

A CUDA tensor goes through the kernels or the call raises; a CPU tensor goes
through `rho_rows_plain` with autograd.

(No `from __future__ import annotations` here: Triton reads the
`tl.constexpr` annotations of the jitted kernels as objects.)
"""
import functools

import numpy as np
import torch

from .build import triton_setup

LAUNCHES = {'robust_rho_fwd': 0, 'robust_rho_bwd': 0}
F32_EPS = float(np.finfo(np.float32).eps)

# Set at the first launch (_kernels); the jitted kernels read them as
# module globals.
triton = tl = tld = _terms = None


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


@functools.lru_cache(maxsize=None)
def _kernels():
    global triton, tl, tld, _terms
    triton, tl, tld = triton_setup()

    @triton.jit
    def _terms(x, a, s, EPS: tl.constexpr):
        beta = tl.maximum(tl.abs(a - 2.0), EPS)
        asafe = tl.where(a >= 0, 1.0, -1.0) * tl.maximum(tl.abs(a), EPS)
        z = x / s
        sq = z * z
        u = sq / beta + 1.0
        pw = tld.pow(u, 0.5 * a)
        return beta, asafe, sq, u, pw

    @triton.jit
    def rho_fwd_kernel(x_ptr, a_ptr, s_ptr, w_ptr, r_ptr, M, C,
                       EPS: tl.constexpr, BLOCK_M: tl.constexpr,
                       BLOCK_C: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_C)
        rm = rows < M
        cm = cols < C
        m2 = rm[:, None] & cm[None, :]
        x = tl.load(x_ptr + rows[:, None] * C + cols[None, :], mask=m2,
                    other=0.0)
        a = tl.load(a_ptr + cols, mask=cm, other=1.0)[None, :]
        s = tl.load(s_ptr + cols, mask=cm, other=1.0)[None, :]
        w = tl.load(w_ptr + cols, mask=cm, other=0.0)[None, :]
        beta, asafe, sq, u, pw = _terms(x, a, s, EPS)
        rho = (beta / asafe) * (pw - 1.0)
        r = tl.sum(tl.where(m2, rho * w, 0.0), axis=1)
        tl.store(r_ptr + rows, r, mask=rm)

    @triton.jit
    def rho_bwd_kernel(x_ptr, a_ptr, s_ptr, w_ptr, g_ptr, dx_ptr, pa_ptr,
                       ps_ptr, M, C, EPS: tl.constexpr, BLOCK_M: tl.constexpr,
                       BLOCK_C: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        rows = pid * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_C)
        rm = rows < M
        cm = cols < C
        m2 = rm[:, None] & cm[None, :]
        x = tl.load(x_ptr + rows[:, None] * C + cols[None, :], mask=m2,
                    other=0.0)
        a = tl.load(a_ptr + cols, mask=cm, other=1.0)[None, :]
        s = tl.load(s_ptr + cols, mask=cm, other=1.0)[None, :]
        w = tl.load(w_ptr + cols, mask=cm, other=0.0)[None, :]
        g = tl.load(g_ptr + rows, mask=rm, other=0.0)[:, None]
        beta, asafe, sq, u, pw = _terms(x, a, s, EPS)
        gw = g * w
        # d/dx and d/ds through sq = (x/s)^2
        dpw_dsq = (0.5 * a) * (pw / u) / beta
        coef = beta / asafe
        dx = gw * coef * dpw_dsq * (2.0 * x / (s * s))
        ds = gw * coef * dpw_dsq * (-2.0 * sq / s)
        # d/dalpha through beta_safe, alpha_safe and the exponent, in
        # float64: its two terms, each of order log(u)/alpha, cancel to a
        # result of order log(u)^2, which loses 2-3 digits for small alpha
        # (in f32 this kernel then lost to the plain version on the card)
        a64, x64, s64 = a.to(tl.float64), x.to(tl.float64), s.to(tl.float64)
        beta64 = tl.maximum(tl.abs(a64 - 2.0), EPS)
        asafe64 = tl.where(a64 >= 0, 1.0, -1.0) * tl.maximum(tl.abs(a64), EPS)
        z64 = x64 / s64
        sq64 = z64 * z64
        u64 = sq64 / beta64 + 1.0
        log_u = tld.log(u64)
        pw64 = tld.exp(0.5 * a64 * log_u)
        am2 = a64 - 2.0
        dbeta = tl.where(am2 > EPS, 1.0, tl.where(am2 < -EPS, -1.0, 0.0))
        dasafe = tl.where(tl.abs(a64) > EPS, 1.0, 0.0)
        dcoef = (dbeta * asafe64 - beta64 * dasafe) / (asafe64 * asafe64)
        du = -sq64 / (beta64 * beta64) * dbeta
        dpw = pw64 * (0.5 * log_u + 0.5 * a64 * du / u64)
        da = gw.to(tl.float64) * (dcoef * (pw64 - 1.0) +
                                  (beta64 / asafe64) * dpw)
        tl.store(dx_ptr + rows[:, None] * C + cols[None, :], dx, mask=m2)
        tl.store(pa_ptr + pid * C + cols,
                 tl.sum(tl.where(m2, da, 0.0), axis=0), mask=cm)
        tl.store(ps_ptr + pid * C + cols,
                 tl.sum(tl.where(m2, ds, 0.0), axis=0), mask=cm)

    return rho_fwd_kernel, rho_bwd_kernel


def _blocks(c: int):
    block_c = max(2, 1 << (c - 1).bit_length())
    return max(16, 4096 // block_c), block_c


def rho_fwd_launch(x, alpha, scale, w):
    m, c = x.shape
    block_m, block_c = _blocks(c)
    fwd, _ = _kernels()
    r = torch.empty((m,), dtype=torch.float32, device=x.device)
    fwd[(triton.cdiv(m, block_m),)](x, alpha, scale, w, r, m, c, EPS=F32_EPS,
                                    BLOCK_M=block_m, BLOCK_C=block_c,
                                    num_warps=4)
    LAUNCHES['robust_rho_fwd'] += 1
    return r


def rho_bwd_launch(g, x, alpha, scale, w):
    m, c = x.shape
    block_m, block_c = _blocks(c)
    _, bwd = _kernels()
    n_prog = triton.cdiv(m, block_m)
    dx = torch.empty_like(x)
    pa = torch.empty((n_prog, c), dtype=torch.float64, device=x.device)
    ps = torch.empty((n_prog, c), dtype=torch.float32, device=x.device)
    bwd[(n_prog,)](x, alpha, scale, w, g.contiguous(), dx, pa, ps, m, c,
                   EPS=F32_EPS, BLOCK_M=block_m, BLOCK_C=block_c, num_warps=8)
    LAUNCHES['robust_rho_bwd'] += 1
    return dx, pa.sum(0).to(torch.float32), ps.sum(0)


class _RhoRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, scale, w):
        ctx.save_for_backward(x, alpha, scale, w)
        return rho_fwd_launch(x, alpha, scale, w)

    @staticmethod
    def backward(ctx, g):
        x, alpha, scale, w = ctx.saved_tensors
        dx, da, ds = rho_bwd_launch(g, x, alpha, scale, w)
        return dx, da, ds, None


def rho_rows(x: torch.Tensor, alpha: torch.Tensor, scale: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """x (M, C); alpha, scale, w (C,) -> (M,) sum_c w_c rho(x, alpha_c, s_c).
    Differentiable in x, alpha and scale; w is a constant."""
    if x.device.type == 'cpu':
        return rho_rows_plain(x, alpha, scale, w)
    if x.device.type != 'cuda':
        raise RuntimeError(f'rho_rows: unsupported device {x.device}')
    c = x.shape[-1]
    if x.dim() != 2 or any(t.shape != (c,) for t in (alpha, scale, w)):
        raise ValueError('rho_rows takes x (M, C) and alpha, scale, w (C,)')
    if any(t.dtype != torch.float32 for t in (x, alpha, scale, w)):
        raise ValueError('rho_rows takes float32 tensors')
    return _RhoRows.apply(x.contiguous(), alpha.contiguous(),
                          scale.contiguous(), w.detach().contiguous())
