"""K2: bias + snake, Triton.

Replaces `act(TorchLinear(...))` of npp_tpu/nn/mlp.py:68-79 after the
matmul: y = h + sin^2(h) with h = x W^T + b, which XLA fused into the dense
layer's epilogue. The matmul stays a plain torch.matmul; this kernel is its
epilogue, and its backward computes dh = g * (1 + sin 2h).

The product is (M, N) with a bias (N,), or a batch (B, M, N) with a bias
per batch (B, N): the search's lockstep fit stacks its candidates' layers
on B (proposal/ranking.py).

Bound: memory. The forward reads the product and writes y; the backward
reads g and the saved product and writes dh: 2 and 3 passes over it in
f32. Design: one masked 1-D block of BLOCK elements per program over the
flattened tensor, the bias gathered at (offs // (M*N)) * N + offs % N
(the batch term only in the batched kernel), no shared memory staging.
The bias gradient, dh summed over M, is a torch reduction.

A CUDA tensor goes through the kernels or the call raises; a CPU tensor goes
through `bias_snake_plain` with autograd.

(No `from __future__ import annotations` here: Triton reads the
`tl.constexpr` annotations of the jitted kernels as objects.)
"""
import collections
import functools

import torch

from .build import triton_setup

# launches by direction and shape, keyed 'bias_snake_fwd[MxN]' or
# 'bias_snake_bwd[BxMxN]'
LAUNCHES = collections.Counter()
BLOCK = 2048

# Set at the first launch (_kernels); the jitted kernels read them as
# module globals.
triton = tl = tld = None


def bias_snake_plain(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """h (M, N) bias-free product with bias (N,), or h (B, M, N) with bias
    (B, N) -> snake(h + bias)."""
    z = h + (bias[:, None, :] if h.dim() == 3 else bias)
    return z + torch.square(torch.sin(z))


@functools.lru_cache(maxsize=None)
def _kernels():
    global triton, tl, tld
    triton, tl, tld = triton_setup()

    @triton.jit
    def snake_fwd_kernel(h_ptr, b_ptr, y_ptr, numel, batch_numel, n_cols,
                         BLOCK: tl.constexpr, BATCHED: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < numel
        if BATCHED:
            bi = (offs // batch_numel) * n_cols + offs % n_cols
        else:
            bi = offs % n_cols
        z = tl.load(h_ptr + offs, mask=m, other=0.0) + \
            tl.load(b_ptr + bi, mask=m, other=0.0)
        s = tld.sin(z)
        tl.store(y_ptr + offs, z + s * s, mask=m)

    @triton.jit
    def snake_bwd_kernel(g_ptr, h_ptr, b_ptr, dh_ptr, numel, batch_numel,
                         n_cols, BLOCK: tl.constexpr, BATCHED: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < numel
        if BATCHED:
            bi = (offs // batch_numel) * n_cols + offs % n_cols
        else:
            bi = offs % n_cols
        z = tl.load(h_ptr + offs, mask=m, other=0.0) + \
            tl.load(b_ptr + bi, mask=m, other=0.0)
        g = tl.load(g_ptr + offs, mask=m, other=0.0)
        tl.store(dh_ptr + offs, g * (1.0 + tld.sin(2.0 * z)), mask=m)

    return snake_fwd_kernel, snake_bwd_kernel


def _check(h: torch.Tensor, bias: torch.Tensor) -> None:
    if h.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError('bias_snake takes float32 tensors')
    if h.dim() not in (2, 3) or bias.shape != h.shape[:-2] + h.shape[-1:]:
        raise ValueError(f'bias_snake: h {tuple(h.shape)} and bias '
                         f'{tuple(bias.shape)} do not match')


@functools.lru_cache(maxsize=None)
def _key(name: str, shape) -> str:
    return f"{name}[{'x'.join(map(str, shape))}]"


def _launch_args(h: torch.Tensor):
    """(grid, numel, M*N, N, BATCHED) of one launch over h."""
    numel = h.numel()
    batched = h.dim() == 3 and h.shape[0] > 1
    return ((triton.cdiv(numel, BLOCK),), numel, h.shape[-2] * h.shape[-1],
            h.shape[-1], batched)


def snake_fwd_launch(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _check(h, bias)
    h, bias = h.contiguous(), bias.contiguous()
    y = torch.empty_like(h)
    fwd, _ = _kernels()
    grid, numel, mn, n, batched = _launch_args(h)
    fwd[grid](h, bias, y, numel, mn, n, BLOCK=BLOCK, BATCHED=batched,
              num_warps=8)
    LAUNCHES[_key('bias_snake_fwd', h.shape)] += 1
    return y


def snake_bwd_launch(g: torch.Tensor, h: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    _check(h, bias)
    g = g.contiguous()
    dh = torch.empty_like(h)
    _, bwd = _kernels()
    grid, numel, mn, n, batched = _launch_args(h)
    bwd[grid](g, h, bias, dh, numel, mn, n, BLOCK=BLOCK, BATCHED=batched,
              num_warps=8)
    LAUNCHES[_key('bias_snake_bwd', h.shape)] += 1
    return dh


class _BiasSnake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bias):
        h, bias = h.contiguous(), bias.contiguous()
        ctx.save_for_backward(h, bias)
        return snake_fwd_launch(h, bias)

    @staticmethod
    def backward(ctx, g):
        h, bias = ctx.saved_tensors
        dh = snake_bwd_launch(g, h, bias)
        return dh, dh.sum(-2)


def bias_snake(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """snake(h + bias) for a bias-free product h (M, N) and bias (N,), or a
    batch h (B, M, N) with a bias per batch (B, N)."""
    if h.device.type == 'cpu':
        return bias_snake_plain(h, bias)
    if h.device.type != 'cuda' or bias.device != h.device:
        raise RuntimeError(f'bias_snake: unsupported devices {h.device}, '
                           f'{bias.device}')
    return _BiasSnake.apply(h, bias)
