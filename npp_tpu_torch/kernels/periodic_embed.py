"""K1 wrapper: periodic + Fourier embedding (csrc/periodic_embed.cu).

Replaces the XLA-fused `TaskEmbedder.embed` (npp_tpu/nn/embedder.py:87-162)
and, written in bfloat16, `make_embedding_table`'s `.astype(jnp.bfloat16)`
of it. Memory-bound: the output write is the whole cost (see the source's
note). With the warp field on the coordinates are learned: where they
require a gradient, the f32 embedding is a `torch.autograd.Function` whose
backward is K1's backward kernel (`npp_periodic_embed_bwd`, the gradient in
the coordinates; angles, periods and bands are constants).

`periodic_embed_batched` embeds B images in one launch of the batched
entries (the multi-image fit, parallel/batch.py): coordinates (B, N, 2),
each image's proposals (B, K, 2) and normalisation dims (B, 2) on the card,
so that no launch copies anything from the host.

A CUDA tensor goes through the kernels or the call raises; a CPU tensor goes
through `periodic_embed_plain` (`periodic_embed_batched_plain`), the same
function in plain PyTorch (its coordinate gradient by autograd).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from .build import check_cuda, load_library

# the forward counts by output shape ('periodic_embed[81920x1386]'), which
# kernels.launch_counts() also sums under the name
LAUNCHES = collections.Counter({'periodic_embed': 0, 'periodic_embed_bf16': 0,
                                'periodic_embed_bwd': 0,
                                'periodic_embed_batched': 0,
                                'periodic_embed_batched_bf16': 0,
                                'periodic_embed_batched_bwd': 0})
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = load_library('periodic_embed')
    fn = lib.npp_periodic_embed
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, i, p, i, p, i, ctypes.c_longlong, i,
                       ctypes.c_float, ctypes.c_float, p, i, p]
        fn.restype = ctypes.c_int
        bwd = lib.npp_periodic_embed_bwd
        bwd.argtypes = [p, p, p, p, p, i, p, i, p, i, p, i, ctypes.c_longlong,
                        i, ctypes.c_float, ctypes.c_float, p, p]
        bwd.restype = ctypes.c_int
        fwd_b = lib.npp_periodic_embed_batched
        fwd_b.argtypes = [p, p, p, p, i, p, i, p, i, p, i, p,
                          ctypes.c_longlong, i, i, p, i, p]
        fwd_b.restype = ctypes.c_int
        bwd_b = lib.npp_periodic_embed_bwd_batched
        bwd_b.argtypes = [p, p, p, p, p, i, p, i, p, i, p, i, p,
                          ctypes.c_longlong, i, i, p, p]
        bwd_b.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _device_vector(values: Tuple[float, ...], dev: torch.device
                   ) -> torch.Tensor:
    """A tuple of the config as an f32 vector on `dev`, copied once rather
    than on every launch."""
    return torch.tensor(values, dtype=torch.float32, device=dev)


def embed_dims(n_bands: int, n_scales: int, n_offsets: int,
               n_angle_offsets: int) -> Tuple[int, int]:
    """(periodic channels P per proposal, output channels D per proposal)."""
    p = 2 * (1 + n_scales * n_offsets * n_angle_offsets * 2)
    return p, p * (1 + 2 * n_bands)


def periodic_embed_plain(coords_yx: torch.Tensor, angles: torch.Tensor,
                         periods: torch.Tensor, bands: Optional[torch.Tensor],
                         freq_scales: Sequence[float],
                         freq_offsets: Sequence[float],
                         angle_offsets: Sequence[float],
                         res: Tuple[int, int],
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: periodic_warp of each
    proposal, Fourier re-encoded, proposal-major (embedder.py:149-162),
    computed in the inputs' dtype and rounded to `out_dtype`."""
    from ..nn.embedder import fourier_encode, periodic_warp
    per = []
    for k in range(angles.shape[0]):
        p = periodic_warp(coords_yx, angles[k], periods[k], freq_scales,
                          freq_offsets, angle_offsets, res,
                          include_input=True)
        per.append(p if bands is None else fourier_encode(p, bands))
    return torch.cat(per, dim=-1).to(out_dtype)


def periodic_embed_batched_plain(coords_yx: torch.Tensor,
                                 angles: torch.Tensor, periods: torch.Tensor,
                                 bands: Optional[torch.Tensor],
                                 freq_scales: Sequence[float],
                                 freq_offsets: Sequence[float],
                                 angle_offsets: Sequence[float],
                                 res: torch.Tensor,
                                 out_dtype: torch.dtype = torch.float32
                                 ) -> torch.Tensor:
    """The batched kernels' function in plain PyTorch: coords (B, N, 2),
    angles and periods (B, K, 2), res (B, 2) -> (B, N, K * D), image b
    equal to periodic_embed_plain of its own rows, proposals and dims."""
    from ..nn.embedder import fourier_encode, periodic_warp
    hw = (res[:, 0, None, None], res[:, 1, None, None])
    per = []
    for k in range(angles.shape[1]):
        p = periodic_warp(coords_yx, angles[:, k], periods[:, k], freq_scales,
                          freq_offsets, angle_offsets, hw, include_input=True)
        per.append(p if bands is None else fourier_encode(p, bands))
    return torch.cat(per, dim=-1).to(out_dtype)


class _Args:
    """The kernels' constant arguments on the card, checked once per call.
    With `res` a tensor, the batched form: coords (B, N, 2), angles and
    periods (B, K, 2), res (B, 2)."""

    def __init__(self, coords_yx, angles, periods, bands, freq_scales,
                 freq_offsets, angle_offsets, res):
        dev = coords_yx.device
        if dev.type != 'cuda':
            raise RuntimeError(f'periodic_embed: unsupported device {dev}')
        self.nb = int(coords_yx.shape[0]) if torch.is_tensor(res) else 0
        lead = (self.nb,) if self.nb else ()
        if coords_yx.dim() != len(lead) + 2 or coords_yx.shape[-1] != 2:
            raise ValueError(f'coords must be {"(B, N, 2)" if lead else "(N, 2)"}'
                             f', got {tuple(coords_yx.shape)}')
        self.k = angles.shape[-2]
        if angles.shape != lead + (self.k, 2) or \
                periods.shape != lead + (self.k, 2):
            raise ValueError('angles and periods must both be '
                             f'{"(B, K, 2)" if lead else "(K, 2)"}')
        if self.nb and res.shape != (self.nb, 2):
            raise ValueError(f'res must be (B, 2), got {tuple(res.shape)}')

        def vec(v):
            if not torch.is_tensor(v):      # a tuple of the config: copied once
                return _device_vector(tuple(float(x) for x in v), dev)
            return v.to(device=dev, dtype=torch.float32).contiguous()

        self.dev = dev
        self.ang, self.per = vec(angles), vec(periods)
        self.n_bands = 0 if bands is None else int(bands.shape[0])
        self.bnd = vec(bands) if self.n_bands else _device_vector((0.0,), dev)
        self.sc, self.off, self.aoff = (vec(freq_scales), vec(freq_offsets),
                                        vec(angle_offsets))
        self.counts = (len(freq_scales), len(freq_offsets),
                       len(angle_offsets))
        self.d = embed_dims(self.n_bands, *self.counts)[1]
        if self.nb:
            # a device tensor already (stack_embedders): no copy per launch
            self.res_t = vec(res)
        else:
            self.res = (float(res[0]), float(res[1]))

    def consts(self):
        """The C functions' arguments from angles to angle_offsets."""
        return (self.ang.data_ptr(), self.per.data_ptr(), self.bnd.data_ptr(),
                self.n_bands, self.sc.data_ptr(), self.counts[0],
                self.off.data_ptr(), self.counts[1], self.aoff.data_ptr(),
                self.counts[2])


def _fwd_launch(coords: torch.Tensor, a: _Args,
                out_dtype: torch.dtype) -> torch.Tensor:
    n = coords.shape[0]
    out = torch.empty((n, a.k * a.d), dtype=out_dtype, device=a.dev)
    bf16 = out_dtype == torch.bfloat16
    status = _lib().npp_periodic_embed(
        coords.data_ptr(), *a.consts(), n, a.k, *a.res, out.data_ptr(),
        int(bf16), torch.cuda.current_stream(a.dev).cuda_stream)
    check_cuda(status, 'periodic_embed')
    name = 'periodic_embed_bf16' if bf16 else 'periodic_embed'
    LAUNCHES[f'{name}[{n}x{a.k * a.d}]'] += 1
    return out


def periodic_embed_bwd_launch(grad: torch.Tensor, coords: torch.Tensor,
                              a: _Args) -> torch.Tensor:
    """dL/d(y, x) (N, 2) from the f32 embedding's gradient (N, K * D) on
    the card: K1's backward kernel."""
    grad = grad.to(torch.float32).contiguous()
    n = coords.shape[0]
    if grad.shape != (n, a.k * a.d):
        raise ValueError(f'grad must be {(n, a.k * a.d)}, got '
                         f'{tuple(grad.shape)}')
    dcoords = torch.empty((n, 2), dtype=torch.float32, device=a.dev)
    status = _lib().npp_periodic_embed_bwd(
        grad.data_ptr(), coords.data_ptr(), *a.consts(), n, a.k, *a.res,
        dcoords.data_ptr(), torch.cuda.current_stream(a.dev).cuda_stream)
    check_cuda(status, 'periodic_embed_bwd')
    LAUNCHES['periodic_embed_bwd'] += 1
    return dcoords


def _fwd_batched_launch(coords: torch.Tensor, a: _Args,
                        out_dtype: torch.dtype) -> torch.Tensor:
    n = coords.shape[1]
    out = torch.empty((a.nb, n, a.k * a.d), dtype=out_dtype, device=a.dev)
    bf16 = out_dtype == torch.bfloat16
    status = _lib().npp_periodic_embed_batched(
        coords.data_ptr(), *a.consts(), a.res_t.data_ptr(), n, a.k, a.nb,
        out.data_ptr(), int(bf16), torch.cuda.current_stream(a.dev).cuda_stream)
    check_cuda(status, 'periodic_embed_batched')
    name = 'periodic_embed_batched_bf16' if bf16 else 'periodic_embed_batched'
    LAUNCHES[f'{name}[{a.nb}x{n}x{a.k * a.d}]'] += 1
    return out


def periodic_embed_bwd_batched_launch(grad: torch.Tensor,
                                      coords: torch.Tensor,
                                      a: _Args) -> torch.Tensor:
    """dL/d(y, x) (B, N, 2) from the f32 embeddings' gradient
    (B, N, K * D) on the card: K1's batched backward kernel."""
    grad = grad.to(torch.float32).contiguous()
    n = coords.shape[1]
    if grad.shape != (a.nb, n, a.k * a.d):
        raise ValueError(f'grad must be {(a.nb, n, a.k * a.d)}, got '
                         f'{tuple(grad.shape)}')
    dcoords = torch.empty((a.nb, n, 2), dtype=torch.float32, device=a.dev)
    status = _lib().npp_periodic_embed_bwd_batched(
        grad.data_ptr(), coords.data_ptr(), *a.consts(), a.res_t.data_ptr(),
        n, a.k, a.nb, dcoords.data_ptr(),
        torch.cuda.current_stream(a.dev).cuda_stream)
    check_cuda(status, 'periodic_embed_bwd_batched')
    LAUNCHES['periodic_embed_batched_bwd'] += 1
    return dcoords


class _PeriodicEmbedBatched(torch.autograd.Function):
    """K1's batched forward in f32; its backward is the batched backward
    kernel, in the coordinates only."""

    @staticmethod
    def forward(ctx, coords, a):
        ctx.save_for_backward(coords)
        ctx.args = a
        return _fwd_batched_launch(coords, a, torch.float32)

    @staticmethod
    def backward(ctx, grad):
        (coords,) = ctx.saved_tensors
        return periodic_embed_bwd_batched_launch(grad, coords, ctx.args), None


class _PeriodicEmbed(torch.autograd.Function):
    """K1 forward in f32; its backward is K1's backward kernel, in the
    coordinates only."""

    @staticmethod
    def forward(ctx, coords, a):
        ctx.save_for_backward(coords)
        ctx.args = a
        return _fwd_launch(coords, a, torch.float32)

    @staticmethod
    def backward(ctx, grad):
        (coords,) = ctx.saved_tensors
        return periodic_embed_bwd_launch(grad, coords, ctx.args), None


def periodic_embed(coords_yx: torch.Tensor, angles: torch.Tensor,
                   periods: torch.Tensor, bands: Optional[torch.Tensor],
                   freq_scales: Sequence[float], freq_offsets: Sequence[float],
                   angle_offsets: Sequence[float],
                   res: Tuple[int, int],
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """coords (N, 2) f32 (y, x) -> (N, K * D) in out_dtype (float32 or
    bfloat16, computed in f32 and rounded to nearest even). angles, periods
    (K, 2); bands (F,) or None for the identity Fourier stage.
    Differentiable in the coordinates in float32."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'periodic_embed writes {OUT_DTYPES}, not {out_dtype}')
    if coords_yx.device.type == 'cpu':
        return periodic_embed_plain(coords_yx, angles, periods, bands,
                                    freq_scales, freq_offsets, angle_offsets,
                                    res, out_dtype)
    a = _Args(coords_yx, angles, periods, bands, freq_scales, freq_offsets,
              angle_offsets, res)
    coords = coords_yx.to(torch.float32).contiguous()
    if coords.requires_grad and torch.is_grad_enabled():
        if out_dtype != torch.float32:
            raise ValueError('periodic_embed is differentiable in float32 '
                             'only')
        return _PeriodicEmbed.apply(coords, a)
    return _fwd_launch(coords, a, out_dtype)


def periodic_embed_batched(coords_yx: torch.Tensor, angles: torch.Tensor,
                           periods: torch.Tensor,
                           bands: Optional[torch.Tensor],
                           freq_scales: Sequence[float],
                           freq_offsets: Sequence[float],
                           angle_offsets: Sequence[float], res: torch.Tensor,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """B images at once: coords (B, N, 2) f32 (y, x), angles and periods
    (B, K, 2), res (B, 2) each image's (h, w) -> (B, N, K * D) in
    out_dtype, in one launch. Differentiable in the coordinates in
    float32."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f'periodic_embed writes {OUT_DTYPES}, not {out_dtype}')
    if coords_yx.device.type == 'cpu':
        return periodic_embed_batched_plain(coords_yx, angles, periods, bands,
                                            freq_scales, freq_offsets,
                                            angle_offsets, res, out_dtype)
    a = _Args(coords_yx, angles, periods, bands, freq_scales, freq_offsets,
              angle_offsets, res)
    coords = coords_yx.to(torch.float32).contiguous()
    if coords.requires_grad and torch.is_grad_enabled():
        if out_dtype != torch.float32:
            raise ValueError('periodic_embed is differentiable in float32 '
                             'only')
        return _PeriodicEmbedBatched.apply(coords, a)
    return _fwd_batched_launch(coords, a, out_dtype)
