"""K3: the contextual-loss similarity chain, forward and backward in CUDA C++
(csrc/cx_chain.cu).

Replaces the cosine chain of `npp_tpu/losses/contextual.py:21-130` from the
normalised features to the per-target column maximum, which XLA fuses:

    s = xn yn^T;  d = 1 - clamp(s, 0, 1) (1e9 in masked columns)
    c = row-softmax of (1 - d / (min_q d + 1e-5)) / h
    z_q = max_p fx_p c_pq

and its gradient in xn and yn. The kernel never writes the (N, P, Q)
matrices: each of its sweeps recomputes its tile of s from xn and yn
(the source note gives the design). The mean shift and the normalisation
before it and the mean and log after it stay plain PyTorch
(losses/contextual.py).

A CUDA tensor goes through the kernel or the call raises; a CPU tensor goes
through `cx_colmax_plain` with autograd. The products run with TF32 tensor
cores when `torch.backends.cuda.matmul.allow_tf32` is set at the forward's
launch (device.py::matmul_precision sets it for the fits), in f32
otherwise; the backward recomputes s in the forward's precision, so that
it finds the forward's ties.
"""
import collections
import ctypes
import functools
from typing import Optional

import torch

from .build import check_cuda, load_library, sm_count

# launches by direction and shape, keyed 'cx_chain_fwd[NxPxQxC]' and
# 'cx_chain_bwd[NxPxQxC]'
LAUNCHES = collections.Counter()
EPS = 1e-5        # the relative distance's
MASKED = 1e9      # a masked column's distance
MAX_CHANNELS = 512
TILE = 32         # rows of a tile of the kernel
PREC_F32, PREC_TF32 = 0, 1   # csrc/cx_chain.cu's Prec


def compute_relative_distance(dist_raw: torch.Tensor) -> torch.Tensor:
    dist_min = torch.amin(dist_raw, dim=2, keepdim=True)
    return dist_raw / (dist_min + EPS)


def compute_cx(dist_tilde: torch.Tensor, band_width: float) -> torch.Tensor:
    w = torch.exp((1.0 - dist_tilde) / band_width)
    return w / torch.sum(w, dim=2, keepdim=True)


def colmax_of_distance(dist_raw: torch.Tensor, band_width: float,
                       feat_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(N, P, Q) distances -> z (N, Q): masked columns at 1e9, the relative
    distance, the row softmax and the column max over the (masked) rows,
    as npp_tpu/losses/contextual.py:102-124 computes them."""
    if feat_valid is not None:
        fv = feat_valid.to(dist_raw.dtype)
        dist_raw = torch.where(feat_valid[:, None, :] > 0, dist_raw,
                               torch.full_like(dist_raw, MASKED))
    cx = compute_cx(compute_relative_distance(dist_raw), band_width)
    if feat_valid is not None:
        return torch.amax(cx * fv[:, :, None], dim=1)
    return torch.amax(cx, dim=1)


def cx_colmax_plain(xn: torch.Tensor, yn: torch.Tensor, band_width: float,
                    feat_valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The chain in PyTorch: xn (N, P, C), yn (N, Q, C) normalised rows,
    feat_valid (N, P) with P = Q or None -> z (N, Q). It holds the (N, P, Q)
    matrices."""
    sim = torch.bmm(xn, yn.transpose(1, 2))
    return colmax_of_distance(1.0 - torch.clamp(sim, 0.0, 1.0), band_width,
                              feat_valid)


def _key(kind, n, p, q, c) -> str:
    return f'cx_chain_{kind}[{n}x{p}x{q}x{c}]'


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library('cx_chain')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.npp_cx_chain_fwd.argtypes = [ptr] * 10 + [i32] * 5 + [
        ctypes.c_float, i32, ptr]
    lib.npp_cx_chain_fwd.restype = i32
    lib.npp_cx_chain_bwd.argtypes = [ptr] * 16 + [i32] * 5 + [
        ctypes.c_float, i32, ptr]
    lib.npp_cx_chain_bwd.restype = i32
    return lib


def splits_for(n: int, p: int, q: int, sms: int) -> int:
    """How many blocks share one row's (or column's) streamed tiles: enough
    that a sweep has about eight blocks of 32 rows per SM in flight
    (the flagship's 6 x 1,600 has 300 without splitting), each with at
    least four tiles, and none left without a tile in either sweep
    (csrc/cx_chain.cu's split_range gives split z the tiles from
    z * ceil(tiles / splits))."""
    blocks = n * -(-max(p, q) // TILE)
    splits = max(1, min(-(-8 * sms // blocks), -(-min(p, q) // TILE) // 4))
    while splits > 1 and any((splits - 1) * -(-nt // splits) >= nt
                             for nt in (-(-p // TILE), -(-q // TILE))):
        splits -= 1
    return splits


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _scratch(n, p, q, splits, dev):
    """The splits' partial row / column terms and counts (None with one)."""
    if splits == 1:
        return None, None
    r = n * max(p, q)
    return (torch.empty((splits, 3, r), dtype=torch.float32, device=dev),
            torch.empty((splits, r), dtype=torch.int32, device=dev))


def cx_fwd_launch(xn, yn, feat_valid, band_width, prec, splits=None):
    """z (N, Q) and the forward's saved rows (m, l, s), columns (k) and
    splits on the card; csrc/cx_chain.cu's three sweeps at precision
    `prec` (PREC_F32, PREC_TF32), `splits` blocks a row (splits_for's by
    default)."""
    n, p, c = xn.shape
    q = yn.shape[1]
    dev = xn.device
    if splits is None:
        splits = splits_for(n, p, q, sm_count(dev.index))
    rows = torch.empty((2, n, p), dtype=torch.float32, device=dev)
    z = torch.empty((n, q), dtype=torch.float32, device=dev)
    l = torch.empty((n, p), dtype=torch.int32, device=dev)
    k = torch.empty((n, q), dtype=torch.int32, device=dev)
    m, s = rows[0], rows[1]
    part, partc = _scratch(n, p, q, splits, dev)
    status = _lib().npp_cx_chain_fwd(
        xn.data_ptr(), yn.data_ptr(), _ptr(feat_valid), m.data_ptr(),
        l.data_ptr(), s.data_ptr(), z.data_ptr(), k.data_ptr(),
        _ptr(part), _ptr(partc), n, p, q, c, splits, band_width, prec,
        torch.cuda.current_stream(dev).cuda_stream)
    check_cuda(status, 'cx_chain_fwd')
    LAUNCHES[_key('fwd', n, p, q, c)] += 1
    return z, (m, l, s, k, splits)


def cx_bwd_launch(g, xn, yn, feat_valid, saved, z, band_width, prec,
                  need_dx=True, need_dy=True):
    """(dxn, dyn) from g = dL/dz (N, Q) on the card, each None where not
    needed; csrc/cx_chain.cu's backward sweeps, at the forward's precision
    and splits."""
    n, p, c = xn.shape
    q = yn.shape[1]
    m, l, s, k, splits = saved
    g = g.contiguous()
    dev = xn.device
    terms = torch.empty((2, n, p), dtype=torch.float32, device=dev)
    dx = torch.empty_like(xn) if need_dx else None
    dy = torch.empty_like(yn) if need_dy else None
    part, partc = _scratch(n, p, q, splits, dev)
    gpart = torch.empty((splits, n * max(p, q) * c), dtype=torch.float32,
                        device=dev) if splits > 1 else None
    status = _lib().npp_cx_chain_bwd(
        xn.data_ptr(), yn.data_ptr(), _ptr(feat_valid), m.data_ptr(),
        l.data_ptr(), s.data_ptr(), z.data_ptr(), k.data_ptr(),
        g.data_ptr(), terms[0].data_ptr(), terms[1].data_ptr(), _ptr(dx),
        _ptr(dy), _ptr(part), _ptr(partc), _ptr(gpart), n, p, q, c, splits,
        band_width, prec, torch.cuda.current_stream(dev).cuda_stream)
    check_cuda(status, 'cx_chain_bwd')
    LAUNCHES[_key('bwd', n, p, q, c)] += 1
    return dx, dy


class _CxColmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xn, yn, feat_valid, band_width):
        prec = PREC_TF32 if torch.backends.cuda.matmul.allow_tf32 \
            else PREC_F32
        z, (*saved, splits) = cx_fwd_launch(xn, yn, feat_valid, band_width,
                                            prec)
        ctx.save_for_backward(xn, yn, feat_valid, z, *saved)
        ctx.band_width, ctx.prec, ctx.splits = band_width, prec, splits
        return z

    @staticmethod
    def backward(ctx, g):
        xn, yn, feat_valid, z, *saved = ctx.saved_tensors
        need_dx, need_dy = ctx.needs_input_grad[:2]
        dx, dy = cx_bwd_launch(g, xn, yn, feat_valid, (*saved, ctx.splits),
                               z, ctx.band_width, ctx.prec, need_dx, need_dy)
        return dx, dy, None, None


def cx_colmax(xn: torch.Tensor, yn: torch.Tensor, band_width: float,
              feat_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z (N, Q) = max over p of fx_p * c_pq, the CX chain from the
    normalised rows xn (N, P, C) and yn (N, Q, C); feat_valid (N, P), with
    P = Q, masks the rows and the columns. Differentiable in xn and yn. On
    the card: K3, f32 only, C a multiple of 32 up to 512."""
    kinds = {t.device.type for t in (xn, yn, feat_valid) if t is not None}
    if kinds == {'cpu'}:
        return cx_colmax_plain(xn, yn, band_width, feat_valid)
    if kinds != {'cuda'}:
        raise RuntimeError(f'cx_colmax: unsupported devices {kinds}')
    if xn.dim() != 3 or yn.dim() != 3 or xn.shape[0] != yn.shape[0] or \
            xn.shape[2] != yn.shape[2]:
        raise ValueError('cx_colmax takes xn (N, P, C) and yn (N, Q, C)')
    n, p, c = xn.shape
    if feat_valid is not None and (feat_valid.shape != (n, p) or
                                   yn.shape[1] != p):
        raise ValueError('cx_colmax: feat_valid is (N, P) and needs P = Q')
    if any(t.dtype != torch.float32 for t in (xn, yn, feat_valid)
           if t is not None):
        raise ValueError('cx_colmax takes float32 tensors')
    if c % 32 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f'cx_colmax on the card takes C a multiple of 32 '
                         f'up to {MAX_CHANNELS}, not {c}')
    if feat_valid is not None:
        feat_valid = feat_valid.detach().contiguous()
    return _CxColmax.apply(xn.contiguous(), yn.contiguous(), feat_valid,
                           float(band_width))
