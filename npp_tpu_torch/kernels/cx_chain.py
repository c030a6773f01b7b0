"""K3: the contextual-loss similarity chain, forward and backward in CUDA C++
(csrc/cx_chain.cu).

Replaces the chain of `npp_tpu/losses/contextual.py:21-130` from the
distances to the per-target column maximum, which XLA fuses:

    d = 1 - clamp(xn yn^T, 0, 1)                cosine (`cx_colmax`)
        max(|y_q|^2 - 2 x_p . y_q + |x_p|^2, 0)  l2 (`cx_colmax_l2`)
        |xs_p - ys_q| of the channel sums        l1 (`cx_colmax_l1`)
    (1e9 in masked columns)
    c = row-softmax of (1 - d / (min_q d + 1e-5)) / h
    z_q = max_p fx_p c_pq

and its gradient. The kernel computes the product s = x y^T once per
forward into a device scratch that the wrapper allocates here, and the
backward works from the saved s (the source note gives the design). The
mean shift and the normalisation before the cosine chain, the channel
sums of l1 and the mean and log after the chain stay plain PyTorch
(losses/contextual.py).

A CUDA tensor goes through the kernel or the call raises; a CPU tensor goes
through the plain version (`cx_colmax_plain`, `cx_colmax_l2_plain`,
`cx_colmax_l1_plain`) with autograd. The products run with TF32 tensor
cores when `torch.backends.cuda.matmul.allow_tf32` is set at the forward's
launch (device.py::matmul_precision sets it for the fits), in f32
otherwise; the backward repeats the forward's precision.
"""
import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .build import check_cuda, load_library

# launches by form, direction and shape: 'cx_chain_fwd[NxPxQxC]' and
# 'cx_chain_bwd[NxPxQxC]' for the cosine form, 'cx_chain_l2_fwd[...]' and
# so on for the l2 and l1 forms (l1 with C = 1, its channel sums)
LAUNCHES = collections.Counter()
EPS = 1e-5        # the relative distance's
MASKED = 1e9      # a masked column's distance
MAX_CHANNELS = 512
PITCH = 32        # the scratches' rows are padded to a multiple of this
COL_ROWS = 64     # rows of s a block of the column pass reads (kColRows)
PRODUCT_TILE = 128  # rows and columns of a product's output tile
PREC_F32, PREC_TF32 = 0, 1   # csrc/cx_chain.cu's Prec
MODES = {'cosine': 0, 'l2': 1, 'l1': 2}   # csrc/cx_chain.cu's Mode


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


def l2_distance_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (N, P, C), y (N, Q, C) -> squared euclidean distances (N, P, Q),
    as npp_tpu/losses/contextual.py:61-69 computes them."""
    x_s = torch.sum(x ** 2, dim=-1)
    y_s = torch.sum(y ** 2, dim=-1)
    ab = torch.bmm(x, y.transpose(1, 2))
    return torch.clamp(y_s[:, None, :] - 2 * ab + x_s[:, :, None], min=0.0)


def l1_distance_sums(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Channel sums xs (N, P), ys (N, Q) -> |xs_p - ys_q| (N, P, Q), as
    npp_tpu/losses/contextual.py:49-58 computes it."""
    return torch.clamp(torch.abs(xs[:, :, None] - ys[:, None, :]), min=0.0)


def cx_colmax_plain(xn: torch.Tensor, yn: torch.Tensor, band_width: float,
                    feat_valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The cosine chain in PyTorch: xn (N, P, C), yn (N, Q, C) normalised
    rows, feat_valid (N, P) with P = Q or None -> z (N, Q). It holds the
    (N, P, Q) matrices."""
    sim = torch.bmm(xn, yn.transpose(1, 2))
    return colmax_of_distance(1.0 - torch.clamp(sim, 0.0, 1.0), band_width,
                              feat_valid)


def cx_colmax_l2_plain(x, y, band_width, feat_valid=None):
    """The l2 chain in PyTorch: raw rows x (N, P, C), y (N, Q, C)."""
    return colmax_of_distance(l2_distance_rows(x, y), band_width, feat_valid)


def cx_colmax_l1_plain(xs, ys, band_width, feat_valid=None):
    """The l1 chain in PyTorch: channel sums xs (N, P), ys (N, Q)."""
    return colmax_of_distance(l1_distance_sums(xs, ys), band_width,
                              feat_valid)


PLAIN = {'cosine': cx_colmax_plain, 'l2': cx_colmax_l2_plain,
         'l1': cx_colmax_l1_plain}


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


class Plan(NamedTuple):
    """The kernel's geometry at (N, P, Q, C) and the buffers each direction
    allocates (the launchers allocate exactly these)."""
    n: int
    p: int
    q: int
    c: int
    ld: int      # s, G and y^T rows: Q rounded up to PITCH
    ldt: int     # G^T and x^T rows: P rounded up to PITCH
    chunks: int  # the column pass's blocks of COL_ROWS rows

    def product_tiles(self, m: int, ncols: int) -> int:
        """128 x 128 output tiles of one product of (N, m, ncols)."""
        return self.n * -(-m // PRODUCT_TILE) * -(-ncols // PRODUCT_TILE)

    def forward_buffers(self, mode: str, prec: int) -> dict:
        """name: (shape, dtype) of s, the row statistics m and S, the tie
        counts l and k, z, the column pass's partials and, with TF32, the
        rounded copies of x and y."""
        n, p, q, c = self.n, self.p, self.q, self.c
        f32, i32 = torch.float32, torch.int32
        out = dict(s=((n, p, self.ld), f32), stats=((2, n, p), f32),
                   l=((n, p), i32), z=((n, q), f32), k=((n, q), i32),
                   cmax=((self.chunks, n, q), f32),
                   ccnt=((self.chunks, n, q), i32))
        if prec == PREC_TF32 and mode != 'l1':
            out.update(xs=((n, p, c), f32), ys=((n, q, c), f32))
        return out

    def backward_buffers(self, mode: str, need_dx: bool, need_dy: bool
                         ) -> dict:
        """name: (shape, dtype) of the row terms A and B / l; for the
        products (cosine, l2) G with y^T and dx, G^T with x^T and dy, as
        wanted; the partial sums (l2, l1)."""
        n, p, q, c = self.n, self.p, self.q, self.c
        f32 = torch.float32
        out = dict(terms=((2, n, p), f32))
        if mode != 'l1':
            if need_dx:
                out.update(gx=((n, p, self.ld), f32),
                           ys=((n, c, self.ld), f32), dx=((n, p, c), f32))
            if need_dy:
                out.update(gy=((n, q, self.ldt), f32),
                           xs=((n, c, self.ldt), f32), dy=((n, q, c), f32))
        if mode != 'cosine':
            out.update(rsum=((n, p, self.ld // PITCH), f32),
                       csum=((n, q, self.ldt // PITCH), f32))
        return out


def buffer_bytes(buffers: dict) -> dict:
    """name: bytes of a Plan's buffers."""
    return {name: math.prod(shape) * dtype.itemsize
            for name, (shape, dtype) in buffers.items()}


def _allocate(buffers: dict, dev) -> dict:
    return {name: torch.empty(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in buffers.items()}


def plan(n: int, p: int, q: int, c: int) -> Plan:
    return Plan(n, p, q, c, _round_up(q, PITCH), _round_up(p, PITCH),
                -(-p // COL_ROWS))


class Saved(NamedTuple):
    """What the forward keeps for the backward: s and the chain's row and
    column statistics."""
    s: torch.Tensor      # (N, P, ld)
    m: torch.Tensor      # (N, P) row min of d
    l: torch.Tensor      # (N, P) int32, columns tied at the min
    sum: torch.Tensor    # (N, P) row sum of w
    k: torch.Tensor      # (N, Q) int32, rows tied at the max


_POINTERS = ('x', 'y', 'xx', 'yy', 'f', 'xs', 'ys', 's', 'm', 'l', 'sum', 'z',
             'k', 'cmax', 'ccnt', 'g', 'a', 'bl', 'gx', 'gy', 'rsum', 'csum',
             'dx', 'dy')


class _Args(ctypes.Structure):
    """csrc/cx_chain.cu's CxArgs, field for field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _POINTERS] +
                [(f, ctypes.c_int) for f in ('n', 'p', 'q', 'c', 'ld', 'ldt',
                                             'mode', 'prec')] +
                [('h', ctypes.c_float)])


def _key(mode, kind, n, p, q, c) -> str:
    form = '' if mode == 'cosine' else f'{mode}_'
    return f'cx_chain_{form}{kind}[{n}x{p}x{q}x{c}]'


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library('cx_chain')
    for fn in (lib.npp_cx_chain_fwd, lib.npp_cx_chain_bwd):
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _args(pl: Plan, mode: str, prec: int, band_width: float, **tensors
          ) -> _Args:
    args = _Args(n=pl.n, p=pl.p, q=pl.q, c=pl.c, ld=pl.ld, ldt=pl.ldt,
                 mode=MODES[mode], prec=prec, h=band_width)
    for name, t in tensors.items():
        if t is not None:
            setattr(args, name, t.data_ptr())
    return args


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _shape(x, y, mode):
    n, p = x.shape[:2]
    return n, p, y.shape[1], 1 if mode == 'l1' else x.shape[2]


def cx_fwd_launch(x, y, feat_valid, band_width, prec, mode='cosine',
                  xx=None, yy=None, keep=True):
    """z (N, Q) on the card, and with `keep` the Saved state for the
    backward (else None): csrc/cx_chain.cu's forward in `mode` at precision
    `prec` (PREC_F32, PREC_TF32). x, y are the rows (l1: the channel sums);
    xx, yy the rows' squared norms for l2."""
    n, p, q, c = _shape(x, y, mode)
    pl = plan(n, p, q, c)
    b = _allocate(pl.forward_buffers(mode, prec), x.device)
    m, total = b['stats']
    args = _args(pl, mode, prec, band_width, x=x, y=y, xx=xx, yy=yy,
                 f=feat_valid, xs=b.get('xs'), ys=b.get('ys'), s=b['s'], m=m,
                 l=b['l'], sum=total, z=b['z'], k=b['k'], cmax=b['cmax'],
                 ccnt=b['ccnt'])
    check_cuda(_lib().npp_cx_chain_fwd(ctypes.byref(args),
                                       _stream(x.device)), 'cx_chain_fwd')
    LAUNCHES[_key(mode, 'fwd', n, p, q, c)] += 1
    return b['z'], (Saved(b['s'], m, b['l'], total, b['k']) if keep
                    else None)


def cx_bwd_launch(g, x, y, feat_valid, saved: Saved, z, band_width, prec,
                  mode='cosine', xx=None, yy=None, need_dx=True,
                  need_dy=True):
    """From g = dL/dz (N, Q) on the card, csrc/cx_chain.cu's backward at the
    forward's precision: (dx, dy, rsum, csum). dx, dy: the products G y and
    G^T x (cosine, l2; None where not needed or for l1); rsum (N, P),
    csum (N, Q): the sums of G over q and over p (l2), of dL/dd sgn(s) (l1);
    None for the cosine form."""
    n, p, q, c = _shape(x, y, mode)
    pl = plan(n, p, q, c)
    g = g.contiguous()
    b = _allocate(pl.backward_buffers(mode, need_dx, need_dy), x.device)
    args = _args(pl, mode, prec, band_width, x=x, y=y, xx=xx, yy=yy,
                 f=feat_valid, s=saved.s, m=saved.m, l=saved.l,
                 sum=saved.sum, z=z, k=saved.k, g=g, a=b['terms'][0],
                 bl=b['terms'][1], **{name: b.get(name) for name in (
                     'xs', 'ys', 'gx', 'gy', 'rsum', 'csum', 'dx', 'dy')})
    check_cuda(_lib().npp_cx_chain_bwd(ctypes.byref(args),
                                       _stream(x.device)), 'cx_chain_bwd')
    LAUNCHES[_key(mode, 'bwd', n, p, q, c)] += 1
    sums = [b[name].sum(-1) if name in b else None
            for name in ('rsum', 'csum')]
    return (b.get('dx'), b.get('dy'), *sums)


def _norms(x, y, mode):
    if mode != 'l2':
        return None, None
    return torch.sum(x ** 2, dim=-1), torch.sum(y ** 2, dim=-1)


class _CxColmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, feat_valid, band_width, mode, keep):
        prec = PREC_TF32 if torch.backends.cuda.matmul.allow_tf32 and \
            mode != 'l1' else PREC_F32
        xx, yy = _norms(x, y, mode)
        z, saved = cx_fwd_launch(x, y, feat_valid, band_width, prec, mode,
                                 xx, yy, keep)
        if keep:
            ctx.save_for_backward(x, y, feat_valid, z, xx, yy, *saved)
        ctx.band_width, ctx.prec, ctx.mode = band_width, prec, mode
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, feat_valid, z, xx, yy, *saved = ctx.saved_tensors
        mode = ctx.mode
        need_dx, need_dy = ctx.needs_input_grad[:2]
        dx, dy, rsum, csum = cx_bwd_launch(
            g, x, y, feat_valid, Saved(*saved), z, ctx.band_width, ctx.prec,
            mode, xx, yy, need_dx, need_dy)
        if mode == 'l2':
            # the norms' terms: d depends on |x_p|^2 and |y_q|^2 with the
            # weight -1/2 of its dependence on s
            if dx is not None:
                dx -= x * rsum[..., None]
            if dy is not None:
                dy -= y * csum[..., None]
        elif mode == 'l1':
            dx = -rsum if need_dx else None
            dy = csum if need_dy else None
        return dx, dy, None, None, None, None


def _on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds not in ({'cpu'}, {'cuda'}):
        raise RuntimeError(f'cx_colmax: unsupported devices {kinds}')
    return kinds == {'cuda'}


def _colmax(x, y, band_width, feat_valid, mode):
    if not _on_card(x, y, feat_valid):
        return PLAIN[mode](x, y, band_width, feat_valid)
    rank = 2 if mode == 'l1' else 3
    if x.dim() != rank or y.dim() != rank or x.shape[0] != y.shape[0] or \
            x.shape[2:] != y.shape[2:]:
        dims = ', C' * (rank - 2)
        raise ValueError(f'cx_colmax ({mode}) takes x (N, P{dims}) and y '
                         f'(N, Q{dims})')
    n, p = x.shape[:2]
    if feat_valid is not None and (feat_valid.shape != (n, p) or
                                   y.shape[1] != p):
        raise ValueError('cx_colmax: feat_valid is (N, P) and needs P = Q')
    if any(t.dtype != torch.float32 for t in (x, y, feat_valid)
           if t is not None):
        raise ValueError('cx_colmax takes float32 tensors')
    if rank == 3:
        c = x.shape[2]
        if c % 32 or not 0 < c <= MAX_CHANNELS:
            raise ValueError(f'cx_colmax on the card takes C a multiple of 32 '
                             f'up to {MAX_CHANNELS}, not {c}')
    x, y = x.contiguous(), y.contiguous()
    if rank == 3 and (x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError('cx_colmax on the card reads x and y 16 bytes at a '
                         'time: their data must start 16-byte aligned')
    if feat_valid is not None:
        feat_valid = feat_valid.detach().contiguous()
    keep = torch.is_grad_enabled() and (x.requires_grad or y.requires_grad)
    return _CxColmax.apply(x, y, feat_valid, float(band_width), mode, keep)


def cx_colmax(xn: torch.Tensor, yn: torch.Tensor, band_width: float,
              feat_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z (N, Q) = max over p of fx_p * c_pq, the cosine CX chain from the
    normalised rows xn (N, P, C) and yn (N, Q, C); feat_valid (N, P), with
    P = Q, masks the rows and the columns. Differentiable in xn and yn. On
    the card: K3, f32 only, C a multiple of 32 up to 512."""
    return _colmax(xn, yn, band_width, feat_valid, 'cosine')


def cx_colmax_l2(x: torch.Tensor, y: torch.Tensor, band_width: float,
                 feat_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain on squared euclidean distances of the raw rows x (N, P, C),
    y (N, Q, C); as cx_colmax otherwise."""
    return _colmax(x, y, band_width, feat_valid, 'l2')


def cx_colmax_l1(xs: torch.Tensor, ys: torch.Tensor, band_width: float,
                 feat_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The chain on |xs_p - ys_q| of the channel sums xs (N, P), ys (N, Q);
    as cx_colmax otherwise (no product, so no constraint on C)."""
    return _colmax(xs, ys, band_width, feat_valid, 'l1')
