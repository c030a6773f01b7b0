"""Positional encoders: Fourier (NeRF-style) and periodicity-aware warps.

PyTorch port of `npp_tpu/nn/embedder.py` (reference: models/embedder.py:6-148).
The plain tensor functions keep the JAX package's channel order exactly:
 - fourier_encode: [x, sin(f1 x), cos(f1 x), sin(f2 x), ...] with each block
   spanning all input channels (reference: embedder.py:41-44,56).
 - periodic_warp: [norm_x?, orient-0 fns..., norm_y?, orient-1 fns...] with
   fns ordered scale -> offset -> angle_offset -> (sin, cos)
   (reference: embedder.py:110-146).

Both embedders go through K1 (kernels/periodic_embed.py) for CUDA tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import nerf_embed_dim, periodic_embed_dim
from ..kernels.periodic_embed import periodic_embed


def gaussian_freq_bands(gen: torch.Generator, num_freqs: int,
                        scale: float = 10.0,
                        device: Optional[torch.device] = None) -> torch.Tensor:
    """Gaussian-sampled Fourier bands, N(0,1)*10 (reference: embedder.py:25-26).
    Drawn from a torch.Generator: the same distribution as the JAX package's
    keyed draw, not the same numbers (utils/convert.py carries bands across
    for exact parity)."""
    bands = torch.randn((num_freqs,), generator=gen) * scale
    return bands.to(device) if device is not None else bands


def log_freq_bands(num_freqs: int, max_freq_log2: float) -> torch.Tensor:
    """2^linspace bands (reference: embedder.py:23-24, sampling='log')."""
    return 2.0 ** torch.linspace(0.0, max_freq_log2, num_freqs)


def linear_freq_bands(num_freqs: int, max_freq_log2: float) -> torch.Tensor:
    """Linear bands (reference: embedder.py:38-39, default branch)."""
    return torch.linspace(2.0 ** 0.0, 2.0 ** max_freq_log2, num_freqs)


def fourier_encode(x: torch.Tensor, freq_bands: torch.Tensor,
                   include_input: bool = True) -> torch.Tensor:
    """x: (..., C) -> (..., C * (include_input + 2*len(freq_bands))),
    ordered [x, sin(f1 x), cos(f1 x), sin(f2 x), cos(f2 x), ...]."""
    xf = x[..., None, :] * freq_bands[:, None]          # (..., F, C)
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, C)
    sc = sc.reshape(*x.shape[:-1], -1)
    return torch.cat([x, sc], dim=-1) if include_input else sc


def normalize_coords(coords_yx: torch.Tensor, res: Tuple[int, int]) -> torch.Tensor:
    """Map pixel (y, x) coords to [-1, 1] (reference: embedder.py:52-55,112-113)."""
    h, w = res
    y = (coords_yx[..., 0] / h - 0.5) * 2.0
    x = (coords_yx[..., 1] / w - 0.5) * 2.0
    return torch.stack([y, x], dim=-1)


def periodic_warp(coords_yx: torch.Tensor, angles_deg: torch.Tensor,
                  periods: torch.Tensor, freq_scales: Sequence[float],
                  freq_offsets: Sequence[float],
                  angle_offsets: Sequence[float], res: Tuple[int, int],
                  include_input: bool = True) -> torch.Tensor:
    """Periodicity-aware input warping, Eq. 1 of the NPP-Net paper:
    fn(2*pi * ((y cos(th) + x sin(th)) mod f) / f) with
    f = (period[idx] + o) * s, th = deg2rad(angle[idx] + a)
    (reference: embedder.py:117-133). The modulo is floored, as jnp.mod,
    written p - f*floor(p/f) to match K1 op for op.

    angles_deg and periods are (2,), or (B, 2) for B proposals at once
    (the search's candidates; coords_yx is then (M, 2) and the result
    (B, M, D))."""
    h, w = res
    y = coords_yx[..., 0:1]
    x = coords_yx[..., 1:2]

    def orient_channels(idx: int) -> torch.Tensor:
        chans = []
        for s in freq_scales:
            for o in freq_offsets:
                for a in angle_offsets:
                    f = ((periods[..., idx] + o) * s)[..., None, None]
                    th = torch.deg2rad(angles_deg[..., idx] + a)[..., None, None]
                    proj = y * torch.cos(th) + x * torch.sin(th)
                    m = proj - f * torch.floor(proj / f)
                    phase = (m / f) * (2.0 * np.pi)
                    chans.append(torch.sin(phase))
                    chans.append(torch.cos(phase))
        return torch.cat(chans, dim=-1)

    o0, o1 = orient_channels(0), orient_channels(1)
    if not include_input:
        return torch.cat([o0, o1], dim=-1)
    lead = o0.shape[:-1] + (1,)
    return torch.cat([torch.broadcast_to((x / w - 0.5) * 2.0, lead), o0,
                      torch.broadcast_to((y / h - 0.5) * 2.0, lead), o1],
                     dim=-1)


@dataclass
class TaskEmbedder:
    """The per-task (non-search) encoder: periodic warp of each of the top-K
    proposals, Fourier re-encoded, proposal-major
    (reference: NPP_completion/train.py:93-105)."""

    freq_bands: Optional[torch.Tensor]
    angles: torch.Tensor    # (K, 2)
    periods: torch.Tensor   # (K, 2)
    res: Tuple[int, int]
    freq_scales: Tuple[float, ...]
    freq_offsets: Tuple[float, ...]
    angle_offsets: Tuple[float, ...]
    out_dim: int
    top1_dim: int

    def embed(self, coords_yx: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(..., 2) -> (..., out_dim) in out_dtype (float32, or bfloat16
        for the canvas table: the f32 values rounded to nearest even)."""
        return periodic_embed(coords_yx, self.angles, self.periods,
                              self.freq_bands, self.freq_scales,
                              self.freq_offsets, self.angle_offsets, self.res,
                              out_dtype)


def make_task_embedder(cfg, proposals_angles, proposals_periods,
                       res: Tuple[int, int], gen: torch.Generator,
                       device: torch.device) -> TaskEmbedder:
    """Build the fit-mode encoder for top-K proposals. `gen` draws the
    Gaussian Fourier bands (reference: embedder.py:26, models/helpers.py:87)."""
    bands = None if cfg.i_embed == -1 else \
        gaussian_freq_bands(gen, cfg.multires, device=device)
    angles = torch.as_tensor(np.asarray(proposals_angles, np.float32)
                             ).reshape(-1, 2)[: cfg.p_topk].to(device)
    periods = torch.as_tensor(np.asarray(proposals_periods, np.float32)
                              ).reshape(-1, 2)[: cfg.p_topk].to(device)
    pdim = periodic_embed_dim(cfg, include_input=True)
    ndim = 1 if cfg.i_embed == -1 else nerf_embed_dim(cfg, 1, include_input=True)
    return TaskEmbedder(
        freq_bands=bands, angles=angles, periods=periods, res=tuple(res),
        freq_scales=tuple(cfg.freq_scales), freq_offsets=tuple(cfg.freq_offsets),
        angle_offsets=tuple(cfg.angle_offsets),
        out_dim=int(angles.shape[0]) * pdim * ndim, top1_dim=pdim * ndim)


@dataclass
class TableEmbedder:
    """Gather-based stand-in for TaskEmbedder built from a precomputed
    (H*W, D) canvas table (cfg.embed_table; npp_tpu/nn/embedder.py:186-212).
    Every coordinate the fit embeds is an integer, in-bounds canvas pixel,
    so `table[y*W + x]` is the same function as the trig chain. A bfloat16
    table's rows come back as f32, the values `npp_tpu`'s first matmul
    promotes them to (nn/mlp.py:42)."""

    table: torch.Tensor     # (H*W, D), float32 or bfloat16
    res: Tuple[int, int]
    out_dim: int
    top1_dim: int

    def embed(self, coords_yx: torch.Tensor) -> torch.Tensor:
        w = self.res[1]
        idx = coords_yx[..., 0].long() * w + coords_yx[..., 1].long()
        return self.table.index_select(0, idx.reshape(-1)).float().reshape(
            *coords_yx.shape[:-1], -1)


@torch.no_grad()
def make_embedding_table(base: TaskEmbedder, dtype: torch.dtype = torch.float32,
                         chunk: int = 1 << 18) -> TableEmbedder:
    """Evaluate `base.embed` over the whole canvas in `dtype`, `chunk` rows
    per K1 launch (one launch at 384x512; bfloat16 as npp_tpu's
    `.astype(dtype)`), and wrap it as a TableEmbedder."""
    h, w = base.res
    dev = base.angles.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing='ij')
    coords = torch.stack([ys, xs], -1).reshape(-1, 2).to(torch.float32)
    table = torch.cat([base.embed(c, dtype) for c in coords.split(chunk)], 0)
    return TableEmbedder(table=table, res=(int(h), int(w)),
                         out_dim=base.out_dim, top1_dim=base.top1_dim)
