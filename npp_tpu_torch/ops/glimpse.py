"""Patch extraction and window sums, ports of `npp_tpu/ops/glimpse.py`
(reference: utils/extract_glimpse.py:7-79, always called with
mode='nearest', normalized=False, centered=False, padding_mode='zeros').
That reduces to an integer gather of rows/cols `c - S//2 + k, k in [0, S)`
around the integer centre, with zeros outside the image."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def patch_grid(centers_yx: torch.Tensor, size: int) -> torch.Tensor:
    """centers_yx: (..., 2) int -> (..., S, S, 2) integer pixel grid; rows
    c - S//2 .. c + S//2 - 1 (reference sampler.py:275-280)."""
    offs = torch.arange(size, dtype=centers_yx.dtype,
                        device=centers_yx.device) - size // 2
    gy = centers_yx[..., None, None, 0] + offs[:, None]
    gx = centers_yx[..., None, None, 1] + offs[None, :]
    shape = gy.shape[:-2] + (size, size)
    return torch.stack([gy.expand(shape), gx.expand(shape)], dim=-1)


def extract_patches(img: torch.Tensor, centers_yx: torch.Tensor,
                    size: int) -> torch.Tensor:
    """img (H, W, C); centers (..., 2) -> (..., S, S, C), zero-padded."""
    h, w = img.shape[:2]
    grid = patch_grid(centers_yx.long(), size)
    gy, gx = grid[..., 0], grid[..., 1]
    inb = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
    vals = img[gy.clamp(0, h - 1), gx.clamp(0, w - 1)]
    return vals * inb[..., None].to(img.dtype)


def summed_area_table(x: torch.Tensor) -> torch.Tensor:
    """SAT with a leading zero row/col: sat[i, j] = sum(x[:i, :j])."""
    s = torch.cumsum(torch.cumsum(x, dim=0), dim=1)
    return F.pad(s, (1, 0, 1, 0))


def window_sum(sat: torch.Tensor, centers_yx: torch.Tensor,
               size: int) -> torch.Tensor:
    """Sum of the table's underlying array over each patch window, clipped
    at the borders. sat (H+1, W+1); centers (..., 2) -> (...,)."""
    h = sat.shape[0] - 1
    w = sat.shape[1] - 1
    c = centers_yx.long()
    y0 = (c[..., 0] - size // 2).clamp(0, h)
    y1 = (c[..., 0] - size // 2 + size).clamp(0, h)
    x0 = (c[..., 1] - size // 2).clamp(0, w)
    x1 = (c[..., 1] - size // 2 + size).clamp(0, w)
    return sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]
