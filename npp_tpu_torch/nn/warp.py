"""Learnable smooth warp field: coordinates -> coordinates + delta.

Port of `npp_tpu/nn/warp.py` (a JAX-package addition with no reference
equivalent; default off). A small coordinate MLP W(y, x) -> (dy, dx),
applied before the periodic warp, models perspective drift of the lattice
as a smooth deformation that extrapolates into holes: sin hidden layers, a
zero output layer (the identity at init) and max_px * tanh (bounded).

Initialisation follows flax's `nn.Dense`: lecun-normal kernels (a normal
truncated at two standard deviations, std sqrt(1/fan_in) / 0.8796...) and
zero biases, the output layer all zeros, drawn from an explicit
torch.Generator (the same distribution as the JAX package's keyed draw,
not the same numbers; utils/convert.py carries parameters across).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .embedder import normalize_coords

# flax's variance_scaling stddev correction for a normal truncated at +-2
TRUNC_STD = 0.87962566103423978


def _dense(fan_in: int, fan_out: int, gen: Optional[torch.Generator],
           zero: bool = False) -> nn.Linear:
    """nn.Linear without torch's default init (which would draw from the
    global generator), initialised as flax's Dense."""
    lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    with torch.no_grad():
        lin.bias.zero_()
        if zero:
            lin.weight.zero_()
        else:
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
    return lin


class WarpField(nn.Module):
    """(N, 2) normalised coords in [-1, 1] -> (N, 2) pixel-space delta.
    Layers are named as the flax module names them: dense0.., out."""

    def __init__(self, width: int = 32, depth: int = 2, max_px: float = 12.0,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = depth
        self.max_px = max_px
        fan_in = 2
        for i in range(depth):
            setattr(self, f'dense{i}', _dense(fan_in, width, gen))
            fan_in = width
        self.out = _dense(fan_in, 2, gen, zero=True)

    def forward(self, norm_coords: torch.Tensor) -> torch.Tensor:
        h = norm_coords
        for i in range(self.depth):
            h = torch.sin(getattr(self, f'dense{i}')(h))
        return self.max_px * torch.tanh(self.out(h))


def make_warp(cfg, gen: Optional[torch.Generator] = None
              ) -> Optional[WarpField]:
    """WarpField from config, or None when disabled."""
    if not getattr(cfg, 'warp_field', False):
        return None
    return WarpField(width=cfg.warp_width, depth=cfg.warp_depth,
                     max_px=cfg.warp_max_px, gen=gen)


def warp_coords(warp: WarpField, coords: torch.Tensor,
                res: Tuple[int, int]) -> torch.Tensor:
    """coords + W(normalised coords); res = (H, W) of the canvas."""
    return coords + warp(normalize_coords(coords, res))
