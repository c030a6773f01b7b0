"""LPIPS perceptual metric/loss in PyTorch, NHWC at its public call.

Port of `npp_tpu/losses/lpips.py` (reference: externel_lib/lpips/lpips.py:
27-133) for the VGG net in non-spatial mode, including the repo's per-layer
adaptive-robust diffs (`use_robust`, lpips.py:103-113), whose rho goes
through K4 (losses/robust.py::weighted_nll_rows_group, one forward launch
for the five layers) with the lin head as the channel weight. Spatial mode and the alex and squeeze nets are not ported
yet.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.features import (VGG16_BLOCKS, VGG16_LPIPS_TAPS, VGGFeatures,
                           vgg_conv_shapes)
from ..nn.pretrained import load_lpips_lins, load_tower_params
from .robust import (AdaptiveLossParams, adaptive_init,
                     weighted_nll_rows_group)

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

LPIPS_CHNS = {'vgg': (64, 128, 256, 512, 512)}


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-unit-norm (reference: lpips/__init__.py:41-43), NHWC."""
    norm = torch.sqrt(torch.sum(torch.square(feat), dim=-1, keepdim=True))
    return feat / (norm + eps)


class LPIPS:
    """Callable LPIPS on NHWC float images.

    __call__(in0, in1, use_robust=False, adaptive=None, normalize=False)
    -> (N, 1, 1, 1). normalize=True maps [0,1] inputs to [-1,1] first;
    adaptive: per-layer AdaptiveLossParams (trainable) for use_robust."""

    def __init__(self, device: torch.device, net: str = 'vgg'):
        if net != 'vgg':
            raise NotImplementedError(
                f"LPIPS net {net!r} is not ported yet (ROADMAP.md)")
        self.chns = LPIPS_CHNS[net]
        self.taps: Sequence[str] = VGG16_LPIPS_TAPS
        shapes = vgg_conv_shapes(VGG16_BLOCKS)
        self.tower = VGGFeatures(
            load_tower_params('vgg16', shapes, len(shapes), device),
            VGG16_BLOCKS)
        lins = load_lpips_lins(net, device)
        if lins is None:
            # uncalibrated fallback: uniform positive head
            lins = {f'lin{i}': torch.ones(c, device=device) / c
                    for i, c in enumerate(self.chns)}
        self.lins = [lins[f'lin{i}'] for i in range(len(self.chns))]
        self.shift = torch.as_tensor(_SHIFT, device=device)
        self.scale = torch.as_tensor(_SCALE, device=device)

    def init_adaptive(self) -> nn.ModuleList:
        """Trainable per-layer robust latents (reference: lpips.py:57-61)."""
        return nn.ModuleList(adaptive_init(c) for c in self.chns)

    def features(self, img_nhwc: torch.Tensor) -> List[torch.Tensor]:
        outs = self.tower(img_nhwc.permute(0, 3, 1, 2), self.taps)
        return [outs[t].permute(0, 2, 3, 1) for t in self.taps]

    def __call__(self, in0: torch.Tensor, in1: torch.Tensor,
                 use_robust: bool = False,
                 adaptive: Optional[Sequence[AdaptiveLossParams]] = None,
                 normalize: bool = False) -> torch.Tensor:
        if normalize:
            in0 = 2.0 * in0 - 1.0
            in1 = 2.0 * in1 - 1.0
        in0 = (in0 - self.shift) / self.scale
        in1 = (in1 - self.shift) / self.scale
        feats0 = self.features(in0)
        feats1 = self.features(in1)

        diffs = [normalize_tensor(f0) - normalize_tensor(f1)
                 for f0, f1 in zip(feats0, feats1)]
        if use_robust:
            if adaptive is None:
                raise ValueError('use_robust requires adaptive params')
            # one K4 forward launch for all the layers
            rows = weighted_nll_rows_group(
                [d.reshape(-1, d.shape[-1]) for d in diffs], adaptive,
                self.lins)
        else:
            rows = [torch.sum(torch.square(d) * lin, dim=-1)
                    for d, lin in zip(diffs, self.lins)]
        val = None
        for d, r in zip(diffs, rows):
            n, h, w = d.shape[:3]
            m = torch.mean(r.reshape(n, h * w), dim=1).reshape(n, 1, 1, 1)
            val = m if val is None else val + m
        return val
