"""LPIPS perceptual metric/loss in PyTorch, NHWC at its public call.

Port of `npp_tpu/losses/lpips.py` (reference: externel_lib/lpips/lpips.py:
27-133) for the VGG and AlexNet towers, including the repo's two
modifications: per-layer adaptive-robust diffs (`use_robust`,
lpips.py:103-113), whose rho goes through K4
(losses/robust.py::weighted_nll_rows_group, one forward launch for the
five layers) with the lin head as the channel weight, and spatial mode
(each layer's map up-sampled to the input, lpips.py:115-124), which the
segmentation refinement reads. The squeeze net is not ported.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.features import (ALEX_CONV_SHAPES, ALEX_LPIPS_TAPS, VGG16_BLOCKS,
                           VGG16_LPIPS_TAPS, AlexNetFeatures, VGGFeatures,
                           vgg_conv_shapes)
from ..nn.pretrained import load_lpips_lins, load_tower_params
from .robust import (AdaptiveLossParams, adaptive_init,
                     weighted_nll_rows_group)

_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)

LPIPS_CHNS = {'vgg': (64, 128, 256, 512, 512),
              'alex': (64, 192, 384, 256, 256)}


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-unit-norm (reference: lpips/__init__.py:41-43), NHWC."""
    norm = torch.sqrt(torch.sum(torch.square(feat), dim=-1, keepdim=True))
    return feat / (norm + eps)


def upsample_bilinear(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h0, w0, 1) -> (N, h, w, 1): jax.image.resize(..., 'bilinear')
    when up-sampling (half-pixel centres, edge samples held), which is
    F.interpolate's align_corners=False form."""
    return F.interpolate(m.permute(0, 3, 1, 2), size=(h, w), mode='bilinear',
                         align_corners=False).permute(0, 2, 3, 1)


class LPIPS:
    """Callable LPIPS on NHWC float images.

    __call__(in0, in1, use_robust=False, adaptive=None, normalize=False,
    spatial=False, ret_per_layer=False) -> (N, 1, 1, 1), or (N, H, W, 1)
    with spatial, and with ret_per_layer also the list of per-layer maps.
    normalize=True maps [0,1] inputs to [-1,1] first; a one-channel input
    broadcasts against the three-channel shift and scale, as in JAX.
    adaptive: per-layer AdaptiveLossParams (trainable) for use_robust.
    images: the multi-image fit's form (parallel/batch.py): the samples
    are len(images) equal groups, group g belonging to image images[g],
    whose latents are row images[g] of the stacked (B, 1, C) adaptive
    params; each (layer, group) is then a segment of its own in K4.
    dtype: the tower's activations (feature_dtype); the diffs' robust
    terms and the head run in f32."""

    def __init__(self, device: torch.device, net: str = 'vgg',
                 dtype: torch.dtype = torch.float32):
        if net not in LPIPS_CHNS:
            raise NotImplementedError(
                f"LPIPS net {net!r} is not ported (ROADMAP.md)")
        self.chns = LPIPS_CHNS[net]
        if net == 'vgg':
            self.taps: Sequence[str] = VGG16_LPIPS_TAPS
            shapes = vgg_conv_shapes(VGG16_BLOCKS)
            self.tower = VGGFeatures(
                load_tower_params('vgg16', shapes, len(shapes), device),
                VGG16_BLOCKS, dtype)
        else:
            self.taps = ALEX_LPIPS_TAPS
            self.tower = AlexNetFeatures(
                load_tower_params('alexnet_tv', ALEX_CONV_SHAPES,
                                  len(ALEX_CONV_SHAPES), device), dtype)
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
                 normalize: bool = False, spatial: bool = False,
                 ret_per_layer: bool = False,
                 images: Optional[Sequence[int]] = None):
        if normalize:
            in0 = 2.0 * in0 - 1.0
            in1 = 2.0 * in1 - 1.0
        in0 = (in0 - self.shift) / self.scale
        in1 = (in1 - self.shift) / self.scale
        feats0 = self.features(in0)
        feats1 = self.features(in1)

        # f32 from here: JAX promotes the bf16 diffs against the f32
        # latents and heads
        diffs = [(normalize_tensor(f0) - normalize_tensor(f1)).float()
                 for f0, f1 in zip(feats0, feats1)]
        if use_robust:
            if adaptive is None:
                raise ValueError('use_robust requires adaptive params')
            if images is None:
                # one K4 forward launch for all the layers
                rows = weighted_nll_rows_group(
                    [d.reshape(-1, d.shape[-1]) for d in diffs], adaptive,
                    self.lins)
            else:
                # a segment per (layer, image): each has its own latents
                g = len(images)
                segs = [d.reshape(g, -1, d.shape[-1]) for d in diffs]
                flat = weighted_nll_rows_group(
                    [x[j] for x in segs for j in range(g)],
                    [p for p in adaptive for _ in range(g)],
                    [lin for lin in self.lins for _ in range(g)],
                    images=[j for _ in segs for j in images])
                rows = [torch.cat(flat[i * g:(i + 1) * g])
                        for i in range(len(segs))]
        else:
            rows = [torch.sum(torch.square(d) * lin, dim=-1)
                    for d, lin in zip(diffs, self.lins)]
        res = []
        for d, r in zip(diffs, rows):
            n, h, w = d.shape[:3]
            m = r.reshape(n, h, w, 1)
            res.append(upsample_bilinear(m, in0.shape[1], in0.shape[2])
                       if spatial else
                       torch.mean(m, dim=(1, 2), keepdim=True))
        val = res[0]
        for m in res[1:]:
            val = val + m
        return (val, res) if ret_per_layer else val
