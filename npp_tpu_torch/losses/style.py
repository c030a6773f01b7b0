"""Gram-matrix style loss (reference: models/style_loss.py:8-74), NHWC at
its public call. Port of `npp_tpu/losses/style.py`.

The tower is VGG16 with the taps pool1..pool3 (the outputs after the first
three maxpools; reference: style_loss.py:11-14), on raw [0, 1] patches (the
reference does not ImageNet-normalise here). The Grams are `torch.bmm`
products, as the JAX package leaves its einsums to XLA. The adaptive path
is the robust NLL over each layer's flattened Gram residual, (P*K, C^2)
with C^2 = 4,096, 16,384 and 65,536: its rho terms go through K4's wide
rows, the three layers in one forward launch
(losses/robust.py::weighted_nll_rows_group), the per-element mean and the
1/(C H W) normalisation folded into the channel weight. With a bf16
`dtype` (feature_dtype) the tower, the Grams and their difference are bf16
as in JAX, and the loss terms f32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.features import (VGG16_BLOCKS, VGG16_STYLE_TAPS, VGGFeatures,
                           vgg_conv_shapes)
from ..nn.pretrained import load_tower_params
from .robust import AdaptiveLossParams, adaptive_init, weighted_nll_rows_group

STYLE_CHNS = (64, 128, 256)


class StyleLoss:
    """__call__(a_img, b_img, weight=None, adaptive=None, valid=None) -> ()
    on NHWC images; adaptive: the three layers' AdaptiveLossParams. With
    `images` (the multi-image fit, parallel/batch.py) the samples are
    len(images) equal groups and the result is (len(images),), group g's
    loss with the latents of image images[g] (stacked (B, 1, C^2))."""

    def __init__(self, device: torch.device, use_adaptive: bool = False,
                 dtype: torch.dtype = torch.float32):
        self.use_adaptive = use_adaptive
        shapes = vgg_conv_shapes(VGG16_BLOCKS)
        # the whole tower's weights (the LPIPS tower's, cached); the call
        # stops at pool3
        self.tower = VGGFeatures(
            load_tower_params('vgg16', shapes, len(shapes), device),
            VGG16_BLOCKS, dtype)

    def init_adaptive(self) -> nn.ModuleList:
        """One AdaptiveLossFunction per layer over the flattened Gram
        (num_dims = C^2; reference: style_loss.py:18-23)."""
        return nn.ModuleList(adaptive_init(c * c) for c in STYLE_CHNS)

    def features(self, img_nhwc: torch.Tensor):
        """The taps, NCHW."""
        outs = self.tower(img_nhwc.permute(0, 3, 1, 2), VGG16_STYLE_TAPS)
        return [outs[t] for t in VGG16_STYLE_TAPS]

    def __call__(self, a_img: torch.Tensor, b_img: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 adaptive: Optional[Sequence[AdaptiveLossParams]] = None,
                 valid: Optional[torch.Tensor] = None,
                 images: Optional[Sequence[int]] = None) -> torch.Tensor:
        v = None if valid is None else valid.to(torch.float32)
        g = 1 if images is None else len(images)

        def agg(per_sample):
            """Each group's aggregate, (g,)."""
            def grp(t):
                return t.reshape(g, -1)
            if weight is not None:
                t = per_sample * weight
                return torch.sum(grp(t if v is None else t * v), dim=1)
            if v is not None:
                return torch.sum(grp(per_sample * v), dim=1) / \
                    torch.clamp(grp(v).sum(dim=1), min=1.0)
            return torch.mean(grp(per_sample), dim=1)

        resids, ws = [], []
        loss = torch.zeros((g,), device=a_img.device)
        for fa, fb in zip(self.features(a_img), self.features(b_img)):
            n, c, h, w = fa.shape
            av, bv = fa.reshape(n, c, h * w), fb.reshape(n, c, h * w)
            diff = (torch.bmm(av, av.transpose(1, 2)) -
                    torch.bmm(bv, bv.transpose(1, 2))).float()
            denom = c * h * w
            if not self.use_adaptive:
                loss = loss + agg(torch.mean(torch.abs(diff) / denom,
                                             dim=(1, 2)))
            else:
                resids.append(diff.reshape(n, c * c))
                ws.append(torch.full((c * c,), 1.0 / (c * c * denom),
                                     device=diff.device))
        if self.use_adaptive:
            if adaptive is None:
                raise ValueError('use_adaptive requires adaptive params')
            # mean over C^2 of nll / denom = sum_c w_c nll, w_c = 1/(C^2 denom)
            if images is None:
                pers = weighted_nll_rows_group(resids, adaptive, ws)
            else:
                # a segment per (layer, image), each with its own latents
                flat = weighted_nll_rows_group(
                    [r.reshape(g, -1, r.shape[-1])[j] for r in resids
                     for j in range(g)],
                    [p for p in adaptive for _ in range(g)],
                    [w for w in ws for _ in range(g)],
                    images=[j for _ in resids for j in images])
                pers = [torch.cat(flat[i * g:(i + 1) * g])
                        for i in range(len(resids))]
            for per in pers:
                loss = loss + agg(per)
        return loss if images is not None else loss[0]
