"""Contextual (CX) loss in PyTorch, NHWC at its public functions.

Port of `npp_tpu/losses/contextual.py` (reference:
externel_lib/contextual_loss/functional.py:9-63,127-186 and
modules/contextual.py:9-68), cosine path. Plain PyTorch in this slice; the
similarity chain is the K3 kernel of a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn.features import (VGG19_BLOCKS, VGG19_CX_TAP, VGGFeatures,
                           imagenet_normalize, vgg_conv_shapes)
from ..nn.pretrained import load_tower_params


def compute_cosine_distance(x: torch.Tensor, y: torch.Tensor,
                            feat_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """x, y: (N, H, W, C) -> dist (N, HW_x, HW_y)
    (reference: functional.py:127-163). feat_valid: optional (N, H, W)
    mask; the mean-shift statistic then uses valid positions only."""
    if feat_valid is not None:
        v = feat_valid[..., None].to(y.dtype)
        y_mu = (torch.sum(y * v, dim=(0, 1, 2), keepdim=True)
                / torch.clamp(torch.sum(v, dim=(0, 1, 2), keepdim=True), min=1.0))
    else:
        y_mu = torch.mean(y, dim=(0, 1, 2), keepdim=True)
    xc = x - y_mu
    yc = y - y_mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=-1, keepdim=True) + 1e-12)
    yn = yc / (torch.linalg.vector_norm(yc, dim=-1, keepdim=True) + 1e-12)
    n, h, w, c = x.shape
    sim = torch.bmm(xn.reshape(n, h * w, c),
                    yn.reshape(n, h * w, c).transpose(1, 2))
    return 1.0 - torch.clamp(sim, 0.0, 1.0)


def compute_relative_distance(dist_raw: torch.Tensor) -> torch.Tensor:
    dist_min = torch.amin(dist_raw, dim=2, keepdim=True)
    return dist_raw / (dist_min + 1e-5)


def compute_cx(dist_tilde: torch.Tensor, band_width: float) -> torch.Tensor:
    w = torch.exp((1.0 - dist_tilde) / band_width)
    return w / torch.sum(w, dim=2, keepdim=True)


def contextual_loss(x: torch.Tensor, y: torch.Tensor, band_width: float = 0.5,
                    weight: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None,
                    feat_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CX loss on NHWC feature maps (reference: functional.py:9-63).

    valid: optional (N,) bool — invalid samples contribute 0 and the
    unweighted aggregation is a masked mean over the survivors.
    feat_valid: optional (N, H, W) position mask applied to both x and y."""
    dist_raw = compute_cosine_distance(x, y, feat_valid)
    if feat_valid is not None:
        fv = feat_valid.reshape(feat_valid.shape[0], -1)  # (N, P)
        fvd = fv.to(dist_raw.dtype)
        dist_raw = torch.where(fv[:, None, :] > 0, dist_raw,
                               torch.full_like(dist_raw, 1e9))
    dist_tilde = compute_relative_distance(dist_raw)
    cx = compute_cx(dist_tilde, band_width)
    if feat_valid is not None:
        cx = torch.amax(cx * fvd[:, :, None], dim=1)          # (N, Q)
        cx = torch.sum(cx * fvd, dim=1) / torch.clamp(fvd.sum(1), min=1.0)
    else:
        cx = torch.mean(torch.amax(cx, dim=1), dim=1)          # (N,)
    if weight is not None:
        term = -torch.log(cx * weight + 1e-5)
        if valid is not None:
            term = term * valid
        return torch.sum(term)
    term = -torch.log(cx + 1e-5)
    if valid is not None:
        v = valid.to(term.dtype)
        return torch.sum(term * v) / torch.clamp(torch.sum(v), min=1.0)
    return torch.mean(term)


class ContextualLoss:
    """VGG19 relu3_4 contextual loss on [0,1] NHWC images
    (reference: modules/contextual.py:25-68). The tower runs NCHW and stops
    at relu3_4; the chain runs in f32 (npp_tpu/losses/contextual.py:165-176)."""

    def __init__(self, device: torch.device, band_width: float = 0.5,
                 vgg_layer: str = VGG19_CX_TAP):
        self.band_width = band_width
        self.vgg_layer = vgg_layer
        shapes = vgg_conv_shapes(VGG19_BLOCKS)
        self.tower = VGGFeatures(
            load_tower_params('vgg19', shapes, 8, device), VGG19_BLOCKS)

    def features(self, img_nhwc: torch.Tensor) -> torch.Tensor:
        x = imagenet_normalize(img_nhwc).permute(0, 3, 1, 2)
        f = self.tower(x, (self.vgg_layer,))[self.vgg_layer]
        return f.permute(0, 2, 3, 1).to(torch.float32)

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 weight: Optional[torch.Tensor] = None,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        return contextual_loss(self.features(x), self.features(y),
                               self.band_width, weight, valid=valid)
