"""Contextual (CX) loss in PyTorch, NHWC at its public functions.

Port of `npp_tpu/losses/contextual.py` (reference:
externel_lib/contextual_loss/functional.py:9-63,127-186 and
modules/contextual.py:9-68): the cosine path (the one the fits use) and
the 'l1' and 'l2' distances, with npp_tpu's spatial mask
(the search's cx_mask_pad) and a per-sample form (one value per sample,
the search's eval of each candidate). Plain PyTorch; the similarity chain
is the K3 kernel of a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..nn.features import (VGG19_BLOCKS, VGG19_CX_TAP, VGGFeatures,
                           imagenet_normalize, vgg_conv_shapes)
from ..nn.pretrained import load_tower_params


def compute_cosine_distance(x: torch.Tensor, y: torch.Tensor,
                            feat_valid: Optional[torch.Tensor] = None,
                            per_sample: bool = False,
                            groups: Optional[int] = None) -> torch.Tensor:
    """x, y: (N, H, W, C) -> dist (N, HW_x, HW_y)
    (reference: functional.py:127-163). feat_valid: optional (N, H, W)
    mask; the mean-shift statistic then uses valid positions only. The
    statistic is over the batch and space, or over each sample's space
    with per_sample (each sample then as if alone), or with `groups` over
    each of that many equal groups of samples (the multi-image fit: each
    image's batch as if alone)."""
    if groups is not None:
        n, h, w, c = y.shape
        y_mu = torch.mean(y.reshape(groups, -1, h, w, c), dim=(1, 2, 3),
                          keepdim=True)
        y_mu = y_mu.expand(groups, n // groups, 1, 1, c).reshape(n, 1, 1, c)
        return _cosine_from_mean(x, y, y_mu)
    dims = (1, 2) if per_sample else (0, 1, 2)
    if feat_valid is not None:
        v = feat_valid[..., None].to(y.dtype)
        y_mu = (torch.sum(y * v, dim=dims, keepdim=True)
                / torch.clamp(torch.sum(v, dim=dims, keepdim=True), min=1.0))
    else:
        y_mu = torch.mean(y, dim=dims, keepdim=True)
    return _cosine_from_mean(x, y, y_mu)


def _cosine_from_mean(x: torch.Tensor, y: torch.Tensor,
                      y_mu: torch.Tensor) -> torch.Tensor:
    xc = x - y_mu
    yc = y - y_mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=-1, keepdim=True) + 1e-12)
    yn = yc / (torch.linalg.vector_norm(yc, dim=-1, keepdim=True) + 1e-12)
    n, h, w, c = x.shape
    sim = torch.bmm(xn.reshape(n, h * w, c),
                    yn.reshape(n, h * w, c).transpose(1, 2))
    return 1.0 - torch.clamp(sim, 0.0, 1.0)


def compute_l1_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|sum_c (x(p) - y(q))| (reference: functional.py:166-177: the channel
    sum is taken before the abs, with no channel normalisation), NHWC."""
    n, h, w, c = x.shape
    xs = torch.sum(x.reshape(n, h * w, c), dim=-1)   # (N, P)
    ys = torch.sum(y.reshape(n, h * w, c), dim=-1)
    return torch.clamp(torch.abs(xs[:, :, None] - ys[:, None, :]), min=0.0)


def compute_l2_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (reference: functional.py:166-186),
    NHWC."""
    n, h, w, c = x.shape
    xv = x.reshape(n, h * w, c)
    yv = y.reshape(n, h * w, c)
    x_s = torch.sum(xv ** 2, dim=-1)  # (N, P)
    y_s = torch.sum(yv ** 2, dim=-1)
    ab = torch.bmm(xv, yv.transpose(1, 2))
    return torch.clamp(y_s[:, None, :] - 2 * ab + x_s[:, :, None], min=0.0)


def compute_relative_distance(dist_raw: torch.Tensor) -> torch.Tensor:
    dist_min = torch.amin(dist_raw, dim=2, keepdim=True)
    return dist_raw / (dist_min + 1e-5)


def compute_cx(dist_tilde: torch.Tensor, band_width: float) -> torch.Tensor:
    w = torch.exp((1.0 - dist_tilde) / band_width)
    return w / torch.sum(w, dim=2, keepdim=True)


def contextual_loss(x: torch.Tensor, y: torch.Tensor, band_width: float = 0.5,
                    weight: Optional[torch.Tensor] = None,
                    loss_type: str = 'cosine',
                    valid: Optional[torch.Tensor] = None,
                    feat_valid: Optional[torch.Tensor] = None,
                    per_sample: bool = False,
                    groups: Optional[int] = None) -> torch.Tensor:
    """CX loss on NHWC feature maps (reference: functional.py:9-63).

    valid: optional (N,) bool — invalid samples contribute 0 and the
    unweighted aggregation is a masked mean over the survivors.
    feat_valid: optional (N, H, W) position mask applied to both x and y.
    per_sample: return (N,) values, each sample's loss as if it were called
    alone (weight and valid are then not taken). groups: the samples are
    that many equal groups (images), and the result is (groups,), each
    group's loss as if it were called alone. loss_type: 'cosine', or the
    'l1' or 'l2' distance (which have no mean shift: feat_valid,
    per_sample and groups then act only on the match and its mean)."""
    if per_sample and (weight is not None or valid is not None):
        raise ValueError('per_sample takes no weight or valid')
    if groups is not None and feat_valid is not None:
        raise ValueError('groups take no feat_valid')
    if loss_type == 'cosine':
        dist_raw = compute_cosine_distance(x, y, feat_valid, per_sample,
                                           groups)
    elif loss_type in ('l1', 'l2'):
        dist_raw = (compute_l1_distance if loss_type == 'l1'
                    else compute_l2_distance)(x, y)
    else:
        raise ValueError(f'unsupported loss_type {loss_type!r}')
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
    if per_sample:
        return -torch.log(cx + 1e-5)
    g = 1 if groups is None else groups

    def per_group(t):
        return t.reshape(g, -1)

    if weight is not None:
        term = -torch.log(cx * weight + 1e-5)
        if valid is not None:
            term = term * valid
        out = torch.sum(per_group(term), dim=1)
    else:
        term = -torch.log(cx + 1e-5)
        if valid is not None:
            v = per_group(valid.to(term.dtype))
            out = torch.sum(per_group(term) * v, dim=1) / \
                torch.clamp(torch.sum(v, dim=1), min=1.0)
        else:
            out = torch.mean(per_group(term), dim=1)
    return out if groups is not None else out[0]


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
                 valid: Optional[torch.Tensor] = None,
                 spatial_mask: Optional[torch.Tensor] = None,
                 per_sample: bool = False,
                 groups: Optional[int] = None) -> torch.Tensor:
        """spatial_mask: optional (N, H, W, 1) image-resolution mask of real
        content; feature positions with (about) no overlap with it are left
        out of the match (npp_tpu/losses/contextual.py:154-186: the
        ranking's cx_mask_pad). per_sample: (N,) values, each as if its
        sample were called alone. groups: (groups,) values, each group of
        N / groups samples as if called alone (the multi-image fit)."""
        fx, fy = self.features(x), self.features(y)
        feat_valid = None
        if spatial_mask is not None:
            n, fh, fw = fx.shape[:3]
            frac = resize_linear_antialiased(
                spatial_mask.to(torch.float32)[..., 0], (fh, fw))
            feat_valid = torch.broadcast_to(
                (frac > 1e-3).to(torch.float32), (n, fh, fw))
        return contextual_loss(fx, fy, self.band_width, weight, valid=valid,
                               feat_valid=feat_valid, per_sample=per_sample,
                               groups=groups)


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize(method='linear')
    along one axis (jax/_src/image/scale.py::compute_weight_mat with
    antialias): the triangle kernel widened by in/out when downsampling,
    each column normalised, columns outside the input zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - \
        f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear_antialiased(img: torch.Tensor,
                              size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W) -> (N, h, w) as jax.image.resize(..., method='linear')
    resizes H and W: a separable triangle filter that antialiases when it
    downsamples (torch's bilinear interpolation does not)."""
    wy = torch.as_tensor(_triangle_weights(img.shape[1], size[0]),
                         device=img.device)
    wx = torch.as_tensor(_triangle_weights(img.shape[2], size[1]),
                         device=img.device)
    return torch.einsum('nhw,hy,wx->nyx', img, wy, wx)
