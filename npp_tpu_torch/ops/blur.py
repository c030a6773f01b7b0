"""Blur detection and masked blur, a port of `npp_tpu/ops/blur.py`
(reference: NPP_remapping/blur_detection.py:13-60, utils/ops.py:66-76).

`blur_map` scores every pixel's 20x20 window by the mass of its top
singular values: the eigenvalues of the window's 20x20 Gram matrix (the
squares of the singular values), batched on the device in chunks of 2^14
windows with `torch.linalg.eigvalsh` (the JAX package takes 2^15; on an
H100 with CUDA 12.8, cuSOLVER's batched syev, which eigvalsh calls for a
batch of small matrices, refuses 2^15 of them and takes 2^14). The window
values are raw 0-255 grays, so the Gram is computed in full f32 (never
TF32): its rounding would move the eigenvalues, and the mask is a
threshold of them. Thresholding, the 20 erosions and the 40 dilations run
on the host with scipy, as in the JAX package. The gray comes from
`proposal/cv.py::rgb2gray`, OpenCV's RGB2GRAY bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.ndimage as ndimage
import torch

from ..device import matmul_precision
from ..proposal.cv import rgb2gray

CHUNK = 1 << 14


def _reference_pad(img: np.ndarray, win: int) -> np.ndarray:
    """reference: blur_detection.py:15-31 index mapping."""
    h, w = img.shape
    i = np.arange(h + 2 * win)
    p = np.where(i < win, win - i, np.where(i > h + win - 1, 2 * h - i, i - win))
    j = np.arange(w + 2 * win)
    q = np.where(j < win, win - j, np.where(j > w + win - 1, 2 * w - j, j - win))
    return img[np.clip(p, 0, h - 1)][:, np.clip(q, 0, w - 1)]


def sv_degree(windows: torch.Tensor, sv_num: int) -> torch.Tensor:
    """windows (N, n, n) -> the top-sv_num singular values' share of their
    sum, from the eigenvalues of the Gram W^T W (ascending), in full f32."""
    with matmul_precision('float32'):
        gram = torch.bmm(windows.transpose(1, 2), windows)
    s = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(gram), min=0.0))
    return torch.sum(s[:, -sv_num:], dim=1) / (torch.sum(s, dim=1) + 1e-6)


def degree_map(img_rgb_u8: np.ndarray, win_size: int = 10, sv_num: int = 3,
               device: Optional[torch.device] = None) -> np.ndarray:
    """(H, W) float32 sharpness degree of each pixel's (2*win_size)^2
    window, before normalisation."""
    device = torch.device('cpu') if device is None else device
    gray = rgb2gray(img_rgb_u8).astype(np.float64)
    h, w = gray.shape
    win = 2 * win_size
    padded = torch.as_tensor(_reference_pad(gray, win_size), dtype=torch.float32,
                             device=device)
    # windows[y, x, i, j] = padded[y + i, x + j], a view; rows of windows
    # are copied a chunk at a time
    windows = padded.unfold(0, win, 1).unfold(1, win, 1)[:h, :w]
    rows = max(1, CHUNK // w)
    out = [sv_degree(windows[r:r + rows].reshape(-1, win, win), sv_num)
           for r in range(0, h, rows)]
    return torch.cat(out).reshape(h, w).cpu().numpy()


def clear_mask_from_degree(degree: np.ndarray, thresh: float = 50.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The host half of blur_map: the degree map normalised to [0, 1] (in
    its own dtype), then the clear mask (x255): pixels below the thresh-th
    percentile, after 20 erosions and 40 dilations of the sharp set."""
    degree = (degree - degree.min()) / (degree.max() - degree.min())
    threshold = np.percentile(degree, thresh)
    binary = degree > threshold
    binary = ndimage.binary_erosion(binary, iterations=20)
    binary = ndimage.binary_dilation(binary, iterations=40)
    binary = ~binary
    return degree, binary.astype(np.float64) * 255


def blur_map(img_rgb_u8: np.ndarray, win_size: int = 10, sv_num: int = 3,
             thresh: float = 50.0, device: Optional[torch.device] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel sharpness map + binary clear mask (x255), matching
    get_blur_map's outputs (reference: blur_detection.py:13-60). The
    windows' eigenvalues run on `device` (the CPU when None)."""
    return clear_mask_from_degree(
        degree_map(img_rgb_u8, win_size, sv_num, device), thresh)


def blur_with_mask(img: np.ndarray, mask: np.ndarray, sigma: float = 3.0
                   ) -> np.ndarray:
    """Masked Gaussian blur (reference: utils/ops.py:66-76; skimage gaussian
    semantics: per-channel, mode='nearest')."""
    img = np.asarray(img, np.float64)
    mask = np.asarray(mask, np.float64)
    num = np.stack([ndimage.gaussian_filter(img[..., c] * mask[..., 0],
                                            sigma=sigma, mode='nearest')
                    for c in range(img.shape[-1])], -1)
    den = ndimage.gaussian_filter(mask[..., 0], sigma=sigma, mode='nearest')
    out = num / (den[..., None] + 1e-6)
    return out * mask
