"""Displacement-vector periodicity search (reference:
NPP_proposal/feature_searching.py:77-338), a port of
`npp_tpu/proposal/search_engine.py`.

The masked SSD (or, with edge_searching, the negative correlation) of the
feature map against itself shifted by d is computed for every displacement
at once with FFTs (the identity is derived in npp_tpu's module note):

    L(d) = corr(B, M)(d) + corr(M, B)(d) - 2 sum_c corr(A_c M, A_c M)(d)

`displacement_loss_grid` runs `torch.fft.rfft2` / `irfft2` in float32 on
the caller's device (cuFFT on the card), as npp_tpu computes it in f32.
Everything after the grid (the shift annuli, the argsort, the lattice
geometry) is a numpy copy of npp_tpu's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .features import act2edge, im2act


def displacement_loss_grid(activation: torch.Tensor, mask: torch.Tensor,
                           edge_searching: bool = True) -> torch.Tensor:
    """Loss at every displacement (dy in [0, H), dx in (-W, W)).

    activation: (C, H, W) float32 feature stack without its trailing mask
    channel; mask: (H, W). Returns (H, 2W); grid[dy, dx + W] is the loss of
    the shift (dx, dy)."""
    c, h, w = activation.shape
    s = (2 * h, 2 * w)
    am = activation * mask[None]
    f_am = torch.fft.rfft2(am, s=s)                       # (C, 2H, W+1)
    auto = torch.sum(f_am.real ** 2 + f_am.imag ** 2, dim=0)
    if edge_searching:
        spec = -auto
    else:
        b = torch.sum(activation ** 2, dim=0) * mask
        f_b = torch.fft.rfft2(b, s=s)
        f_m = torch.fft.rfft2(mask, s=s)
        spec = 2.0 * torch.real(torch.conj(f_b) * f_m) - 2.0 * auto
    corr = torch.fft.irfft2(spec, s=s)                    # (2H, 2W)
    # the circular correlation at the doubled size is exact for |dy| < H,
    # |dx| < W; columns [W, 2W) hold dx in [-W, 0)
    return torch.cat([corr[:h, w:], corr[:h, :w]], dim=1)


def generate_possible_shifts(act_shape: Tuple[int, int],
                             range_x: Tuple[int, int],
                             range_y: Tuple[int, int]) -> np.ndarray:
    """Candidate (dx, dy) annulus for one range group
    (reference: feature_searching.py:267-277). The lower bound is
    -w // r, the floor of the negative, as the reference has it."""
    h, w = act_shape
    dxs, dys = np.meshgrid(np.arange(-w // range_x[0], w // range_x[0]),
                           np.arange(0, h // range_y[0]), indexing='ij')
    shifts = np.stack([dxs.ravel(), dys.ravel()], 1)
    keep = (np.abs(shifts[:, 0]) > w // range_x[1]) | \
        (shifts[:, 1] > h // range_y[1])
    return shifts[keep]


def find_second_shift_by_angle(sorted_shifts: np.ndarray,
                               minimum_angle: float = 20.0) -> Optional[int]:
    """reference: feature_searching.py:281-306."""
    thetas = np.arctan2(sorted_shifts[:, 1], sorted_shifts[:, 0]) * 180 / math.pi
    diff = np.abs(thetas - thetas[0])
    sel = np.nonzero((diff > minimum_angle) & (diff < 180 - minimum_angle))[0]
    return int(sel[0]) if len(sel) else None


def shifts2angle(shift_xy: np.ndarray) -> float:
    """reference: feature_searching.py:309-314."""
    return float(180.0 - np.arctan2(shift_xy[1], shift_xy[0]) * 180.0 / math.pi)


def shifts2period(this_shift: np.ndarray, another_shift: np.ndarray) -> float:
    """Lattice row spacing |d| * sin(angle between the vectors)
    (reference: feature_searching.py:317-339)."""
    period = float(np.hypot(this_shift[0], this_shift[1]))
    v1 = this_shift / (np.linalg.norm(this_shift) + 1e-12)
    v2 = another_shift / (np.linalg.norm(another_shift) + 1e-12)
    phi = np.arccos(np.clip(np.dot(v1, v2), -1.0, 1.0))
    return period * float(np.sin(phi))


def generate_periodicity(losses: np.ndarray, shifts: np.ndarray):
    """Best displacement pair -> (angles, periods, shifts)
    (reference: feature_searching.py:118-155). Each direction's angle comes
    from the OTHER displacement vector (reference :143-144)."""
    order = np.argsort(losses, kind='stable')
    sorted_shifts = shifts[order].astype(np.float64)
    second = find_second_shift_by_angle(sorted_shifts)
    if second is None:
        return None, None, None
    pair = [sorted_shifts[0], sorted_shifts[second]]
    angles = [shifts2angle(pair[1]), shifts2angle(pair[0])]
    periods = [shifts2period(pair[0], pair[1]), shifts2period(pair[1], pair[0])]
    return angles, periods, pair


def feature_search(activation: np.ndarray, mask: np.ndarray,
                   repeat_range: Tuple[int, int, int] = (3, 6, 1),
                   edge_searching: bool = True,
                   device: Optional[torch.device] = None):
    """One loss grid on `device` (the CPU by default), then each range group
    (reference: feature_search :77-115) is an argsort over its annulus of
    that grid on the host."""
    c, h, w = activation.shape
    dev = torch.device('cpu') if device is None else device
    grid = displacement_loss_grid(
        torch.as_tensor(activation[:-1], dtype=torch.float32, device=dev),
        torch.as_tensor(mask, dtype=torch.float32, device=dev),
        edge_searching).cpu().numpy()

    all_angles, all_periods, all_shifts = [], [], []
    start, end, step = repeat_range
    for i in range(start, end, step):
        rng = (i, i + step)
        shifts = generate_possible_shifts((h, w), rng, rng)
        if len(shifts) == 0:
            continue
        losses = grid[shifts[:, 1], shifts[:, 0] + w]
        angles, periods, pair = generate_periodicity(losses, shifts)
        if angles is None:
            continue
        all_angles.append(angles)
        all_periods.append(periods)
        all_shifts.append(pair)
    return all_angles, all_periods, all_shifts


def search_periodicity_by_feat(img_u8: np.ndarray, mask: np.ndarray,
                               repeat_range=(2, 32, 5), edge_searching=True,
                               gray_only=True,
                               device: Optional[torch.device] = None):
    """Full detection: features -> (edges) -> search -> scale back x4
    (reference: feature_searching.py:158-204)."""
    activation, m = im2act(img_u8, mask, gray_only=gray_only)
    if edge_searching:
        edge = act2edge(activation[:-1], m)
        activation = activation * edge[[0]]

    angles, periods, shifts = feature_search(
        activation, m, repeat_range=repeat_range,
        edge_searching=edge_searching, device=device)

    ratio = float(np.round(img_u8.shape[0] / activation.shape[1]))
    periods = [[p * ratio for p in ps] for ps in periods]
    shifts = [[s * ratio for s in pair] for pair in shifts]
    return angles, periods, shifts


def lattice_to_proposal(d1_xy, d2_xy):
    """Two lattice displacement vectors as the (angles, periods) pair the
    embedders take: each direction's angle comes from the other vector, its
    period is this vector's length across the lattice (reference:
    feature_searching.py:140-155)."""
    d1 = np.asarray(d1_xy, np.float64)
    d2 = np.asarray(d2_xy, np.float64)
    angles = [shifts2angle(d2), shifts2angle(d1)]
    periods = [shifts2period(d1, d2), shifts2period(d2, d1)]
    return angles, periods
