"""Analytic (training-free) conv-tower weights: the principled fallback when
torchvision checkpoints are not available. A numpy-only copy of
`npp_tpu/nn/analytic.py`, so both packages generate identical towers.

The reference's perceptual stack (LPIPS / contextual / style; reference:
externel_lib/lpips/pretrained_networks.py, models/style_loss.py:10-14) sits
on ImageNet-pretrained towers. Without the checkpoints, a plain random init
gives weak, unstructured features. This module builds towers that mimic the
*structure* of learned ones without any training:

 - stem (the conv taking 3 input channels): a Gabor bank over luminance and
   color-opponent axes plus center-surround (DoG) and low-pass filters —
   the well-documented shape of AlexNet/VGG first-layer filters;
 - deeper convs: orthogonal kernels with ReLU gain sqrt(2), which preserve
   activation norms through depth (dynamical isometry) — the scattering-
   transform recipe of fixed wavelets + norm-preserving mixing.

Both LPIPS (channel-unit-norm per layer) and the contextual loss (cosine
distances) are scale-invariant per layer, so no calibration constants are
needed; only the *relative geometry* of the features matters, which is what
the oriented band-pass stem provides. Used by nn/pretrained.py when no
converted checkpoint ships in assets/.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Set

import numpy as np

# color axes: luminance + two opponent channels (unit-norm rows)
_LUM = np.asarray([0.299, 0.587, 0.114])
_COLOR_AXES = np.stack([
    _LUM / np.linalg.norm(_LUM),
    np.asarray([1.0, -1.0, 0.0]) / np.sqrt(2.0),     # R-G opponent
    np.asarray([-1.0, -1.0, 2.0]) / np.sqrt(6.0),    # B-Y opponent
])


def _gabor(k: int, theta: float, lam: float, phase: float,
           gamma: float = 0.7) -> np.ndarray:
    """k x k Gabor, sigma tied to wavelength (sigma = 0.56*lam, the standard
    bandwidth-1-octave relation), zero-mean, unit-norm."""
    r = (k - 1) / 2.0
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    xr = x * np.cos(theta) + y * np.sin(theta)
    yr = -x * np.sin(theta) + y * np.cos(theta)
    sigma = max(0.56 * lam, 0.6)
    g = np.exp(-(xr ** 2 + (gamma * yr) ** 2) / (2 * sigma ** 2))
    f = g * np.cos(2 * np.pi * xr / lam + phase)
    f = f - f.mean() * g / max(g.mean(), 1e-12)  # zero-mean under envelope
    f = f - f.mean()
    n = np.linalg.norm(f)
    return f / n if n > 1e-8 else f


def _dog(k: int, ratio: float = 1.6) -> np.ndarray:
    """Center-surround difference-of-Gaussians, zero-mean, unit-norm."""
    r = (k - 1) / 2.0
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    d2 = x ** 2 + y ** 2
    s1 = max(k / 6.0, 0.5)
    s2 = ratio * s1
    f = (np.exp(-d2 / (2 * s1 ** 2)) / s1 ** 2
         - np.exp(-d2 / (2 * s2 ** 2)) / s2 ** 2)
    f = f - f.mean()
    return f / np.linalg.norm(f)


def _lowpass(k: int) -> np.ndarray:
    r = (k - 1) / 2.0
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    f = np.exp(-(x ** 2 + y ** 2) / (2 * max(k / 4.0, 0.6) ** 2))
    return f / np.linalg.norm(f)


def gabor_stem(k: int, in_ch: int, out_ch: int, seed: int = 0) -> np.ndarray:
    """HWIO stem kernel: a product grid of (orientation, wavelength, phase,
    color axis) Gabors, interleaved with DoG and low-pass filters per color
    axis. Deterministic given (shape, seed)."""
    rng = np.random.RandomState(seed)
    axes = _COLOR_AXES if in_ch == 3 else np.eye(in_ch)
    n_axes = len(axes)

    # wavelengths spanning the kernel's representable band
    if k >= 7:
        lams = [k / 1.0, k / 2.0, k / 3.5]
    elif k >= 5:
        lams = [k / 1.0, k / 2.0]
    else:
        lams = [2.5, 4.0]
    thetas = [i * np.pi / 8 for i in range(8)]
    phases = [0.0, np.pi / 2]

    fixed = []
    for ax in axes:  # smooth + center-surround per color axis
        fixed.append((_lowpass(k), ax))
        fixed.append((_dog(k), ax))
    grid = [(th, lam, ph, ax_i)
            for lam in lams for th in thetas for ph in phases
            for ax_i in range(n_axes)]
    # luminance-first ordering: cycle color axes slowest for small out_ch
    grid.sort(key=lambda t: (t[3], lams.index(t[1])))

    filters = []
    for i in range(out_ch):
        if i < len(fixed):
            f2d, ax = fixed[i]
        else:
            j = (i - len(fixed)) % len(grid)
            th, lam, ph, ax_i = grid[j]
            # jitter repeats so duplicated slots stay linearly independent
            rep = (i - len(fixed)) // len(grid)
            if rep:
                th = th + rng.uniform(-np.pi / 16, np.pi / 16)
                lam = lam * rng.uniform(0.85, 1.18)
            f2d, ax = _gabor(k, th, lam, ph), axes[ax_i]
        filters.append(f2d[..., None] * ax[None, None, :])
    w = np.stack(filters, axis=-1)  # (k, k, in_ch, out_ch)
    # scale for O(1) responses on [0,1] images (unit-norm filters already)
    return (w * np.sqrt(2.0)).astype(np.float32)


def orthogonal_kernel(shape, seed: int, gain: float = np.sqrt(2.0)) -> np.ndarray:
    """HWIO conv kernel whose (fan_in, out) matrix is scaled-orthogonal:
    norm-preserving mixing for post-ReLU activations."""
    kh, kw, cin, cout = shape
    fan_in = kh * kw * cin
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((max(fan_in, cout), min(fan_in, cout)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))  # fix sign ambiguity for determinism
    if fan_in < cout:
        q = q.T
    q = q[:fan_in, :cout]
    # q columns are orthonormal when fan_in >= cout; scale by relu gain
    return (gain * q).reshape(kh, kw, cin, cout).astype(np.float32)


def structured_tower_params(params: Dict[str, Any], seed: int,
                            only: Optional[Set[str]] = None) -> Dict[str, Any]:
    """Replace every conv kernel in a params tree named as the JAX package
    names it ({'conv0': {'kernel': HWIO, 'bias': ...}, ...}): the
    3-input-channel stem gets the Gabor bank, everything else
    scaled-orthogonal; biases 0. Kernels are returned HWIO.

    Only leaf SHAPES are read, so `params` may hold real arrays or abstract
    leaves with a `.shape` — the generated weights are identical either way.
    Any non-conv leaf that arrives as an abstract struct is materialised as
    zeros (the conv towers used here have none).

    only: generate just these conv names and drop the rest. The seeds still
    follow every conv's place in the lexical walk, so the generated ones
    equal those of a full call (a tower cut at a shallow tap skips the deep
    layers' QR decompositions)."""
    counter = [0]

    def materialize(leaf):
        if hasattr(leaf, '__array__') or np.isscalar(leaf):
            return leaf  # concrete value: pass through
        return np.zeros(tuple(leaf.shape),
                        getattr(leaf, 'dtype', np.float32))

    def walk(tree):
        out = {}
        for name, sub in sorted(tree.items()):
            if isinstance(sub, dict) and 'kernel' in sub \
                    and getattr(sub['kernel'], 'ndim', 0) == 4:
                shape = tuple(sub['kernel'].shape)
                counter[0] += 1
                if only is not None and name not in only:
                    continue
                if shape[2] == 3:  # RGB stem
                    new = gabor_stem(shape[0], 3, shape[3],
                                     seed=seed + counter[0])
                else:
                    new = orthogonal_kernel(shape, seed + counter[0])
                rep = {'kernel': new}
                if 'bias' in sub:
                    rep['bias'] = np.zeros(tuple(sub['bias'].shape),
                                           np.float32)
                out[name] = rep
            elif isinstance(sub, dict):
                out[name] = walk(sub)
            else:
                out[name] = materialize(sub)
        return out

    return walk(params)
