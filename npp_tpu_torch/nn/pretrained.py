"""Weights for the conv towers and the LPIPS heads.

Port of the asset and analytic paths of `npp_tpu/nn/pretrained.py`:

 1. `npp_tpu_torch/assets/<name>.npz`  converted weights, flat keys
                                        'conv<i>/kernel' (HWIO) and 'conv<i>/bias'
 2. analytic structured weights        (nn/analytic.py: Gabor stem +
                                        orthogonal mixing), identical to the
                                        JAX package's for the same tower name

The `.pth` conversion path and the flat random fallback are not ported yet.
Towers are cached per process, keyed by name, depth and device; callers
share the tensors and must not modify them. `weight_reports()` says which
path each tower took (the segmentation refinement's `seg_autocal='auto'`
reads it).
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .analytic import structured_tower_params

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'assets')

_TOWERS: Dict[tuple, Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = {}
_LOCK = threading.Lock()


@dataclass
class WeightReport:
    name: str
    source: str   # 'asset' | 'analytic'

    @property
    def pretrained(self) -> bool:
        """True only for converted checkpoints: analytic weights are
        structured but not calibrated to the reference's thresholds."""
        return self.source != 'analytic'


_REPORTS: Dict[str, WeightReport] = {}


def weight_reports() -> Dict[str, WeightReport]:
    """{tower name: WeightReport} for every tower loaded in this process."""
    return dict(_REPORTS)


class _Shape:
    """A leaf that carries only a shape (all the analytic generator reads)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def tower_seed(name: str) -> int:
    """Little-endian int of the name's first 4 bytes (pretrained.py:174)."""
    return int.from_bytes(name.encode()[:4].ljust(4, b'\0'), 'little')


def analytic_tower_hwio(name: str, conv_shapes: Dict[str, tuple],
                        n_convs: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX package's analytic weights for convs conv0..conv<n_convs-1>,
    HWIO. Seeds follow the lexical order of ALL the tower's conv names
    (conv10 sorts before conv2), so the full shape list is passed."""
    tree = {k: {'kernel': _Shape(s), 'bias': _Shape((s[3],))}
            for k, s in conv_shapes.items()}
    only = {f'conv{i}' for i in range(n_convs)}
    return structured_tower_params(tree, tower_seed(name), only=only)


def load_tower_params(name: str, conv_shapes: Dict[str, tuple], n_convs: int,
                      device: torch.device
                      ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{'conv<i>': (weight OIHW, bias)} for the first n_convs convs."""
    key = (name, n_convs, str(device))
    with _LOCK:
        hit = _TOWERS.get(key)
        if hit is not None:
            return hit
        path = os.path.join(ASSET_DIR, f'{name}.npz')
        _REPORTS[name] = WeightReport(
            name, 'asset' if os.path.exists(path) else 'analytic')
        if os.path.exists(path):
            with np.load(path) as f:
                hwio = {f'conv{i}': {'kernel': f[f'conv{i}/kernel'],
                                     'bias': f[f'conv{i}/bias']}
                        for i in range(n_convs)}
        else:
            hwio = analytic_tower_hwio(name, conv_shapes, n_convs)
        params = {
            k: (torch.as_tensor(np.ascontiguousarray(
                    np.transpose(v['kernel'], (3, 2, 0, 1))),
                    dtype=torch.float32, device=device),
                torch.as_tensor(v['bias'], dtype=torch.float32, device=device))
            for k, v in hwio.items()}
        _TOWERS[key] = params
        return params


def load_lpips_lins(net: str = 'vgg', device: Optional[torch.device] = None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """LPIPS linear calibration heads, shapes (C,) per layer, or None when
    the asset is missing."""
    path = os.path.join(ASSET_DIR, f'lpips_lin_{net}.npz')
    if not os.path.exists(path):
        return None
    with np.load(path) as f:
        return {k: torch.as_tensor(f[k], dtype=torch.float32, device=device)
                for k in f.files}
