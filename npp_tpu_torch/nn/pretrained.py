"""Weights for the conv towers and the LPIPS heads.

Port of `npp_tpu/nn/pretrained.py`. A tower's weights resolve in the JAX
package's order, from its environment variables:

 1. `npp_tpu_torch/assets/<name>.npz`   converted weights, flat keys
                                         '<conv>/kernel' (HWIO) and '<conv>/bias'
 2. `$NPP_TPU_WEIGHTS_DIR/<name>.npz`   the same, from a user's directory
 3. `$NPP_TPU_TORCH_WEIGHTS/<name>.pth` a torchvision state_dict, mapped by
                                         utils/torch_convert.py (OIHW kept)
 4. analytic structured weights         (nn/analytic.py: Gabor stem +
                                         orthogonal mixing), identical to the
                                         JAX package's for the same tower name
 5. flax's default init                 with NPP_TPU_FALLBACK set to anything
                                         but 'analytic': truncated-normal
                                         LeCun kernels, zero biases, drawn
                                         from a torch.Generator seeded with
                                         the tower's seed. The distribution
                                         is flax's; the numbers are not
                                         jax.random's.

A conv is named as the flax modules name it: 'conv<i>', or
'fire<i>/<part>' in SqueezeNet. Towers are cached per process, keyed by
name, the convs asked for, the device and the three environment variables;
callers share the tensors and must not modify them. `weight_reports()`
says which source each tower and LPIPS head took (the segmentation
refinement's `seg_autocal='auto'` reads it).
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

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

_TOWERS: Dict[tuple, tuple] = {}   # key -> (params, WeightReport)
_LOCK = threading.Lock()


@dataclass
class WeightReport:
    name: str
    source: str   # 'asset' | 'weights_dir' | 'torch' | 'analytic' | 'random'

    @property
    def pretrained(self) -> bool:
        """True only for converted checkpoints: analytic weights are
        structured but not calibrated to the reference's thresholds."""
        return self.source not in ('random', 'analytic')


_REPORTS: Dict[str, WeightReport] = {}


def weight_reports() -> Dict[str, WeightReport]:
    """{weight set name: WeightReport} for every tower and LPIPS head
    loaded in this process."""
    return dict(_REPORTS)


class _Shape:
    """A leaf that carries only a shape (all the analytic generator reads)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def tower_seed(name: str) -> int:
    """Little-endian int of the name's first 4 bytes (pretrained.py:174)."""
    return int.from_bytes(name.encode()[:4].ljust(4, b'\0'), 'little')


def _find_npz(name: str) -> Optional[str]:
    """The asset, else $NPP_TPU_WEIGHTS_DIR/<name>.npz, else None."""
    cands = [os.path.join(ASSET_DIR, f'{name}.npz')]
    wd = os.environ.get('NPP_TPU_WEIGHTS_DIR')
    if wd:
        cands.append(os.path.join(wd, f'{name}.npz'))
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def _find_pth(name: str) -> Optional[str]:
    td = os.environ.get('NPP_TPU_TORCH_WEIGHTS')
    path = os.path.join(td, f'{name}.pth') if td else None
    return path if path and os.path.exists(path) else None


def _tree(flat: Dict[str, object]) -> Dict[str, dict]:
    """{'fire3/squeeze': shape} -> {'fire3': {'squeeze': {'kernel':
    _Shape, 'bias': _Shape}}}, the tree the analytic walk reads."""
    tree: Dict[str, dict] = {}
    for path, s in flat.items():
        d = tree
        for p in path.split('/'):
            d = d.setdefault(p, {})
        d.update(kernel=_Shape(s), bias=_Shape((s[3],)))
    return tree


def analytic_tower_hwio(name: str, conv_shapes: Dict[str, tuple],
                        only=None) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The JAX package's analytic weights, {conv path: (kernel HWIO,
    bias)}. Seeds follow the lexical walk of ALL the tower's convs
    (conv10 sorts before conv2; fire10 before fire3, and inside a fire
    expand1x1, expand3x3, squeeze), so the full shape dict is passed;
    `only` (top-level names) drops the rest after their seeds are
    counted."""
    gen = structured_tower_params(_tree(conv_shapes), tower_seed(name),
                                  only=only)
    out = {}
    for path in conv_shapes:
        d = gen
        for p in path.split('/'):
            d = d.get(p) if d is not None else None
        if d is not None:
            out[path] = (d['kernel'], d['bias'])
    return out


def flax_default_init(name: str, conv_shapes: Dict[str, tuple]
                      ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The fallback NPP_TPU_FALLBACK=random: flax's default conv init
    (lecun_normal: a normal truncated at two standard deviations, scaled
    to variance 1 / fan_in; zero biases), {path: (kernel OIHW, bias)}, in
    sorted path order from a generator seeded with the tower's seed."""
    gen = torch.Generator().manual_seed(tower_seed(name))
    out = {}
    for path in sorted(conv_shapes):
        kh, kw, cin, cout = conv_shapes[path]
        # flax's variance_scaling: the stddev of a unit normal truncated
        # at +-2 is 0.8796...
        std = float(np.sqrt(1.0 / (kh * kw * cin))) / .87962566103423978
        w = torch.empty((cout, cin, kh, kw))
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[path] = ((w * std).numpy(), np.zeros(cout, np.float32))
    return out


def _resolve(name: str, conv_shapes: Dict[str, tuple], only
             ) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], str]:
    """({path: (weight OIHW, bias)}, source) from the first source that
    has the weights."""
    def hwio_to_oihw(k):
        return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))

    npz = _find_npz(name)
    if npz is not None:
        with np.load(npz) as f:
            convs = {p: (hwio_to_oihw(f[f'{p}/kernel']), f[f'{p}/bias'])
                     for p in conv_shapes}
        return convs, ('asset' if npz.startswith(ASSET_DIR)
                       else 'weights_dir')
    pth = _find_pth(name)
    if pth is not None:
        from ..utils.torch_convert import convert_state_dict
        return convert_state_dict(name, pth), 'torch'
    if os.environ.get('NPP_TPU_FALLBACK', 'analytic') == 'analytic':
        convs = analytic_tower_hwio(name, conv_shapes, only)
        return {p: (hwio_to_oihw(k), b) for p, (k, b) in convs.items()}, \
            'analytic'
    return flax_default_init(name, conv_shapes), 'random'


def load_tower_params(name: str, conv_shapes: Dict[str, tuple],
                      n_convs: Optional[int], device: torch.device) -> Params:
    """{conv path: (weight OIHW, bias)} of the tower `name`, whose convs
    have the HWIO shapes `conv_shapes`: conv0..conv<n_convs-1>, or every
    conv with n_convs=None."""
    only = None if n_convs is None else {f'conv{i}' for i in range(n_convs)}
    env = tuple(os.environ.get(k) for k in (
        'NPP_TPU_FALLBACK', 'NPP_TPU_WEIGHTS_DIR', 'NPP_TPU_TORCH_WEIGHTS'))
    key = (name, n_convs, str(device), env)
    with _LOCK:
        hit = _TOWERS.get(key)
        if hit is not None:
            _REPORTS[name] = hit[1]
            return hit[0]
        convs, source = _resolve(name, conv_shapes, only)
        wanted = [p for p in conv_shapes
                  if only is None or p.split('/')[0] in only]
        params = {p: (torch.as_tensor(np.asarray(convs[p][0]),
                                      dtype=torch.float32, device=device),
                      torch.as_tensor(np.asarray(convs[p][1]),
                                      dtype=torch.float32, device=device))
                  for p in wanted}
        report = WeightReport(name, source)
        _REPORTS[name] = report
        _TOWERS[key] = (params, report)
        return params


def load_lpips_lins(net: str = 'vgg', device: Optional[torch.device] = None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """LPIPS linear calibration heads, shapes (C,) per layer, from the
    asset or the weights directory; None (reported 'random') when neither
    has them. Reported 'asset' wherever found, as npp_tpu reports it."""
    name = f'lpips_lin_{net}'
    npz = _find_npz(name)
    _REPORTS[name] = WeightReport(name, 'random' if npz is None else 'asset')
    if npz is None:
        return None
    with np.load(npz) as f:
        return {k: torch.as_tensor(f[k], dtype=torch.float32, device=device)
                for k in f.files}
