"""torchvision checkpoint -> the towers' conv names, for
`$NPP_TPU_TORCH_WEIGHTS/<name>.pth` (nn/pretrained.py).

The port's copy of the key mapping of `npp_tpu/utils/torch_convert.py`:
torchvision's `features.{i}.weight/bias` convs become `conv0..convN` in
index order (AlexNet, VGG), and SqueezeNet 1.1's Fire modules
`features.{i}.{squeeze,expand1x1,expand3x3}` become `fire{i}/<part>`.
PyTorch's OIHW layout is kept: the port's towers run OIHW, so there is no
round trip through flax's HWIO.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Conv = Tuple[np.ndarray, np.ndarray]   # (weight OIHW, bias)

SQUEEZE_FIRES = (3, 4, 6, 7, 9, 10, 11, 12)
SQUEEZE_PARTS = ('squeeze', 'expand1x1', 'expand3x3')


def _seq_conv_map(state: Dict[str, np.ndarray]) -> Dict[str, Conv]:
    """features.{idx} convs renumbered conv0..N in index order."""
    conv_ids = sorted({int(k.split('.')[1]) for k in state
                       if k.startswith('features.') and k.endswith('.weight')
                       and state[k].ndim == 4})
    return {f'conv{n}': (state[f'features.{i}.weight'],
                         state[f'features.{i}.bias'])
            for n, i in enumerate(conv_ids)}


def _squeeze_map(state: Dict[str, np.ndarray]) -> Dict[str, Conv]:
    """torchvision squeezenet1_1: features.0 conv and the Fire modules at
    features 3, 4, 6, 7, 9, 10, 11, 12."""
    out = {'conv0': (state['features.0.weight'], state['features.0.bias'])}
    for i in SQUEEZE_FIRES:
        for part in SQUEEZE_PARTS:
            out[f'fire{i}/{part}'] = (state[f'features.{i}.{part}.weight'],
                                      state[f'features.{i}.{part}.bias'])
    return out


def convert_state_dict(name: str, path: str) -> Dict[str, Conv]:
    """{'conv<n>' or 'fire<i>/<part>': (weight OIHW, bias)} of the
    checkpoint at `path` for the weight set `name`."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    state = {k: v.numpy() for k, v in state.items()
             if isinstance(v, torch.Tensor)}
    if name in ('alexnet_owt', 'alexnet_tv', 'vgg16', 'vgg19'):
        return _seq_conv_map(state)
    if name == 'squeeze_tv':
        return _squeeze_map(state)
    raise ValueError(f'No converter for weight set {name!r}')
