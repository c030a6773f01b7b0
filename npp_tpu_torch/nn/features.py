"""VGG, AlexNet and SqueezeNet conv feature towers in PyTorch, NCHW inside.

Port of `npp_tpu/nn/features.py::VGGFeatures`, `SqueezeNetFeatures` (the
LPIPS 'squeeze' trunk, SqueezeNet 1.1) and `AlexNetFeatures`, the latter
in both of its layouts: the torchvision one (`owt=False`, the
LPIPS-alex tower; reference: externel_lib/lpips/pretrained_networks.py)
and the reference's local checkpoint's (`owt=True`, conv1 padding 5 and
max-pools padded by 1; reference: models/alexnet.py:18-32), whose conv1
the colour search reads (reference: contextual_loss/modules/vgg.py for
the VGG towers).
Convs are named `conv0`, `conv1`, ... as the flax modules name them
(SqueezeNet: `conv0` and `fire<i>/{squeeze,expand1x1,expand3x3}`, i the
torchvision features index), and taps keep their names: for VGG
relu{block}_{idx} after each ReLU and pool{block} after each maxpool, for
AlexNet conv1 (before its ReLU) and relu1..relu5, for SqueezeNet
relu1..relu7. A tower stops at the deepest tap the caller asks for (XLA
dropped the unused layers for the JAX package; eager PyTorch would run
them). `dtype` is the activations' dtype (flax's `dtype`: the weights are
cast per call, the input on entry).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (convs_per_block, channels) per block
VGG16_BLOCKS: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
VGG19_BLOCKS: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))

VGG16_LPIPS_TAPS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')
# the style loss's taps: after the first three maxpools (reference:
# models/style_loss.py:11-14)
VGG16_STYLE_TAPS = ('pool1', 'pool2', 'pool3')
VGG19_CX_TAP = 'relu3_4'
ALEX_LPIPS_TAPS = ('relu1', 'relu2', 'relu3', 'relu4', 'relu5')
# HWIO kernel shapes of the torchvision AlexNet's five convs
ALEX_CONV_SHAPES: Dict[str, Tuple[int, int, int, int]] = {
    'conv0': (11, 11, 3, 64), 'conv1': (5, 5, 64, 192),
    'conv2': (3, 3, 192, 384), 'conv3': (3, 3, 384, 256),
    'conv4': (3, 3, 256, 256)}

SQUEEZE_LPIPS_TAPS = ('relu1', 'relu2', 'relu3', 'relu4', 'relu5', 'relu6',
                      'relu7')
# SqueezeNet 1.1's fire modules by torchvision features index: (squeeze,
# expand) widths; each puts out 2 * expand channels
SQUEEZE_FIRES: Tuple[Tuple[int, int, int], ...] = (
    (3, 16, 64), (4, 16, 64), (6, 32, 128), (7, 32, 128), (9, 48, 192),
    (10, 48, 192), (11, 64, 256), (12, 64, 256))


def squeeze_conv_shapes() -> Dict[str, Tuple[int, int, int, int]]:
    """{'conv0' or 'fire<i>/<part>': HWIO kernel shape} of SqueezeNet 1.1."""
    shapes = {'conv0': (3, 3, 3, 64)}
    cin = 64
    for i, sq, ex in SQUEEZE_FIRES:
        shapes[f'fire{i}/squeeze'] = (1, 1, cin, sq)
        shapes[f'fire{i}/expand1x1'] = (1, 1, sq, ex)
        shapes[f'fire{i}/expand3x3'] = (3, 3, sq, ex)
        cin = 2 * ex
    return shapes


IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def vgg_conv_shapes(blocks) -> Dict[str, Tuple[int, int, int, int]]:
    """{'conv<i>': HWIO kernel shape} over the whole tower."""
    shapes, cin, idx = {}, 3, 0
    for n_convs, ch in blocks:
        for _ in range(n_convs):
            shapes[f'conv{idx}'] = (3, 3, cin, ch)
            cin, idx = ch, idx + 1
    return shapes


Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _cast(params: Params, dtype: torch.dtype) -> Params:
    if dtype == torch.float32:
        return params
    return {k: (w.to(dtype), b.to(dtype)) for k, (w, b) in params.items()}


class VGGFeatures:
    """VGG-16/19 tower with fixed weights: {'conv<i>': (weight OIHW, bias)}.
    __call__(x NCHW, taps) -> {tap: activation NCHW} in `dtype`."""

    def __init__(self, params: Params, blocks=VGG16_BLOCKS,
                 dtype: torch.dtype = torch.float32):
        self.params = _cast(params, dtype)
        self.blocks = blocks
        self.dtype = dtype

    def __call__(self, x: torch.Tensor, taps: Sequence[str]
                 ) -> Dict[str, torch.Tensor]:
        wanted = set(taps)
        x = cpu_nchw(x.to(self.dtype))
        outs: Dict[str, torch.Tensor] = {}
        conv_idx = 0
        for b, (n_convs, _) in enumerate(self.blocks, start=1):
            for i in range(1, n_convs + 1):
                w, bias = self.params[f'conv{conv_idx}']
                x = torch.relu(F.conv2d(x, w, bias, padding=1))
                conv_idx += 1
                outs[f'relu{b}_{i}'] = x
                if wanted <= outs.keys():
                    return {t: outs[t] for t in taps}
            x = F.max_pool2d(x, 2, 2)
            outs[f'pool{b}'] = x
            if wanted <= outs.keys():
                return {t: outs[t] for t in taps}
        raise KeyError(f'unknown taps {sorted(wanted - outs.keys())}')


class AlexNetFeatures:
    """The AlexNet tower with fixed weights {'conv<i>': (weight OIHW,
    bias)}: the torchvision form (`owt=False`: conv1 padding 2, unpadded
    3x3 maxpools) or the reference checkpoint's (`owt=True`: conv1
    padding 5, maxpools padded by 1 with -inf, as flax pads them).
    __call__(x NCHW, taps) -> {tap: activation NCHW} in `dtype`."""

    # (stride, padding, maxpool before the conv)
    LAYERS = ((4, 2, False), (1, 2, True), (1, 1, True), (1, 1, False),
              (1, 1, False))

    def __init__(self, params: Params, dtype: torch.dtype = torch.float32,
                 owt: bool = False):
        self.params = _cast(params, dtype)
        self.dtype = dtype
        self.owt = owt

    def __call__(self, x: torch.Tensor, taps: Sequence[str]
                 ) -> Dict[str, torch.Tensor]:
        wanted = set(taps)
        x = cpu_nchw(x.to(self.dtype))
        outs: Dict[str, torch.Tensor] = {}
        for i, (stride, pad, pool) in enumerate(self.LAYERS):
            if pool:
                x = F.max_pool2d(x, 3, 2, padding=1 if self.owt else 0)
            if i == 0 and self.owt:
                pad = 5
            w, bias = self.params[f'conv{i}']
            x = F.conv2d(x, w, bias, stride=stride, padding=pad)
            if i == 0:
                outs['conv1'] = x
            x = torch.relu(x)
            outs[f'relu{i + 1}'] = x
            if wanted <= outs.keys():
                return {t: outs[t] for t in taps}
        raise KeyError(f'unknown taps {sorted(wanted - outs.keys())}')


def fire(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """SqueezeNet's fire module: a 1x1 squeeze, then 1x1 and 3x3 expands
    side by side, each after a ReLU, concatenated over channels
    (torchvision squeezenet1_1.Fire)."""
    s = torch.relu(F.conv2d(x, *params[f'{name}/squeeze']))
    e1 = torch.relu(F.conv2d(s, *params[f'{name}/expand1x1']))
    e3 = torch.relu(F.conv2d(s, *params[f'{name}/expand3x3'], padding=1))
    return torch.cat([e1, e3], dim=1)


class SqueezeNetFeatures:
    """SqueezeNet 1.1, the LPIPS 'squeeze' trunk (reference:
    externel_lib/lpips/pretrained_networks.py:5-54), with fixed weights
    {'conv0' or 'fire<i>/<part>': (weight OIHW, bias)}. Its 3x3 max-pools
    keep a last partial window (ceil_mode, npp_tpu's _ceil_max_pool).
    __call__(x NCHW, taps) -> {tap: activation NCHW} in `dtype`; relu1..7
    have 64/128/256/384/384/512/512 channels."""

    # (fires, the tap after them, max-pool before them)
    STAGES = (((3, 4), 'relu2', True), ((6, 7), 'relu3', True),
              ((9,), 'relu4', True), ((10,), 'relu5', False),
              ((11,), 'relu6', False), ((12,), 'relu7', False))

    def __init__(self, params: Params, dtype: torch.dtype = torch.float32):
        self.params = _cast(params, dtype)
        self.dtype = dtype

    def __call__(self, x: torch.Tensor, taps: Sequence[str]
                 ) -> Dict[str, torch.Tensor]:
        wanted = set(taps)
        x = cpu_nchw(x.to(self.dtype))
        x = torch.relu(F.conv2d(x, *self.params['conv0'], stride=2))
        outs: Dict[str, torch.Tensor] = {'relu1': x}
        for fires, tap, pool in self.STAGES:
            if wanted <= outs.keys():
                return {t: outs[t] for t in taps}
            if pool:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for i in fires:
                x = fire(x, self.params, f'fire{i}')
            outs[tap] = x
        if wanted <= outs.keys():
            return {t: outs[t] for t in taps}
        raise KeyError(f'unknown taps {sorted(wanted - outs.keys())}')


def cpu_nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW-contiguous copy of a CPU tensor; a CUDA tensor as it is.

    The towers are called on permuted NHWC images, which are channels-last
    in memory. PyTorch's CPU convolutions accumulate channels-last input
    less accurately than NCHW, and a ReLU that flipped on that error took
    the LPIPS input gradient far from float64 on some hosts
    (scripts/lpips_grad_vs_float64.py measures both layouts). On the card
    cuDNN keeps the channels-last layout."""
    return x.contiguous() if x.device.type == 'cpu' else x


def imagenet_normalize(img01: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on [0,1] NHWC images."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img01.device)
    std = torch.as_tensor(IMAGENET_STD, device=img01.device)
    return (img01 - mean) / std
