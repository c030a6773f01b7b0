"""VGG conv feature towers in PyTorch, NCHW inside.

Port of `npp_tpu/nn/features.py::VGGFeatures` (reference:
externel_lib/lpips/pretrained_networks.py, contextual_loss/modules/vgg.py).
Convs are named `conv0`, `conv1`, ... as the flax module names them, and
taps keep its names: relu{block}_{idx} after each ReLU, pool{block} after
each maxpool. The tower stops at the deepest tap the caller asks for (XLA
dropped the unused layers for the JAX package; eager PyTorch would run
them). AlexNet and SqueezeNet are not ported yet.
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


class VGGFeatures:
    """VGG-16/19 tower with fixed weights: {'conv<i>': (weight OIHW, bias)}.
    __call__(x NCHW, taps) -> {tap: activation NCHW}."""

    def __init__(self, params: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 blocks=VGG16_BLOCKS):
        self.params = params
        self.blocks = blocks

    def __call__(self, x: torch.Tensor, taps: Sequence[str]
                 ) -> Dict[str, torch.Tensor]:
        wanted = set(taps)
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


def imagenet_normalize(img01: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std on [0,1] NHWC images."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img01.device)
    std = torch.as_tensor(IMAGENET_STD, device=img01.device)
    return (img01 - mean) / std
