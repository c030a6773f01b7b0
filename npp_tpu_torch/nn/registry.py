"""Named feature-extractor registry (reference: models/model_def.py:22-36),
a port of `npp_tpu/nn/registry.py`: every registered name builds its
tower on the weights `nn/pretrained.py` finds for it."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .features import (ALEX_CONV_SHAPES, VGG16_BLOCKS, VGG19_BLOCKS,
                       AlexNetFeatures, VGGFeatures, vgg_conv_shapes)
from .pretrained import load_tower_params

# name -> (weights' name, default tap)
_MODELS = {'alexnet': ('alexnet_owt', 'conv1'),
           'alexnet_tv': ('alexnet_tv', 'relu1'),
           'vgg16': ('vgg16', 'relu3_3'),
           'vgg19': ('vgg19', 'relu3_4')}


def get_feature_extractor(name: str, device: Optional[torch.device] = None
                          ) -> Tuple[Callable, str]:
    """Returns (apply_fn, default_tap): apply_fn(img NHWC, taps=None) ->
    {tap: activation NHWC}, the default tap unless taps are named."""
    if name not in _MODELS:
        raise NotImplementedError(f'Unknown model name: {name}.')
    weights, tap = _MODELS[name]
    device = torch.device('cpu') if device is None else device
    if name.startswith('alexnet'):
        tower = AlexNetFeatures(load_tower_params(
            weights, ALEX_CONV_SHAPES, len(ALEX_CONV_SHAPES), device),
            owt=name == 'alexnet')
    else:
        shapes = vgg_conv_shapes(VGG16_BLOCKS if name == 'vgg16'
                                 else VGG19_BLOCKS)
        tower = VGGFeatures(load_tower_params(weights, shapes, len(shapes),
                                              device),
                            VGG16_BLOCKS if name == 'vgg16' else VGG19_BLOCKS)

    def apply_fn(img: torch.Tensor, taps: Optional[Sequence[str]] = None
                 ) -> Dict[str, torch.Tensor]:
        outs = tower(img.permute(0, 3, 1, 2), tuple(taps or (tap,)))
        return {k: v.permute(0, 2, 3, 1) for k, v in outs.items()}

    return apply_fn, tap


def get_available_models():
    """reference: model_def.py:18-19."""
    return list(_MODELS)
