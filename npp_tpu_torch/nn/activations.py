"""Activation functions (reference: models/activations.py:9-48), as in
`npp_tpu/nn/activations.py`. Only functional forms, no module state."""
from __future__ import annotations

import torch


def snake(x: torch.Tensor, a: float = 1.0) -> torch.Tensor:
    """x + sin^2(a x)/a (reference: models/activations.py:29-35)."""
    return x + torch.square(torch.sin(a * x)) / a


_ACTIVATIONS = {
    'snake': snake,
    'relu': torch.relu,
    'sin': torch.sin,
    'sin_plus_cos': lambda x: torch.sin(x) + torch.cos(x),
    'x_sin': lambda x: x + torch.sin(x),
    'tanh': torch.tanh,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f'Unknown activation: {name}') from None
