"""NPP-Net fit models in PyTorch (reference: models/networks.py:8-173), ports
of `npp_tpu/nn/mlp.py::NPPNet` and `NPPNetTop1`.

Layers are `nn.Linear` with its default init, U(+-1/sqrt(fan_in)) for weight
and bias, the same distribution as the JAX package's TorchLinear
(npp_tpu/nn/mlp.py:27-42). Parameter names follow the flax names
(`periodic_0`, ..., `feature1`, `scale_0`, `feature2`, `pos_0`, `rgb`) so
utils/convert.py maps one onto the other.

With the snake activation each activated layer is a bias-free matmul
followed by K2 (kernels/snake.py: bias + snake, a Triton kernel on CUDA).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.snake import bias_snake
from .activations import get_activation


def _act_linear(layer: nn.Linear, x: torch.Tensor, activation: str
                ) -> torch.Tensor:
    """act(layer(x)); snake goes through K2 on the bias-free product."""
    if activation == 'snake':
        lead = x.shape[:-1]
        h = F.linear(x.reshape(-1, x.shape[-1]), layer.weight)
        return bias_snake(h, layer.bias).reshape(*lead, -1)
    return get_activation(activation)(layer(x))


class NPPNet(nn.Module):
    """Top-K fit model (reference: models/networks.py:8-95). The input
    widths are the channel counts after the Fourier re-encode."""

    def __init__(self, input_ch_periodic: int, input_ch_periodic_aux: int,
                 depth: int = 8, width: int = 512, output_ch: int = 3,
                 skips: Tuple[int, ...] = (4,), activation: str = 'snake'):
        super().__init__()
        self.input_ch_periodic = input_ch_periodic
        self.depth, self.skips, self.activation = depth, tuple(skips), activation
        d_in = input_ch_periodic
        for i in range(depth):
            setattr(self, f'periodic_{i}', nn.Linear(d_in, width))
            d_in = width + (input_ch_periodic if i in self.skips else 0)
        self.feature1 = nn.Linear(d_in, width)
        self.scale_0 = nn.Linear(width + input_ch_periodic_aux, width)
        self.feature2 = nn.Linear(width, width)
        self.pos_0 = nn.Linear(2 * width, width // 2)
        self.rgb = nn.Linear(width // 2, output_ch)

    def forward(self, x_periodic: torch.Tensor) -> torch.Tensor:
        inp = x_periodic[..., : self.input_ch_periodic]
        aux = x_periodic[..., self.input_ch_periodic:]
        h = inp
        for i in range(self.depth):
            h = _act_linear(getattr(self, f'periodic_{i}'), h, self.activation)
            if i in self.skips:
                h = torch.cat([inp, h], dim=-1)
        feature1 = self.feature1(h)
        h = _act_linear(self.scale_0, torch.cat([feature1, aux], dim=-1),
                        self.activation)
        feature2 = self.feature2(h)
        h = _act_linear(self.pos_0, torch.cat([feature1, feature2], dim=-1),
                        self.activation)
        return self.rgb(h)


class NPPNetTop1(nn.Module):
    """Top-1 fit model (reference: models/networks.py:99-173)."""

    def __init__(self, input_ch_periodic: int, depth: int = 8,
                 width: int = 512, output_ch: int = 3,
                 skips: Tuple[int, ...] = (4,), activation: str = 'snake'):
        super().__init__()
        self.input_ch_periodic = input_ch_periodic
        self.depth, self.skips, self.activation = depth, tuple(skips), activation
        d_in = input_ch_periodic
        for i in range(depth):
            setattr(self, f'periodic_{i}', nn.Linear(d_in, width))
            d_in = width + (input_ch_periodic if i in self.skips else 0)
        self.feature1 = nn.Linear(d_in, width)
        self.pos_0 = nn.Linear(width, width // 2)
        self.rgb = nn.Linear(width // 2, output_ch)

    def forward(self, x_periodic: torch.Tensor) -> torch.Tensor:
        inp = x_periodic[..., : self.input_ch_periodic]
        h = inp
        for i in range(self.depth):
            h = _act_linear(getattr(self, f'periodic_{i}'), h, self.activation)
            if i in self.skips:
                h = torch.cat([inp, h], dim=-1)
        feature1 = self.feature1(h)
        h = _act_linear(self.pos_0, feature1, self.activation)
        return self.rgb(h)


def render_activation(raw: torch.Tensor, normalize_type: int) -> torch.Tensor:
    """Map raw MLP output to RGB (reference: models/helpers.py:55-60)."""
    if normalize_type == 1:
        return torch.sigmoid(raw)
    if normalize_type == 2:
        return torch.tanh(raw)
    raise ValueError('Wrong normalize type')
