"""NPP-Net models in PyTorch (reference: models/networks.py:8-263), ports
of `npp_tpu/nn/mlp.py::NPPNet`, `NPPNetTop1` and `NPPNetLight`.

Layers are `nn.Linear` with its default init, U(+-1/sqrt(fan_in)) for weight
and bias, the same distribution as the JAX package's TorchLinear
(npp_tpu/nn/mlp.py:27-42). Parameter names follow the flax names
(`periodic_0`, ..., `feature1`, `scale_0`, `feature2`, `pos_0`, `rgb`) so
utils/convert.py maps one onto the other.

With the snake activation each activated layer is a bias-free matmul
followed by K2 (kernels/snake.py: bias + snake, a Triton kernel on CUDA).

`NPPNetLight` is the search's model, stacked: it holds the weights of
every candidate, (n_cand, in, out) and (n_cand, out) in the flax layout,
and runs them at once with `torch.bmm`; K2 takes the batch with a bias per
candidate.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.snake import bias_snake
from .activations import get_activation


def _act_linear(layer: nn.Module, x: torch.Tensor, activation: str
                ) -> torch.Tensor:
    """act(layer(x)); snake goes through K2 on the bias-free product. A
    StackedLinear layer (the multi-image fit's stacked models,
    parallel/batch.py) takes x (B, M, in)."""
    if isinstance(layer, StackedLinear):
        return layer(x, activation)
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


def light_channel_split(total_periodic: int, n_scales: int, n_offsets: int,
                        n_angle_offsets: int
                        ) -> Tuple[Sequence[int], Sequence[int]]:
    """Index split of periodic channels into trunk vs. scale-aux groups
    (reference: models/networks.py:184-190)."""
    scale_dim = (n_scales - 1) * 4 * n_offsets * n_angle_offsets
    base = 2 * n_offsets * n_angle_offsets
    scale_inds = list(range(base, base + scale_dim // 2)) + \
        list(range(total_periodic - scale_dim // 2, total_periodic))
    period_inds = [i for i in range(total_periodic) if i not in scale_inds]
    return period_inds, scale_inds


class StackedLinear(nn.Module):
    """n_cand dense layers applied at once: x (n_cand, M, in) ->
    (n_cand, M, out), with `kernel` (n_cand, in, out) and `bias`
    (n_cand, out) as flax keeps them. Every candidate starts from the same
    draw, U(+-1/sqrt(in)) for kernel and bias (nn.Linear's default)."""

    def __init__(self, n_cand: int, d_in: int, d_out: int,
                 gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        k = (torch.rand((d_in, d_out), generator=gen) * 2 - 1) * bound
        b = (torch.rand((d_out,), generator=gen) * 2 - 1) * bound
        self.kernel = nn.Parameter(k.expand(n_cand, -1, -1).clone())
        self.bias = nn.Parameter(b.expand(n_cand, -1).clone())

    @classmethod
    def from_linears(cls, layers: Sequence[nn.Linear]) -> 'StackedLinear':
        """The layers' weights stacked, kernel (n, in, out) = weight^T."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.kernel = nn.Parameter(torch.stack(
            [lin.weight.detach().t() for lin in layers]).contiguous())
        self.bias = nn.Parameter(torch.stack(
            [lin.bias.detach() for lin in layers]).contiguous())
        return self

    def forward(self, x: torch.Tensor,
                activation: Optional[str] = None) -> torch.Tensor:
        h = torch.bmm(x, self.kernel)
        if activation == 'snake':
            return bias_snake(h, self.bias)
        h = h + self.bias[:, None, :]
        return h if activation is None else get_activation(activation)(h)


class NPPNetLight(nn.Module):
    """Search-mode model (reference: models/networks.py:176-263), stacked
    over n_cand candidates. forward(x_pos, x_periodic): x_pos (M, P) is the
    Fourier encoding of the raw coords, shared by the candidates;
    x_periodic (n_cand, M, C) each candidate's periodic warp (not
    re-encoded). Returns (n_cand, M, output_ch). The layers' draws come
    from `gen` in the order periodic_0.., feature1, scale_0, feature2,
    pos_0, rgb (kernel, then bias)."""

    def __init__(self, n_cand: int, input_ch_periodic_all: int,
                 input_ch_pos: int, gen: torch.Generator, n_scales: int = 1,
                 n_offsets: int = 5, n_angle_offsets: int = 1, depth: int = 4,
                 width: int = 256, output_ch: int = 3,
                 skips: Tuple[int, ...] = (4,), activation: str = 'snake'):
        super().__init__()
        self.n_cand, self.depth, self.skips = n_cand, depth, tuple(skips)
        self.activation, self.n_scales = activation, n_scales
        period_inds, scale_inds = light_channel_split(
            input_ch_periodic_all, n_scales, n_offsets, n_angle_offsets)
        self.period_inds = None \
            if period_inds == list(range(input_ch_periodic_all)) \
            else period_inds
        self.scale_inds = scale_inds
        n_in = len(period_inds)
        d_in = n_in
        for i in range(depth):
            setattr(self, f'periodic_{i}', StackedLinear(n_cand, d_in, width,
                                                         gen))
            d_in = width + (n_in if i in self.skips else 0)
        self.feature1 = StackedLinear(n_cand, d_in, width, gen)
        d_pos = width + input_ch_pos
        if n_scales > 1:
            self.scale_0 = StackedLinear(n_cand, width + len(scale_inds),
                                         width, gen)
            self.feature2 = StackedLinear(n_cand, width, width, gen)
            d_pos += width
        self.pos_0 = StackedLinear(n_cand, d_pos, width // 2, gen)
        self.rgb = StackedLinear(n_cand, width // 2, output_ch, gen)

    def forward(self, x_pos: torch.Tensor,
                x_periodic: torch.Tensor) -> torch.Tensor:
        act = self.activation
        inp = x_periodic if self.period_inds is None \
            else x_periodic[..., self.period_inds]
        h = inp
        for i in range(self.depth):
            h = getattr(self, f'periodic_{i}')(h, act)
            if i in self.skips:
                h = torch.cat([inp, h], dim=-1)
        feature1 = self.feature1(h)
        pos = x_pos.expand(self.n_cand, -1, -1)
        if self.n_scales > 1:
            aux = x_periodic[..., self.scale_inds]
            h = self.scale_0(torch.cat([feature1, aux], dim=-1), act)
            h = torch.cat([feature1, self.feature2(h), pos], dim=-1)
        else:
            h = torch.cat([feature1, pos], dim=-1)
        return self.rgb(self.pos_0(h, act))


def render_activation(raw: torch.Tensor, normalize_type: int) -> torch.Tensor:
    """Map raw MLP output to RGB (reference: models/helpers.py:55-60)."""
    if normalize_type == 1:
        return torch.sigmoid(raw)
    if normalize_type == 2:
        return torch.tanh(raw)
    raise ValueError('Wrong normalize type')
