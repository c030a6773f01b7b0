"""Pixel-space losses (reference: models/mse_calculator.py:13-29), ports of
`npp_tpu/losses/pixel.py`."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .robust import AdaptiveLossParams, general_lossfun, weighted_nll_rows


def img2mse(pred: torch.Tensor, gt: torch.Tensor, loss_type: str,
            adaptive: Optional[AdaptiveLossParams] = None,
            mask: Optional[torch.Tensor] = None,
            scale_lo: float = 1e-5) -> torch.Tensor:
    """Masked robust pixel loss (reference: mse_calculator.py:13-27).

    mask weights known pixels 1.0 and unknown 0.3 via
    diff = diff*mask + (1-mask)*diff*0.3. The adaptive loss is the mean of
    the element-wise NLL; its rho goes through K4 with unit weights."""
    diff = pred - gt
    if mask is not None:
        diff = diff * mask + (1.0 - mask) * diff * 0.3

    if loss_type == 'robust_loss':
        loss = general_lossfun(diff, torch.tensor(2.0), torch.tensor(0.1))
    elif loss_type == 'l2':
        loss = torch.square(diff)
    elif loss_type == 'robust_loss_adaptive':
        if adaptive is None:
            raise ValueError('robust_loss_adaptive requires AdaptiveLossParams')
        x = diff.reshape(-1, diff.shape[-1])
        ones = torch.ones(x.shape[-1], device=x.device)
        return torch.mean(weighted_nll_rows(x, adaptive, ones,
                                            scale_lo=scale_lo)) / x.shape[-1]
    else:
        raise ValueError(f'Unknown loss_type: {loss_type}')
    return torch.mean(loss)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    """reference: mse_calculator.py:29."""
    return -10.0 * torch.log(mse) / float(np.log(10.0))
