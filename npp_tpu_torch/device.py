"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: a silent CPU fallback would
report CPU results as if they came from the card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> 'cuda'. Raises RuntimeError if CUDA is asked for and absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "npp_tpu_torch: CUDA was requested (the default) but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def set_reference_precision() -> None:
    """Full-f32 matmuls and convolutions on the card: the port runs the fit
    in f32 (TF32 keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
