"""Device resolution for the port's entry points, and the matmul precision
scope of the fit.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: a silent CPU fallback would
report CPU results as if they came from the card.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> this process's card: 'cuda:<current device>', which is the
    rank's own card once a process group's rank has set it
    (parallel/multihost.py). Raises RuntimeError if CUDA is asked for and
    absent."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "npp_tpu_torch: CUDA was requested (the default) but no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    if device is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


# matmul_precision names as jax.default_matmul_precision takes them, and
# whether each lets the card's f32 matmuls and convolutions run in TF32:
# JAX maps the first six to Precision.DEFAULT or HIGH, which on a card with
# TF32 tensor cores is TF32, and the last two to HIGHEST, full f32.
TF32_BY_PRECISION = {
    'bfloat16': True, 'default': True, 'fastest': True, 'tensorfloat32': True,
    'bfloat16_3x': True, 'high': True, 'float32': False, 'highest': False}


def allows_tf32(name: str) -> bool:
    """Whether matmul_precision `name` lets f32 run in TF32; raises
    ValueError for a name JAX does not take."""
    try:
        return TF32_BY_PRECISION[name]
    except KeyError:
        raise ValueError(
            f'matmul_precision {name!r} is not one of '
            f'{sorted(TF32_BY_PRECISION)}') from None


@contextlib.contextmanager
def matmul_precision(name: str) -> Iterator[None]:
    """Within the block, f32 matmuls (cuBLAS) and convolutions (cuDNN) on the
    card run in TF32 or in full f32 as `name` says (allows_tf32); the
    previous settings come back on exit. PyTorch reads the flags when each
    kernel launches, so a backward must run inside the block too. CPU
    results do not change."""
    tf32 = allows_tf32(name)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
