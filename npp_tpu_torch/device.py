"""Device resolution for the port's entry points, the matmul precision
scope of the fit, and the cards' published peaks that bounds and MFU are
taken against.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit CPU request they raise: a silent CPU fallback would
report CPU results as if they came from the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
from typing import Dict, Iterator, Optional, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """A card's published peaks: memory bytes/s and dense FLOP/s."""

    hbm_bytes_per_s: float
    tf32: float           # TF32 on the tensor cores
    bf16: float           # bf16 on the tensor cores
    f32: float            # float32 outside the tensor cores


# keyed by torch.cuda.get_device_name; NVIDIA's data sheet, SXM part,
# dense rates at the full 700 W power limit
CARD_PEAKS: Dict[str, CardPeaks] = {
    'NVIDIA H100 80GB HBM3': CardPeaks(hbm_bytes_per_s=3.35e12, tf32=495e12,
                                       bf16=989e12, f32=67e12),
}


def card_peaks(name: str) -> CardPeaks:
    """The peaks of the card named `name`; raises KeyError for a card the
    table does not hold (a bound against another card's peaks would be
    wrong, so there is no default)."""
    try:
        return CARD_PEAKS[name]
    except KeyError:
        raise KeyError(f'no published peaks for card {name!r}; known: '
                       f'{sorted(CARD_PEAKS)}') from None


def matmul_peak(name: str, precision: str) -> Tuple[float, str]:
    """(FLOP/s, its label) of the dense matmul peak that matmul_precision
    `precision` runs f32 products at on card `name`: TF32 where
    allows_tf32, else float32 outside the tensor cores."""
    peaks = card_peaks(name)
    return (peaks.tf32, 'tf32') if allows_tf32(precision) \
        else (peaks.f32, 'f32')


def smi_line() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (a card
    may be set below its peaks' 700 W); raises if nvidia-smi fails."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
