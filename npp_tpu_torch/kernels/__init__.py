"""The port's hand-written kernels, each beside its plain PyTorch version.

Every wrapper adds one to its entry in its module's LAUNCHES where it
launches its kernel, and nowhere else, so a run can show that it went
through the kernels.
"""
from typing import Dict

from . import periodic_embed, robust_rho, snake

_MODULES = (periodic_embed, snake, robust_rho)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count, by kernel name."""
    return {k: v for mod in _MODULES for k, v in mod.LAUNCHES.items()}


def reset_launches() -> None:
    for mod in _MODULES:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
