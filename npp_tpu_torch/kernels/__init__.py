"""The port's hand-written kernels, each beside its plain PyTorch version.

Every wrapper adds one to its entry in its module's LAUNCHES where it
launches its kernel, and nowhere else, so a run can show that it went
through the kernels. An entry names the kernel, or the kernel and the shape
it ran at ('robust_rho_bwd[153600x64]', 'cx_chain_fwd[6x1600x1600x256]').
"""
from typing import Dict

from . import cx_chain, periodic_embed, robust_rho, snake

_MODULES = (periodic_embed, snake, cx_chain, robust_rho)


def launch_counts() -> Dict[str, int]:
    """Every entry's launch count, and for entries by shape also their sum
    under the kernel's name."""
    counts: Dict[str, int] = {}
    for mod in _MODULES:
        for k, v in mod.LAUNCHES.items():
            counts[k] = v
            name = k.split('[')[0]
            if name != k:
                counts[name] = counts.get(name, 0) + v
    return counts


def reset_launches() -> None:
    for mod in _MODULES:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
