"""The port's hand-written kernels, each beside its plain PyTorch version.

Every wrapper adds one to its entry in its module's LAUNCHES where it
launches its kernel, and nowhere else, so a run can show that it went
through the kernels. An entry names the kernel, or the kernel and the shape
it ran at ('robust_rho_bwd[153600x64]', 'cx_chain_fwd[6x1600x1600x256]').
A launch captured into a CUDA graph runs at each replay, not at the
capture: `captured_launches` and `add_launches` count it so.
"""
import collections
from typing import Callable, Dict, List

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


def captured_launches(capture: Callable[[], None]
                      ) -> List[collections.Counter]:
    """Run `capture`, which records launches into a CUDA graph and runs
    none, and take the launches the wrappers counted in it off the counts
    again. Returns them by module, for add_launches at each replay."""
    before = [collections.Counter(mod.LAUNCHES) for mod in _MODULES]
    capture()
    delta = [collections.Counter(mod.LAUNCHES) - b
             for mod, b in zip(_MODULES, before)]
    for mod, d in zip(_MODULES, delta):
        mod.LAUNCHES.subtract(d)
    return delta


def add_launches(delta: List[collections.Counter]) -> None:
    """Count the launches of one replay of a captured graph."""
    for mod, d in zip(_MODULES, delta):
        mod.LAUNCHES.update(d)
