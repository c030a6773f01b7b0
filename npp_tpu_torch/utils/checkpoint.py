"""Checkpoint / resume for per-image fits, a port of
`npp_tpu/utils/checkpoint.py` with torch.save in place of orbax.

The reference never saves a fit (SURVEY.md §5; reference:
models/helpers.py:166-175). Here a file holds everything a fit needs to go
on as if it had not stopped: the FitParams' state_dict (the MLP, the
adaptive-loss latents, the warp field), Adam's state, the step count and
the batch generator's state. Files are `<dir>/step_<i>.pt` and load with
torch.load(weights_only=True); npp_tpu does not read them.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def save_fit_state(path: str, state, gen: torch.Generator) -> None:
    """Write `state` (models/trainer.py::FitState) and `gen`'s state."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.tmp{os.getpid()}'
    torch.save({'params': state.params.state_dict(),
                'optimizer': state.optimizer.state_dict(),
                'step': int(state.step), 'gen': gen.get_state()}, tmp)
    os.replace(tmp, path)


def restore_fit_state(path: str, state, gen: torch.Generator) -> None:
    """Load a file of save_fit_state into `state` and `gen`, in place."""
    dev = next(state.params.parameters()).device
    blob = torch.load(path, map_location=dev, weights_only=True)
    state.params.load_state_dict(blob['params'])
    state.optimizer.load_state_dict(blob['optimizer'])
    state.step = int(blob['step'])
    gen.set_state(blob['gen'].cpu())


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if d.startswith('step_') and d.endswith('.pt')]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d[len('step_'):-len('.pt')]))
    return os.path.join(ckpt_dir, best)
