"""Observability: profiler traces, NaN debugging, phase timers, metric logs.

A port of `npp_tpu/utils/debug.py`. Everything is opt-in:

 - enable_nan_debug(): torch.autograd's anomaly detection (the reference's
   globally enabled detector, reference: models/networks.py:2, behind a
   flag here; JAX's counterpart is jax_debug_nans);
 - trace(log_dir): a torch.profiler context that writes a Chrome trace
   (log_dir/trace.json, CPU and, where there is a card, CUDA activity);
 - PhaseTimer: wall-clock per phase (detection / ranking / fit / eval);
 - MetricLogger: JSONL metric stream per run.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; writes log_dir/trace.json, which
    chrome://tracing and Perfetto read."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class PhaseTimer:
    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.time() - t0

    def summary(self) -> str:
        total = sum(self.phases.values())
        parts = [f'{k}={v:.1f}s' for k, v in self.phases.items()]
        return f'phases: {" ".join(parts)} total={total:.1f}s'


class MetricLogger:
    """Append-only JSONL metric stream (one object per event)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            self._f = open(path, 'a')
        else:
            self._f = None

    def log(self, **event):
        event.setdefault('t', time.time())
        if self._f:
            self._f.write(json.dumps(event) + '\n')
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
