"""Observability: spans and a host-sync counter, profiler traces, NaN
debugging, phase timers, metric logs.

A port of `npp_tpu/utils/debug.py`. Everything is opt-in:

 - span(name): the program's phases (the fit step's draw, copies, embed,
   MLP, losses, backward and Adam; the block and its table; the render;
   the search's phases), recorded only while a torch.profiler records.
   Each lands in the profiler's trace as a `user_annotation` on the
   kernels' clock, and in RECORD (name, start, end, parent, step, syncs).
   While the outermost span is open the card's synchronising operations
   are counted against the innermost open span;
 - enable_nan_debug(): torch.autograd's anomaly detection (the reference's
   globally enabled detector, reference: models/networks.py:2, behind a
   flag here; JAX's counterpart is jax_debug_nans);
 - trace(log_dir): a torch.profiler context that writes a Chrome trace
   (log_dir/trace.json, CPU and, where there is a card, CUDA activity)
   and the spans it recorded (log_dir/spans.json);
 - PhaseTimer: wall-clock per phase (detection / ranking / fit / eval),
   each phase a span that ends with the card's work;
 - MetricLogger: JSONL metric stream per run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# what PyTorch warns with on a synchronising CUDA operation under
# torch.cuda.set_sync_debug_mode('warn')
SYNC_WARNING = 'called a synchronizing CUDA operation'
STEP = 'npp.step'


@dataclasses.dataclass
class Span:
    """One recorded span: host perf_counter seconds, the index of its
    parent in the record (-1 at the top), the fit step it belongs to (the
    enclosing npp.step's state.step, None outside a step) and the syncs
    counted while it was the innermost open span."""

    name: str
    start: float
    end: float = float('nan')
    parent: int = -1
    step: Optional[int] = None
    syncs: int = 0


class SpanRecord:
    """The spans of the last run under a profiler. Cleared when spans start
    under a profiler after any ran without one, kept until then."""

    def __init__(self):
        self.spans: List[Span] = []
        self.open: List[int] = []
        self.stale = False

    def clear(self) -> None:
        self.spans, self.open, self.stale = [], [], False

    @property
    def steps(self) -> int:
        return sum(s.name == STEP for s in self.spans)

    @property
    def syncs(self) -> int:
        return sum(s.syncs for s in self.spans)

    def count_sync(self) -> None:
        if self.open:
            self.spans[self.open[-1]].syncs += 1

    def to_json(self) -> dict:
        return {'steps': self.steps, 'syncs': self.syncs,
                'spans': [dataclasses.asdict(s) for s in self.spans]}


RECORD = SpanRecord()
_OFF = contextlib.nullcontext()


def _cuda_ready() -> bool:
    """A card is in use (CUDA is initialised): only then can work sync."""
    return torch.cuda.is_initialized()


class _SyncCounter:
    """While open: the card's sync debug mode at 'warn' and each of its
    warnings counted on `record`, not shown; every other warning goes
    through as before."""

    def __init__(self, record: SpanRecord):
        self.record = record
        self.mode = None
        self.catch = warnings.catch_warnings()

    def __enter__(self):
        self.catch.__enter__()
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                self.record.count_sync()
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings('always', message='.*' + SYNC_WARNING)
        warnings.showwarning = show
        if _cuda_ready():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode('warn')
        return self

    def __exit__(self, *exc):
        if self.mode is not None:
            torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(*exc)
        return False


class _RecordedSpan:
    __slots__ = ('name', 'step', 'index', 'function', 'counter')

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step = name, step

    def __enter__(self):
        rec = RECORD
        if rec.stale and not rec.open:
            rec.clear()
        parent = rec.open[-1] if rec.open else -1
        step = self.step
        if step is None and parent >= 0:
            step = rec.spans[parent].step
        self.counter = _SyncCounter(rec).__enter__() if parent < 0 else None
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        self.index = len(rec.spans)
        rec.spans.append(Span(self.name, time.perf_counter(), parent=parent,
                              step=step))
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        RECORD.spans[self.index].end = time.perf_counter()
        RECORD.open.pop()
        self.function.__exit__(*exc)
        if self.counter is not None:
            self.counter.__exit__(*exc)
        return False


def span(name: str, step: Optional[int] = None):
    """A context over one phase of the program. With no profiler recording
    it is a shared no-op (no record_function, nothing recorded); under one
    it opens record_function(name) and records the span in RECORD. step:
    the fit step's id (npp.step passes state.step; inner spans take their
    parent's)."""
    if not _autograd_profiler._is_profiler_enabled:
        RECORD.stale = True
        return _OFF
    return _RecordedSpan(name, step)


def kernel_times(prof) -> Dict[str, List[float]]:
    """{name: [device ms, calls]} of the card's operations in a finished
    torch.profiler run. A record_function range (a span, Adam's step) has
    a device twin that spans its kernels; it is left out, not a kernel."""
    out: Dict[str, List[float]] = {}
    for ev in prof.key_averages():
        if getattr(ev, 'is_user_annotation', False):
            continue
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            k = out.setdefault(ev.key, [0.0, 0])
            k[0] += us / 1e3
            k[1] += ev.count
    return out


def enable_nan_debug(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block; writes log_dir/trace.json, which
    chrome://tracing and Perfetto read, and the program's spans in it with
    their sync counts, log_dir/spans.json (SpanRecord.to_json)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
    with open(os.path.join(log_dir, 'spans.json'), 'w') as f:
        json.dump(RECORD.to_json(), f)


class PhaseTimer:
    """Wall seconds per phase. Each phase is a span of its name and ends
    with a synchronisation of the card, so its wall holds the phase's
    device work."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if _cuda_ready():
                    torch.cuda.synchronize()
        finally:
            self.phases[name] = (self.phases.get(name, 0.0) +
                                 time.perf_counter() - t0)

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
