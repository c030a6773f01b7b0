"""The traced run's profile: one block of steps under `torch.profiler`
(CPU and CUDA activities), after one block with the profiler on and its
events discarded (CUPTI's start-up), read from the exported Chrome trace.

What the per-layer readers get (`Summary`): every device operation's
name, start and length (kernels, copies and fills); the traced window
(the block between two synchronisations, marked 'npp_bench.window');
the steps it ran; the union of the device's busy intervals; the idle
gaps labelled with what the host was doing; and the device operations
that took the most time.
"""
from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = 'npp_bench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'python_function')


@dataclass
class Summary:
    steps: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]     # (name, start us, dur us)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_seconds(self, patterns) -> float:
        """Seconds of the kernels whose name holds one of `patterns`."""
        pats = tuple(p.lower() for p in patterns)
        return sum(d for n, _, d in self.kernels
                   if any(p in n.lower() for p in pats)) / 1e6

    def launches(self) -> int:
        return len(self.kernels)


def profile_block(run_block, state, feed, steps: int, path: str) -> Summary:
    """Profile one block (after a discarded one) and summarise it; the
    trace file at `path` is deleted once read."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    def export(prof):
        prof.export_chrome_trace(path)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=export) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            with record_function(WINDOW):
                run_block(state, feed)
                torch.cuda.synchronize()
            prof.step()
    try:
        return summarise(path, steps)
    finally:
        os.remove(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarise(path: str, steps: int, top: int = 10) -> Summary:
    with open(path) as f:
        events = json.load(f)['traceEvents']
    win = [e for e in events if e.get('name') == WINDOW and
           e.get('cat') in ('user_annotation', 'cpu_op')]
    if not win:
        raise RuntimeError('the trace holds no window annotation')
    w = max(win, key=lambda e: e['dur'])
    t0, t1 = float(w['ts']), float(w['ts']) + float(w['dur'])
    inside = [e for e in events if e.get('cat') in DEVICE_CATS and
              t0 <= float(e['ts']) <= t1]
    dev = [(e['name'], float(e['ts']), float(e.get('dur', 0.0)))
           for e in inside]
    kernels = [d for d, e in zip(dev, inside) if e['cat'] == 'kernel']
    busy = _union([(max(s, t0), min(s + d, t1)) for _, s, d in dev])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = {}
    for n, _, d in dev:
        by_name[n] = by_name.get(n, 0.0) + d / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # the idle gaps inside the window, each labelled with the innermost
    # host operation of the window's thread that covers its start
    tid = w.get('tid')
    host = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
                   e['name']) for e in events
                  if e.get('cat') in HOST_CATS and e.get('tid') == tid
                  and e.get('name') != WINDOW)
    starts = [h[0] for h in host]
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = 'host: no operation'
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] > a:
                label = host[j][2]
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return Summary(steps=steps, window_s=(t1 - t0) / 1e6,
                   busy_s=busy_us / 1e6, kernels=kernels,
                   device_ops=[[n[:160], s] for n, s in device_ops],
                   idle_gaps=[[n[:160], s] for n, s in idle])
