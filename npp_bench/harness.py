"""One run of one cell: set-up, the measured window, the traced block, the
check against the plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
BENCHMARK.json names its configuration (whose file BENCHMARK.json gives)
and its traffic (traffic/<name>.json); the traffic's `entry` names the
kind of program, programs/<entry>.py (harness.kind; programs/__init__.py
says what a kind provides: its inputs, build, first block, check, limits,
work and calibration); its limits are limits/<cell>.json; each per-layer
metric is metrics/<name>.py, a `read(ctx)` that returns a number or None
from the trace and the kind's declared work. A new kind of program,
configuration, traffic mix, cell or metric is new files and entries; no
file here changes.

The run (`run_cell`), the same for every kind:
 1. makes the kind's inputs from the seed (on the card) and stages what
    the port reads from disk in the run's own directory under $TMPDIR;
 2. builds the kind's program for the cell and drives its first block
    through the block's own call and feed, read by the kind; this block
    also builds and warms every kernel and shape the window uses, and
    ends the set-up;
 3. runs blocks back to back, with no host sync inside, until `seconds`
    have passed, then synchronises: image_steps_per_s is every
    image-step enqueued in the window over the window's wall, and
    peak_mem_gib the allocator's peak over the window;
 4. with trace, profiles one more block (trace.py) and reads the
    per-layer metrics;
 5. frees the program and runs the kind's check: its plain reference over
    the same inputs, compared with what the first block read.
The fits' kinds are programs/fit_block.py and batched_fit_block.py
(fit.py, program.py, check.py, inputs.py, reference/).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
GIB = float(1 << 30)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'npp_tpu')


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def cell_spec(bench: dict, cell: str, root: str = ROOT,
              bench_dir: str = BENCH) -> SimpleNamespace:
    """The cell's workload entry, its configuration and traffic files, and
    the names of the metrics it reports."""
    work = {w['name']: w for w in bench['workloads']}
    if cell not in work:
        raise KeyError(f'no workload {cell!r} in BENCHMARK.json; known: '
                       f'{sorted(work)}')
    w = work[cell]
    cfg_entry = {c['name']: c for c in bench['configs']}[w['config']]

    def reports(m):
        return 'workloads' not in m or cell in m['workloads']

    return SimpleNamespace(
        workload=w, chips=int(w['chips']),
        config=load_json(os.path.join(root, cfg_entry['file'])),
        traffic=load_json(os.path.join(bench_dir, 'traffic',
                                       f'{w["traffic"]}.json')),
        end_to_end=[m for m in bench['end_to_end'] if reports(m)],
        per_layer=[m for m in bench['per_layer'] if reports(m)])


def reader(name: str, bench_dir: str = BENCH):
    """metrics/<name>.py's read."""
    path = os.path.join(bench_dir, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'npp_bench_metric_{name}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (default: the loaded
    modules), each compared whole: npp_tpu_torch is not npp_tpu."""
    names = sys.modules if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def smi() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'


def host_state() -> dict:
    """This process's CPU seconds and involuntary context switches, the
    CPU it last ran on, and the machine's stolen and busy CPU seconds
    (/proc/stat): read before and after the window, they tell a slow
    host (time taken by other work) from a slow step."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {'cpu_s': ru.ru_utime + ru.ru_stime, 'nivcsw': ru.ru_nivcsw}
    try:
        tick = float(os.sysconf('SC_CLK_TCK'))
        with open('/proc/stat') as f:
            v = [float(x) for x in f.readline().split()[1:9]]
        out.update(busy_s=(sum(v) - v[3] - v[4]) / tick, steal_s=v[7] / tick)
        with open('/proc/self/stat') as f:
            out['on_cpu'] = int(f.read().rsplit(')', 1)[1].split()[36])
    except (OSError, ValueError, IndexError):
        pass
    return out


def log(msg: str) -> None:
    print(f'[npp_bench] {msg}', file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def kind(entry: str, bench_dir: str = BENCH):
    """programs/<entry>.py, the kind of program a traffic file's `entry`
    names (programs/__init__.py: what it provides)."""
    path = os.path.join(bench_dir, 'programs', f'{entry}.py')
    if not os.path.exists(path):
        raise KeyError(f'no kind of program {entry!r}: {path} is missing')
    name = f'npp_bench_program_{entry}'
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def run_dir():
    """The run's own directory (what a kind stages for the port, the
    trace), under $TMPDIR (else the benchmark's .tmp/), removed on exit."""
    tmp_root = os.environ.get('TMPDIR') or os.path.join(BENCH, '.tmp')
    os.makedirs(tmp_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix='npp_bench-', dir=tmp_root)
    try:
        yield work
    finally:
        shutil.rmtree(work, ignore_errors=True)


def first_block(program, config: dict, traffic: dict, inputs, device):
    """(the program of the kind `program` for the cell, what the kind read
    of its first block, driven through the block's own call and feed, and
    the times of both)."""
    t = time.perf_counter()
    fit = program.build(config, traffic, inputs, device)
    sync(device)
    built = time.perf_counter() - t
    rec = program.first_block(fit, config, traffic, device)
    return fit, rec, {'build_s': built,
                      'first_block_s': time.perf_counter() - t - built}


def cell_inputs(config: dict, traffic: dict, seed: int, device):
    """The fit kinds' inputs as (arrays, weights, fit seed):
    fit.py::cell_inputs."""
    from . import fit
    return fit.cell_inputs(config, traffic, seed, device)


def reference_readings(config: dict, arrays, base: int, weights, steps: int,
                       device, control: bool = False,
                       fault: Optional[str] = None) -> list:
    """The fit kinds' reference Readings: fit.py::reference_readings."""
    from . import fit
    return fit.reference_readings(config, arrays, base, weights, steps,
                                  device, control, fault)


def reader_context(summary, rate: Optional[float], step_s: float,
                   config: dict, traffic: dict, images: int, work: dict,
                   device_name: str, bench_dir: str = BENCH
                   ) -> SimpleNamespace:
    """What a per-layer reader reads: the profile's Summary, the window's
    rate and step time, the kind's declared work, the card's peaks, and
    metrics/kernel_groups.json's groups by name."""
    from . import flops
    groups = dict(load_json(os.path.join(bench_dir, 'metrics',
                                         'kernel_groups.json'))['groups'])
    return SimpleNamespace(
        summary=summary, rate=rate, step_s=step_s, config=config,
        traffic=traffic, images=images, work=work,
        peaks=flops.peaks(device_name), group=lambda g: groups[g])


def apply_overrides(config: dict, traffic: dict, overrides: Optional[dict]):
    """(config, traffic) with the tests' small sizes: each key of
    `overrides` ('config', 'image', 'mlp', 'traffic') updates that
    section."""
    traffic = dict(traffic)
    for k, v in (overrides or {}).items():
        if k == 'traffic':
            traffic.update(v)
        else:
            config = dict(config, **{k: dict(config[k], **v)})
    return config, traffic


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             since_start, device: Optional[str] = None,
             overrides: Optional[dict] = None,
             bench_dir: str = BENCH, root: str = ROOT) -> dict:
    """One run; returns {'result': the result line's object, 'numbers',
    'limits', 'diag'}. `since_start()` gives the seconds since the
    process started. `overrides` (tests only): apply_overrides."""
    import torch

    from . import check
    from . import trace as tracing

    t_import = since_start()
    spec = cell_spec(load_benchmark(root), cell, root, bench_dir)
    config, traffic = apply_overrides(spec.config, spec.traffic, overrides)
    program = kind(traffic['entry'], bench_dir)
    limits = program.limits(bench_dir, cell)
    dev = torch.device(device or 'cuda')
    diag: Dict[str, object] = {'cell': cell, 'seed': seed,
                               'imports_s': t_import,
                               'cpus': len(os.sched_getaffinity(0))}
    if dev.type == 'cuda':
        torch.cuda.init()
        torch.zeros(1, device=dev)
        diag['card'] = smi()
    diag['cuda_init_s'] = since_start() - t_import

    t = time.perf_counter()
    inputs = program.make_inputs(config, traffic, seed, dev)
    with run_dir() as work, program.staged(inputs, work):
        sync(dev)
        diag['inputs_s'] = time.perf_counter() - t
        fit, rec, times = first_block(program, config, traffic, inputs, dev)
        diag.update(times, table=fit.table)
        setup_s = since_start()

        # ---- the window
        host_before = host_state()
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        steps, last = 0, []
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            last.append(fit.run_block(fit.state, fit.feed)['loss'])
            steps += fit.block
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        sync(dev)
        window = time.perf_counter() - t0
        host_after = host_state()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' \
            else 0
        image_steps = steps * fit.images
        rate = image_steps / window
        failed = sum(fit.block * fit.images for x in last
                     if not bool(torch.isfinite(x)))
        diag.update(window_s=window, window_steps=steps,
                    window_blocks=len(last), setup_s=setup_s,
                    block_s=[b - a for a, b in zip(marks, marks[1:])],
                    host={k: host_after[k] - host_before[k]
                          if k != 'on_cpu' else [host_before[k], host_after[k]]
                          for k in host_after if k in host_before})
        log(f'window: {steps} steps of {fit.images} image(s) in '
            f'{window:.3f} s; set-up {setup_s:.3f} s')

        # ---- the traced block
        summary = None
        if trace:
            t = time.perf_counter()
            summary = tracing.profile_block(
                fit.run_block, fit.state, fit.feed, fit.block,
                os.path.join(work, 'trace.json'))
            diag['trace_s'] = time.perf_counter() - t
        images = fit.images
        del fit, last

    # ---- the check, with the program freed
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, check_diag = program.check(config, traffic, inputs, rec, dev)
    correct = check.verdict(numbers, limits)
    diag.update(check_diag, reference_s=time.perf_counter() - t)

    # ---- the result
    names = {m['name'] for m in spec.end_to_end}
    units = {m['name']: m['unit'] for m in spec.end_to_end + spec.per_layer}
    values = {'image_steps_per_s': rate, 'peak_mem_gib': peak / GIB,
              'setup_s': setup_s}
    metrics = {}
    if not trace:
        metrics = {n: {'value': values[n], 'unit': units[n]}
                   for n in ('image_steps_per_s', 'peak_mem_gib', 'setup_s')
                   if n in names}
    else:
        ctx = reader_context(
            summary, rate, window / steps, config, traffic, images,
            program.work(config, traffic),
            torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
            bench_dir)
        for m in spec.per_layer:
            v = reader(m['name'], bench_dir)(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': units[m['name']]}
    result = {
        'correct': bool(correct), 'attempted': image_steps,
        'failed': failed, 'metrics': metrics,
        'device': {'platform': 'gpu' if dev.type == 'cuda' else dev.type,
                   'kind': torch.cuda.get_device_name(dev)
                   if dev.type == 'cuda' else 'cpu',
                   'count': spec.chips, 'memory_peak_bytes': int(peak)}}
    if summary is not None:
        result['device'].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result['breakdown'] = {'device_ops': summary.device_ops,
                               'idle_gaps': summary.idle_gaps}
    result['checked'] = {k: {'value': numbers[k], 'limit': limits[k]}
                         for k in limits}
    diag['numbers'] = numbers
    return {'result': result, 'numbers': numbers, 'limits': limits,
            'diag': diag}
