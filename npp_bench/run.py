"""The benchmark of the PyTorch port (`npp_tpu_torch`) on CUDA cards.

    python3 npp_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cells are BENCHMARK.json's workloads;
harness.py says what one run does. The last line of standard output is
the result, one JSON object; the compared numbers and their limits are
the last lines of standard error. Without a CUDA card, or with fewer
cards than the cell asks for, or with JAX loaded, it exits non-zero and
prints no result. The kernels' builds and Triton's cache live under
npp_tpu_torch/build/ in the checkout; weights and traces go under
$TMPDIR and are deleted at the end of the run.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_age() -> float:
    """Seconds since this process started (Linux's /proc), else 0."""
    try:
        with open('/proc/self/stat') as f:
            start = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf('SC_CLK_TCK'), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0, T0 = _process_age(), time.monotonic()


def since_start() -> float:
    return AGE0 + time.monotonic() - T0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = os.path.join(ROOT, 'npp_tpu_torch', 'build')
    # a checkout's first run builds the kernels: its set-up is told apart
    first_in_checkout = not os.path.isdir(build)
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(build, 'nv_compute_cache')
    sys.path.insert(0, ROOT)
    import torch
    from npp_bench import check, harness

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print('npp_bench: no CUDA card', file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec.chips:
        print(f'npp_bench: {args.workload} needs {spec.chips} cards, '
              f'{torch.cuda.device_count()} found', file=sys.stderr)
        return 3
    # the step's host work is Python and small tensors: one thread keeps
    # idle OpenMP workers from spinning against it
    torch.set_num_threads(1)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), since_start)
    found = harness.forbidden_modules()
    if found:
        print(f'npp_bench: loaded in this process: {found}', file=sys.stderr)
        return 4
    out['diag']['first_in_checkout'] = first_in_checkout
    harness.log('diagnostics ' + json.dumps(out['diag'], default=str))
    for line in check.lines(out['numbers'], out['limits']):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out['result']), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
