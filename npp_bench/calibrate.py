"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's runs never run this): the kind's
`calibrate` (programs/__init__.py), one seed at a time. For the fits
(fit.py::calibrate):

 - the program: its first block read as a run reads it, against the
   reference (the lower readings: the largest over a dozen seeds or
   more);
 - the control: the reference computed in bf16 (autocast), the precision
   below the configuration's TF32, put in the program's place;
 - a planted fault: the reference with half of its pixel rows and patches
   left out, the means taken over the rest, in the program's place;
 - K3's stage (check.py's cx_* numbers): the control is the chain under
   bf16 autocast on the program's own xn, yn and dz; K3's answer altered
   where it is produced is the program's own step-1 output z, or its
   gradient dx, off by 1% (what a kernel that returns that reads).
A step that returns its state unchanged reads 1 in change_gap by
definition and needs no run.

    python3 npp_bench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--out chiprun_out/calibrate-<cell>.json]

One process reads every seed (each builds its own program and inputs).
Each line of standard output is one seed's readings as JSON.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    build = os.path.join(ROOT, 'npp_tpu_torch', 'build')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(build, 'nv_compute_cache')
    sys.path.insert(0, ROOT)
    import torch
    from npp_bench import harness

    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 3
    dev = torch.device('cuda')
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    config, traffic = spec.config, spec.traffic
    kind = harness.kind(traffic['entry'])
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = kind.calibrate(args.workload, config, traffic, seed, dev)
        row['seconds'] = time.perf_counter() - t0
        print(json.dumps({k: v for k, v in row.items() if k != 'raw'}),
              flush=True)
        out.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
