"""The readings that a cell's limits are set from, on the card at the
cell's own size (the benchmark's runs never run this):

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
   gradient dx, off by K3_FAULT (what a kernel that returns that
   reads).
A step that returns its state unchanged reads 1 in change_gap by
definition and needs no run.

    python3 npp_bench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--out chiprun_out/calibrate-<cell>.json]

One process reads every seed (each builds its own fit and weights). Each
line of standard output is one seed's readings as JSON.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K3_FAULT = 0.01


def raw(readings) -> dict:
    """A Readings as JSON (its step-1 output and features left out)."""
    return {k: v for k, v in vars(readings).items()
            if k not in ('pred', 'cx_feats')}


def seed_row(cell: str, config: dict, traffic: dict, seed: int,
             dev) -> dict:
    """One seed's readings: the program's first block, the reference, the
    control and the planted faults, each compared with the reference."""
    import torch

    from npp_bench import check, harness

    arrays, weights, base = harness.cell_inputs(config, traffic, seed,
                                                dev)
    with harness.weights_dir(weights):
        fit, rec, _ = harness.first_block(config, traffic, arrays, base,
                                          dev)
        del fit
    gc.collect()
    torch.cuda.empty_cache()
    steps = rec.followed
    ref = harness.reference_readings(config, arrays, base, weights,
                                     steps, dev)
    prog = check.program_values(rec)
    cx = rec.cx
    cxr = harness.cx_reference(cx, dev)
    row = {'cell': cell, 'seed': seed, 'sources': rec.sources,
           'followed': steps, 'program': dict(
               check.compare(prog, ref),
               **check.cx_numbers(cx, cxr, ref)),
           'program_worst': check.worst_leaves(prog, ref),
           'raw': {'reference': [raw(r) for r in ref],
                   'program': dict(prog, pred=None)}}
    for name, kw in (('control_bf16', {'control': True}),
                     ('fault_half_batch', {'fault': 'half_batch'}),
                     ('fault_frozen', {'fault': 'frozen'})):
        alt = harness.reference_readings(config, arrays, base, weights,
                                         steps, dev, **kw)
        vals = check.reading_values(alt)
        row[name] = check.compare(vals, ref)
        row[name + '_worst'] = check.worst_leaves(vals, ref)
        row['raw'][name] = [raw(r) for r in alt]
        if name == 'control_bf16' and cx is not None:
            ctl = harness.cx_reference(cx, dev, control=True)
            feats = [r.cx_feats for r in alt]
            side = {'xn': torch.cat([f[0] for f in feats]),
                    'yn': torch.cat([f[1] for f in feats]),
                    'z': ctl['z'], 'dx': ctl['dx']}
            row[name].update(check.cx_numbers(side, cxr, ref))
    if cx is not None:
        for name, key in (('fault_k3_output', 'z'),
                          ('fault_k3_gradient', 'dx')):
            side = dict(cx, **{key: cx[key] * (1.0 + K3_FAULT)})
            row[name] = check.cx_numbers(side, cxr, ref)
    del weights, ref
    gc.collect()
    torch.cuda.empty_cache()
    return row


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
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = seed_row(args.workload, config, traffic, seed, dev)
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
