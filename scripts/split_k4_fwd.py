"""Where K4's forward kernel (csrc/robust_rho_fwd.cu) spends its time, and
what cheaper forms of its log1p and expm1 would give, on one CUDA card.

    python3 scripts/split_k4_fwd.py [--out FILE]

Builds variants of the source, each with another body of rho_w (one
element's w rho; the kernel's own calls the precise log1pf and expm1f):
only the loads and stores; no expm1f; no log1pf; log1p(q) as logf(1 + q)
with a correction term;
expm1(t) as a degree-7 series below |t| = 0.35 and expf(t) - 1 above; both
of the last two together; and both with log1p(q) as a degree-8 series
below q = 1/8. Times each beside the kernel and
`torch.sum` of x's rows (the same bytes read and written: a floor for a
pass over x), at the LPIPS layer-1
shape with alpha across (0.001, 1.999), there with the adaptive latents'
init (alpha = 1, s = 1: small q and t, as in the LPIPS layers of a fit),
and as the grouped launch of the five LPIPS layers. Device times by CUDA-graph replay, as chip_smoke.py
takes them. Each variant's output is held to float64, relative to the
largest float64 magnitude (the forward's bar is 1e-6); the timing-only
variants compute another function and say so. Prints one JSON line;
writes it to --out too.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD = '__device__ __forceinline__ float rho_w(float x, float4 k) {\n'
# rho_w's body in each variant: k = {1/s, alpha/2, 1/beta_safe,
# w beta_safe/alpha_safe}
LOG1P = ('  const float z = x * k.x;\n'
         '  const float q = z * z * k.z;\n'
         '  const float u = 1.0f + q;\n'
         '  const float L = u == 1.0f ? q\n'
         '      : logf(u) - __fdividef((u - 1.0f) - q, u);\n')
LOG1P_SERIES = ('  const float z = x * k.x;\n'
                '  const float q = z * z * k.z;\n'
                '  float L;\n'
                '  if (q < 0.125f) {\n'
                '    float p = -1.0f / 8.0f;\n'
                '    p = fmaf(p, q, 1.0f / 7.0f);\n'
                '    p = fmaf(p, q, -1.0f / 6.0f);\n'
                '    p = fmaf(p, q, 1.0f / 5.0f);\n'
                '    p = fmaf(p, q, -1.0f / 4.0f);\n'
                '    p = fmaf(p, q, 1.0f / 3.0f);\n'
                '    p = fmaf(p, q, -0.5f);\n'
                '    L = fmaf(p * q, q, q);\n'
                '  } else {\n'
                '    const float u = 1.0f + q;\n'
                '    L = logf(u) - __fdividef((u - 1.0f) - q, u);\n'
                '  }\n')
EXPM1 = ('  const float t = k.y * L;\n'
         '  float e;\n'
         '  if (fabsf(t) < 0.35f) {\n'
         '    float p = 1.0f / 5040.0f;\n'
         '    p = fmaf(p, t, 1.0f / 720.0f);\n'
         '    p = fmaf(p, t, 1.0f / 120.0f);\n'
         '    p = fmaf(p, t, 1.0f / 24.0f);\n'
         '    p = fmaf(p, t, 1.0f / 6.0f);\n'
         '    p = fmaf(p, t, 0.5f);\n'
         '    e = fmaf(p * t, t, t);\n'
         '  } else {\n'
         '    e = expf(t) - 1.0f;\n'
         '  }\n'
         '  return k.w * e;\n')
PRECISE_LOG = ('  const float z = x * k.x;\n'
               '  const float L = log1pf(z * z * k.z);\n')
BODIES = {   # name -> (body, computes rho?)
    'loads_stores_only': ('  return k.w * x + k.y + k.z + k.x;\n', False),
    'no_expm1f': ('  const float z = x * k.x;\n'
                  '  return k.w * (k.y * log1pf(z * z * k.z));\n', False),
    'no_log1pf': ('  const float z = x * k.x;\n'
                  '  return k.w * expm1f(k.y * (z * z * k.z));\n', False),
    'log_corrected': (LOG1P + '  return k.w * expm1f(k.y * L);\n', True),
    'series_expm1': (PRECISE_LOG + EXPM1, True),
    'both_cheap': (LOG1P + EXPM1, True),
    'all_series': (LOG1P_SERIES + EXPM1, True),
}


def variants(src):
    """name -> (source, computes rho?): the source with rho_w's body
    replaced."""
    start = src.index(HEAD) + len(HEAD)
    end = src.index('}\n', start)
    return {name: (src[:start] + body + src[end:], rho)
            for name, (body, rho) in BODIES.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'split_k4_fwd.json'))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('split_k4_fwd: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from chip_smoke import K4_LPIPS, k4_inputs, time_ms
    from npp_tpu_torch.kernels import robust_rho as rr
    from npp_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    with open(os.path.join(ROOT, 'npp_tpu_torch', 'csrc',
                           'robust_rho_fwd.cu')) as f:
        src = f.read()
    out_dir = os.path.join(BUILD_DIR, 'split_k4_fwd')
    os.makedirs(out_dir, exist_ok=True)
    procs, fns, is_rho = {}, {}, {}
    for name, (code, rho) in variants(src).items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(code)
        so = os.path.join(out_dir, f'lib{name}.so')
        procs[name] = (subprocess.Popen([nvcc_path(), *NVCC_FLAGS, '-o', so,
                                         cu]), so)
        is_rho[name] = rho
    for name, (proc, so) in procs.items():
        if proc.wait() != 0:
            sys.exit(f'split_k4_fwd: nvcc failed for {name}')
        fn = ctypes.CDLL(so).npp_robust_rho_fwd_group
        fn.argtypes = [ctypes.POINTER(rr._Segment), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def launch(fn, segs):
        arr = (rr._Segment * len(segs))()
        outs = []
        for i, (x, a, s, w) in enumerate(segs):
            r = torch.empty(x.shape[0], device=x.device)
            arr[i] = rr._Segment(x.data_ptr(), a.data_ptr(), s.data_ptr(),
                                 w.data_ptr(), r.data_ptr(), *x.shape)
            outs.append(r)
        status = fn(arr, len(segs), sms,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f'split_k4_fwd: launch failed ({status})')
        return outs

    def f64_err(outs, segs):
        worst = 0.0
        for r, seg in zip(outs, segs):
            ref = rr.rho_rows_plain(*[t.double() for t in seg])
            worst = max(worst, float((r.double() - ref).abs().max()) /
                        float(ref.abs().max()))
        return worst

    gen = torch.Generator().manual_seed(0)
    rows = []
    for label, shapes in (('layer1', K4_LPIPS[:1]), ('group', K4_LPIPS),
                          ('layer1_at_init', K4_LPIPS[:1])):
        segs = [k4_inputs(gen, m, c, 'spread') for m, c in shapes]
        if label.endswith('at_init'):   # the latents' init: alpha 1, s 1
            segs = [(x, torch.ones_like(a), torch.ones_like(s), w)
                    for x, a, s, w in segs]
        x = segs[0][0]
        dst = torch.empty(x.shape[0], device=x.device)
        row = {'case': label, 'shapes': [list(s) for s in shapes],
               'us': {'kernel': time_ms(lambda: rr.rho_fwd_group_launch(
                   segs), iters=50) * 1e3},
               'rel_err_vs_f64': {'kernel': f64_err(
                   rr.rho_fwd_group_launch(segs), segs)}}
        if label == 'layer1':
            row['us']['torch_sum_rows_same_bytes'] = time_ms(
                lambda: torch.sum(x, 1, out=dst), iters=50) * 1e3
        for name, fn in fns.items():
            row['us'][name] = time_ms(lambda: launch(fn, segs),
                                      iters=50) * 1e3
            if is_rho[name]:
                row['rel_err_vs_f64'][name] = f64_err(launch(fn, segs), segs)
        rows.append(row)
    line = json.dumps({'device': torch.cuda.get_device_name(0),
                       'rows': rows})
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
