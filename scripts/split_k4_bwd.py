"""Where K4's backward kernel (csrc/robust_rho_bwd.cu) spends its time, on
one CUDA card.

    python3 scripts/split_k4_bwd.py [--out FILE]

Builds variants of the source with one part taken out (only the loads and
stores; no expm1f; no log1pf) or with four blocks per SM in place of three,
and times each beside the kernel, K4's forward and `torch.mul` over the
same bytes (a copy's floor), at the LPIPS layer-1 and layer-2 shapes with
alpha across (0.001, 1.999), below 1 only, and from 1 up (one form of the
alpha derivative per warp). Device times by CUDA-graph replay, as
chip_smoke.py takes them. Prints one JSON line; writes it to --out too.
The variants are measurements only: their outputs are not checked.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((153600, 64), (38400, 128))
ALPHAS = {'mixed': (0.001, 1.999), 'below_1': (0.001, 0.999),
          'from_1': (1.0, 1.999)}


def variants(src):
    """name -> source, each with one change; every change must apply."""
    def sub(old, new):
        if old not in src:
            raise RuntimeError(f'split_k4_bwd: {old!r} is not in the source')
        return src.replace(old, new, 1)
    return {
        'loads_stores_only': sub(
            '  const float z = x * inv_s;',
            '  return x * g * w + a_over_asafe + inv_a + inv_b + a + b + '
            'inv_s;\n  const float z = x * inv_s;'),
        'no_expm1f': sub('const float em1 = expm1f(lo ? t : -0.5f * b * L);',
                         'const float em1 = lo ? t : -0.5f * b * L;'),
        'no_log1pf': sub('const float L = log1pf(q);', 'const float L = q;'),
        'four_blocks_per_sm': sub('__launch_bounds__(kThreads, 3)',
                                  '__launch_bounds__(kThreads, 4)'),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'split_k4_bwd.json'))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('split_k4_bwd: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from npp_tpu_torch.kernels import robust_rho as rr
    from npp_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path

    with open(os.path.join(ROOT, 'npp_tpu_torch', 'csrc',
                           'robust_rho_bwd.cu')) as f:
        src = f.read()
    out_dir = os.path.join(BUILD_DIR, 'split_k4_bwd')
    os.makedirs(out_dir, exist_ok=True)
    fns = {}
    for name, code in variants(src).items():
        cu = os.path.join(out_dir, f'{name}.cu')
        with open(cu, 'w') as f:
            f.write(code)
        so = os.path.join(out_dir, f'lib{name}.so')
        subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', so, cu], check=True)
        fn = ctypes.CDLL(so).npp_robust_rho_bwd
        p = ctypes.c_void_p
        fn.argtypes = [p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(fn, g, x, alpha, scale, w):
        m, c = x.shape
        dx = torch.empty_like(x)
        buf = torch.empty(((2 + 16 * sms) * c,), device=dev)
        status = fn(x.data_ptr(), alpha.data_ptr(), scale.data_ptr(),
                    w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    buf[2 * c:].data_ptr(), buf.data_ptr(),
                    buf[c:].data_ptr(), m, c, sms,
                    torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f'split_k4_bwd: launch failed ({status})')
        return dx

    gen = torch.Generator().manual_seed(0)
    rows = []
    for m, c in SHAPES:
        x = (torch.randn(m, c, generator=gen) * 0.2).to(dev)
        scale = (0.01 + torch.rand(c, generator=gen)).to(dev)
        w = torch.rand(c, generator=gen).to(dev)
        g = torch.randn(m, generator=gen).to(dev)
        dx = torch.empty_like(x)
        for label, (lo, hi) in ALPHAS.items():
            alpha = (lo + (hi - lo) * torch.rand(c, generator=gen)).to(dev)
            row = {'shape': [m, c], 'alpha': label, 'us': {
                'kernel': time_ms(lambda: rr.rho_bwd_launch(
                    g, x, alpha, scale, w), iters=50) * 1e3,
                'forward': time_ms(lambda: rr.rho_fwd_launch(
                    x, alpha, scale, w), iters=50) * 1e3,
                'torch_mul_same_bytes': time_ms(
                    lambda: torch.mul(x, 2.0, out=dx), iters=50) * 1e3}}
            for name, fn in fns.items():
                row['us'][name] = time_ms(
                    lambda: launch(fn, g, x, alpha, scale, w),
                    iters=50) * 1e3
            rows.append(row)
    line = json.dumps({'device': torch.cuda.get_device_name(0),
                       'rows': rows})
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
