"""Quick checks and times of K3 (csrc/cx_chain.cu) on one CUDA card, the
first run after an edit of the kernel.

    python3 scripts/check_k3.py [--shapes fit,batched,patch64,search]
                                [--modes cosine,l2,l1] [--out FILE]

Prints the toolkit's versions and the TF32 GMMA atoms of CUTLASS's
cute/arch/mma_sm90_gmma.hpp where the headers are installed, builds K3 with
`-Xptxas -v` and counts the wgmma.mma_async instructions of its PTX, then
at each of chip_smoke.py's K3 shapes: z and both gradients of the kernel
against the plain chain in the same precision and against float64 (the
search's shape: the masked forward in f32 only), the device times (cold,
as chip_smoke.py takes them) of the kernel's forward and backward and of
the plain chain, and the device ms of each of the kernel's passes
(torch.profiler). Then the l2 and l1 forms at 6 x 256 in f32. One JSON
line at the end, also written to --out. Needs a card.
"""
import argparse
import glob
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

SHAPES = {'fit': CS.K3_FIT, 'batched': CS.K3_BATCHED,
          'patch64': CS.K3_PATCH64, 'search': CS.K3_SEARCH}


def toolkit():
    import torch
    from npp_tpu_torch.kernels.build import nvcc_path
    out = dict(torch=torch.__version__, cuda=torch.version.cuda,
               device=torch.cuda.get_device_name(0))
    out['nvcc'] = subprocess.run([nvcc_path(), '--version'],
                                 capture_output=True, text=True
                                 ).stdout.strip().splitlines()[-1]
    names = set()
    for path in glob.glob('/usr/local/cutlass/include/cute/arch/'
                          'mma_sm90_gmma*.hpp'):
        with open(path) as f:
            names |= set(re.findall(r'\w*TF32TF32\w*', f.read()))
    # CUTLASS's TF32 GMMA atoms, and whether every one is K-major (TN)
    out['cutlass_tf32_gmma_atoms'] = len(names)
    out['cutlass_tf32_atoms_all_tn'] = bool(names) and all(
        '_TN' in n for n in names)
    out['cutlass_tf32_atom_examples'] = sorted(names)[:6]
    return out


def check_shape(gen, label, shape, modes=('cosine',)):
    import torch
    from npp_tpu_torch.device import matmul_precision
    from npp_tpu_torch.kernels import cx_chain as K
    n, p, c = shape
    search = label == 'search'
    xn, yn = CS.k3_rows(gen, n, p, c)
    fv = (torch.rand(n, p, generator=gen) > 0.2).float().cuda() \
        if search else None
    g = None if search else (torch.rand(n, p, generator=gen) + 0.5).cuda()
    out = {}
    f64 = CS.k3_run(K.cx_colmax_plain, xn, yn, fv, g, torch.float64)
    for prec in ('float32',) if search else ('float32', 'bfloat16'):
        with matmul_precision(prec):
            got = CS.k3_run(K.cx_colmax, xn, yn, fv, g, torch.float32)
            want = CS.k3_run(K.cx_colmax_plain, xn, yn, fv, g, torch.float32)
            again = CS.k3_run(K.cx_colmax, xn, yn, fv, g, torch.float32)
            tag = 'f32' if prec == 'float32' else 'tf32'
            out[tag] = dict(
                err_vs_plain=[CS.k3_rel(a, b) for a, b in zip(got, want)],
                err_vs_f64=[CS.k3_rel(a, b) for a, b in zip(got, f64)],
                plain_err_vs_f64=[CS.k3_rel(a, b) for a, b in zip(want, f64)],
                bit_equal=all(torch.equal(a, b) for a, b in zip(got, again)))
            del got, want, again
            iters = 3 if search else 10
            kp = K.PREC_TF32 if tag == 'tf32' else K.PREC_F32
            fwd = lambda: K.cx_colmax(xn, yn, 0.5, fv)  # noqa: E731
            out[tag].update(
                fwd_ms=CS.time_ms(fwd, iters=iters),
                plain_fwd_ms=CS.time_ms(
                    lambda: K.cx_colmax_plain(xn, yn, 0.5, fv), iters=iters),
                fwd_passes=CS.k3_pass_ms(fwd))
            if not search:
                z, saved = K.cx_fwd_launch(xn, yn, fv, 0.5, kp)
                bwd = lambda: K.cx_bwd_launch(  # noqa: E731
                    g, xn, yn, fv, saved, z, 0.5, kp)

                def plain():
                    a, b = (t.detach().requires_grad_() for t in (xn, yn))
                    return torch.autograd.grad(
                        K.cx_colmax_plain(a, b, 0.5, fv), (a, b), g)
                out[tag].update(
                    bwd_ms=CS.time_ms(bwd, iters=iters),
                    plain_fwd_bwd_ms=CS.time_ms(plain, iters=iters),
                    bwd_passes=CS.k3_pass_ms(bwd))
                del z, saved
    for mode in modes:
        if mode != 'cosine':
            out[mode] = CS.k3_form_errs(gen, mode, n, p, c)
    CS.log(f'{label} {shape}: {json.dumps(out)}')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--shapes', default='fit,batched,patch64,search')
    ap.add_argument('--modes', default='cosine,l2,l1')
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'check_k3.json'))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('check_k3: needs a CUDA card')
    from npp_tpu_torch.kernels.build import build_library
    from npp_tpu_torch.device import matmul_precision
    info = toolkit()
    CS.log(json.dumps(info))
    build_library('cx_chain', ptxas_verbose=True)
    info['wgmma_in_ptx'] = CS.k3_wgmma_count()
    CS.log(f"wgmma.mma_async in K3's PTX: {info['wgmma_in_ptx']}")
    gen = torch.Generator().manual_seed(0)
    res = {}
    modes = tuple(args.modes.split(','))
    with matmul_precision('float32'):
        for label in args.shapes.split(','):
            res[label] = check_shape(gen, label, SHAPES[label],
                                     modes if label == 'patch64' else ())
    line = json.dumps(dict(info=info, shapes=res))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
