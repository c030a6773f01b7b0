"""Check on one CUDA card that K1 (csrc/periodic_embed.cu) writes the same
bits with `sincosf` as with separate `sinf` and `cosf` calls.

    python3 scripts/check_k1_sincos.py [--out FILE]

Builds a variant of the source with `sincosf(xf, &s, &c)` replaced by
`s = sinf(xf); c = cosf(xf);`, runs it and the kernel through the same
wrapper at the canvas table's shape (384*512 rows, K = 3, 1386 channels), in
float32 and bfloat16, and compares the outputs bit for bit. Prints one JSON
line; writes it to --out too; exits non-zero if they differ.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINCOS = 'sincosf(xf, &s, &c);'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                  'check_k1_sincos.json'))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('check_k1_sincos: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.kernels import periodic_embed as pe
    from npp_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc_path
    from npp_tpu_torch.utils.synthetic import H, W, synthetic_data

    with open(os.path.join(ROOT, 'npp_tpu_torch', 'csrc',
                           'periodic_embed.cu')) as f:
        src = f.read()
    if src.count(SINCOS) != 1:
        sys.exit(f'check_k1_sincos: {SINCOS!r} is not in the source once')
    out_dir = os.path.join(BUILD_DIR, 'check_k1_sincos')
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, 'sinf_cosf.cu')
    with open(cu, 'w') as f:
        f.write(src.replace(SINCOS, 's = sinf(xf);\n      c = cosf(xf);'))
    so = os.path.join(out_dir, 'libsinf_cosf.so')
    subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', so, cu], check=True)
    variant = ctypes.CDLL(so)
    variant.npp_periodic_embed.argtypes = pe._lib().npp_periodic_embed.argtypes
    variant.npp_periodic_embed.restype = ctypes.c_int

    data = synthetic_data(0)
    dev = torch.device('cuda')
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing='ij')
    coords = torch.stack([ys, xs], -1).reshape(-1, 2).float()
    bands = (torch.randn(10, generator=torch.Generator().manual_seed(0))
             * 10).to(dev)
    call = (coords, torch.tensor(data.selected_angles, device=dev).float(),
            torch.tensor(data.selected_periods, device=dev).float(), bands,
            (1.0,), (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), (H, W))
    rows = []
    for dtype in pe.OUT_DTYPES:
        got = pe.periodic_embed(*call, out_dtype=dtype)
        with mock.patch.object(pe, '_lib', lambda: variant):
            ref = pe.periodic_embed(*call, out_dtype=dtype)
        torch.cuda.synchronize()
        rows.append({'dtype': str(dtype).split('.')[-1],
                     'shape': list(got.shape),
                     'same_bits': bool(torch.equal(got, ref)),
                     'max_abs_diff': float((got.float() - ref.float())
                                           .abs().max())})
    line = json.dumps({'device': torch.cuda.get_device_name(0),
                       'rows': rows})
    print(line, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(line + '\n')
    if not all(r['same_bits'] for r in rows):
        sys.exit('check_k1_sincos: sincosf and sinf/cosf differ')


if __name__ == '__main__':
    main()
