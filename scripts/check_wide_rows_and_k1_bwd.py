"""A short first check of K4's wide rows and K1's backward on one card.

    python3 scripts/check_wide_rows_and_k1_bwd.py     (from the repo root)

Builds the three CUDA sources (printing `-Xptxas -v`), then holds once to
their plain versions and to float64: K4's forward as one grouped launch
and its backward at the style loss's shapes (6 x 4,096, 6 x 16,384,
6 x 65,536) with alpha spread and at exactly 0.001, 1.0 and 1.999, and
K1's backward at the completion step's 59,392 rows of 1,386 channels at
non-integer coordinates. Prints each error relative to the largest
float64 magnitude beside the plain f32 version's own, and eager ms per
call (20 launches between two CUDA events). chip_smoke.py makes the full
checks; this is the quick one to run first after editing a kernel.
"""
import concurrent.futures
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel(a, b):
    return float((a.double() - b.double()).abs().max() /
                 b.double().abs().max())


def eager_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('check_wide_rows_and_k1_bwd: needs a CUDA card')
    sys.path.insert(0, ROOT)
    from npp_tpu_torch.kernels import periodic_embed as pe
    from npp_tpu_torch.kernels import robust_rho as rr
    from npp_tpu_torch.kernels.build import build_library
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda n: build_library(n, ptxas_verbose=True),
                      ('periodic_embed', 'robust_rho_fwd', 'robust_rho_bwd')))
    print(f'built in {time.time() - t0:.1f} s', flush=True)
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    shapes = [(6, 4096), (6, 16384), (6, 65536)]
    for alpha in ('spread', 0.001, 1.0, 1.999):
        segs = []
        for m, c in shapes:
            a = 0.001 + 1.998 * torch.rand(c, generator=gen) \
                if alpha == 'spread' else torch.full((c,), alpha)
            segs.append([(torch.randn(m, c, generator=gen) * 0.2).to(dev),
                         a.to(dev), (0.01 + torch.rand(c, generator=gen)).to(dev),
                         torch.rand(c, generator=gen).to(dev)])
        for r, seg in zip(rr.rho_fwd_group_launch(segs), segs):
            p64 = rr.rho_rows_plain(*[t.double() for t in seg])
            print(f'K4 fwd alpha {alpha} {tuple(seg[0].shape)}: kernel '
                  f'{rel(r, p64):.2e}, plain {rel(rr.rho_rows_plain(*seg), p64):.2e}',
                  flush=True)
        for x, a, s, w in segs:
            g = torch.randn(x.shape[0], generator=gen).to(dev)
            got = rr.rho_bwd_launch(g, x, a, s, w)
            ins = [[t.to(dt, copy=True).requires_grad_() for t in (x, a, s)]
                   for dt in (torch.float32, torch.float64)]
            for i, dt in zip(ins, (torch.float32, torch.float64)):
                rr.rho_rows_plain(*i, w.to(dt)).backward(g.to(dt))
            print(f'K4 bwd alpha {alpha} {tuple(x.shape)} (dx, dalpha, ds): '
                  + ', '.join(f'kernel {rel(k, d.grad):.2e} plain '
                              f'{rel(p.grad, d.grad):.2e}'
                              for k, p, d in zip(got, *ins)), flush=True)
    n = 8192 + 2 * 160 * 160
    coords = (torch.rand(n, 2, generator=gen) *
              torch.tensor([384.0, 512.0])).to(dev)
    consts = (torch.tensor([[90.0, 180.0]] * 3, device=dev),
              torch.tensor([[48.0, 56.0], [24.0, 28.0], [96.0, 112.0]],
                           device=dev),
              (torch.randn(10, generator=gen) * 10).to(dev))
    cfg = ((1.0,), (0.0, -1.0, 1.0, 0.5, -0.5), (0.0,), (384, 512))
    grad = torch.randn(n, 1386, generator=gen).to(dev)
    grads = []
    for fn, dt in ((pe.periodic_embed, torch.float32),
                   (pe.periodic_embed_plain, torch.float32),
                   (pe.periodic_embed_plain, torch.float64)):
        c = coords.to(dt, copy=True).requires_grad_()
        fn(c, *[t.to(dt) for t in consts], *cfg).backward(grad.to(dt))
        grads.append(c.grad)
    print(f'K1 bwd {n}x1386: kernel {rel(grads[0], grads[2]):.2e}, plain '
          f'{rel(grads[1], grads[2]):.2e}', flush=True)
    args = pe._Args(coords, *consts, *cfg)
    print(f'eager ms: K1 bwd '
          f'{eager_ms(lambda: pe.periodic_embed_bwd_launch(grad, coords, args)):.4f}, '
          f'K4 wide fwd group {eager_ms(lambda: rr.rho_fwd_group_launch(segs)):.4f}, '
          f'K4 wide bwd 6x65536 '
          f'{eager_ms(lambda: rr.rho_bwd_launch(g, *segs[2])):.4f}', flush=True)


if __name__ == '__main__':
    main()
