"""Which batch sizes of 20x20 symmetric matrices `torch.linalg.eigvalsh`
(and its neighbours) accepts on one card, and how long each takes.

    python3 scripts/probe_batched_eigvalsh.py

ops/blur.py computes the eigenvalues of every pixel's 20x20 window Gram in
chunks; on an H100 with CUDA 12.8 cuSOLVER's batched syev
(cusolverDnXsyevBatched, which eigvalsh calls for a batch of small
matrices) refused a batch of 2^15 and took 2^14, which set its chunk. This
prints ok / FAIL and the seconds for eigvalsh (lower and upper), eigh,
eigvalsh in float64 and svdvals at batches 1 to 2^15.
"""
import sys
import time


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('probe_batched_eigvalsh: needs a CUDA card')
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    n = 20
    for b in (1, 64, 1024, 4096, 8192, 16384, 32768):
        w = (torch.rand(b, n, n, generator=gen) * 255).round().to(dev)
        a = torch.bmm(w.transpose(1, 2), w)
        for name, fn in (('eigvalsh', lambda a: torch.linalg.eigvalsh(a)),
                         ('eigvalsh_U',
                          lambda a: torch.linalg.eigvalsh(a, UPLO='U')),
                         ('eigh', lambda a: torch.linalg.eigh(a)[0]),
                         ('eigvalsh_f64',
                          lambda a: torch.linalg.eigvalsh(a.double())),
                         ('svdvals', lambda a: torch.linalg.svdvals(a))):
            try:
                t = time.time()
                fn(a)
                torch.cuda.synchronize()
                print(n, b, name, 'ok', f'{time.time() - t:.4f}s', flush=True)
            except RuntimeError as e:
                print(n, b, name, 'FAIL', str(e)[:100], flush=True)


if __name__ == '__main__':
    main()
