"""regression_gemm_gflop: the operations of one step's batched products,
in GFLOP, from the 'bmm' work items the cell's kind declares (each
(n, rows, in, out), forward and both gradients); None where it declares
none."""
from npp_bench.flops import kernel_items


def read(ctx):
    items = kernel_items(ctx, 'bmm')
    if not items:
        return None
    return sum(3 * 2.0 * it['n'] * it['rows'] * it['in'] * it['out']
               for it in items) / 1e9
