"""step_mfu: the whole step's share of the card's dense matmul peak, in %.

The operations of one image-step that the cell's kind declares (its
`work`; the fits count them from the configuration's published widths,
flops.py), times the image-steps per second of the run's unprofiled
window, over the peak the kind's products run at (TF32 in the fits, whose
matmul_precision 'bfloat16' runs f32 products in TF32). None where the
kind declares no operations."""
from npp_bench.flops import work_of


def read(ctx):
    if ctx.rate is None:
        return None
    work = work_of(ctx)
    if not work.get('flops'):
        return None
    return 100.0 * work['flops']['total'] * ctx.rate / \
        ctx.peaks[work['peak']]
