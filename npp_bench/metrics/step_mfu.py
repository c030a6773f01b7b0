"""step_mfu: the whole step's share of the card's dense matmul peak, in %.

The operations of one image-step counted from the configuration's
published widths (flops.py), times the image-steps per second of the
run's unprofiled window, over the peak that the configuration's
matmul_precision runs its f32 products at (TF32 at 'bfloat16')."""


def read(ctx):
    if ctx.rate is None:
        return None
    return 100.0 * ctx.flops['total'] * ctx.rate / ctx.matmul_peak
