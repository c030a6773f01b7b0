"""k2_roofline: K2's (bias + snake, forward and backward) least time over
its device time in the profiled block, in %.

The least time of a step: for every snake layer of the MLP (the trunk,
the scale branch, the position head) on the step's rows (all images),
one read of the input, the bias and the upstream gradient and one write
of each output, over the memory peak (flops.py::k2_bounds). The device
time is that of the kernels that kernel_groups.json assigns to K2."""
from npp_bench.flops import k2_bounds, snake_layers

GROUP = 'K2 bias_snake'


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    busy = s.kernel_seconds(ctx.group(GROUP))
    if busy <= 0:
        return None
    rows = ctx.images * ctx.shapes['rows']
    least = sum(sum(k2_bounds(rows, width, ctx.peaks))
                for width in snake_layers(ctx.config['mlp']))
    return 100.0 * least * s.steps / busy
