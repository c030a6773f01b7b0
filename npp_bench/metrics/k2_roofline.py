"""k2_roofline: K2's (bias + snake, forward and backward) least time over
its device time in the profiled block, in %.

The least time of a step: for each K2 work item the cell's kind declares
(its `work`: rows and width; in the fits every snake layer of the MLP, the
trunk, the scale branch and the position head, on the step's rows of all
images), one read of the input, the bias and the upstream gradient and one
write of each output, over the memory peak (flops.py::k2_bounds). The
device time is that of the kernels that kernel_groups.json assigns to K2.
None where the kind declares no K2 work."""
from npp_bench.flops import k2_least, kernel_items

GROUP = 'K2 bias_snake'


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    busy = s.kernel_seconds(ctx.group(GROUP))
    items = kernel_items(ctx, 'K2')
    if busy <= 0 or not items:
        return None
    least = sum(k2_least(it, ctx.peaks) for it in items)
    return 100.0 * least * s.steps / busy
