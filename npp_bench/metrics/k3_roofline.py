"""k3_roofline: K3's (the CX chain's) least time over its device time in
the profiled block, in %.

The least time of a step is counted from the K3 work items the cell's kind
declares (its `work`): N samples of P x Q positions and C channels, the
gradients wanted, the mask and the precision of the product. In the fits:
N = images x patches x real patches per patch, P = Q = (patch / 4)^2, C =
256 (VGG19 relu3_4), one forward (the similarity product, x and y read, z
written) and one backward for the gradient in x (the real side takes
none), in TF32. Each is bound by the larger of its operations over the
precision's peak and its bytes over the memory peak (flops.py::k3_bounds).
The device time is that of the kernels that kernel_groups.json assigns to
K3. None where the kind declares no K3 work."""
from npp_bench.flops import k3_least, kernel_items

GROUP = 'K3 cx_chain'


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    busy = s.kernel_seconds(ctx.group(GROUP))
    items = kernel_items(ctx, 'K3')
    if busy <= 0 or not items:
        return None
    least = sum(k3_least(it, ctx.peaks) for it in items)
    return 100.0 * least * s.steps / busy
