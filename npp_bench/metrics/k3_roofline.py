"""k3_roofline: K3's (the CX chain's) least time over its device time in
the profiled block, in %.

The least time of a step is counted from the cell's shapes: N = images x
patches x real patches per patch samples of P = Q = (patch / 4)^2
positions and C = 256 channels (VGG19 relu3_4), one forward (the
similarity product, x and y read, z written) and one backward for the
gradient in x (the real side takes none), each bound by the larger of
its operations over the TF32 peak and its bytes over the memory peak
(flops.py::k3_bounds). The device time is that of the kernels that
kernel_groups.json assigns to K3."""
from npp_bench.flops import k3_bounds

GROUP = 'K3 cx_chain'


def read(ctx):
    s = ctx.summary
    if s is None:
        return None
    busy = s.kernel_seconds(ctx.group(GROUP))
    cx = ctx.config['towers'].get('contextual')
    if busy <= 0 or not cx:
        return None
    sh = ctx.shapes
    p = (sh['patch'] // cx['downsample']) ** 2
    fwd, bwd = k3_bounds(ctx.images * sh['pk'], p, p, cx['channels'],
                         ctx.peaks)
    return 100.0 * (fwd + bwd) * s.steps / busy
