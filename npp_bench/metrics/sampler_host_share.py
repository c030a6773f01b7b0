"""sampler_host_share: the self time of the program's npp.draw spans (the
sampler, models/sampler.py through trainer.draw_batch: the host's random
draws and the patch gathers it enqueues; its duration minus its child
spans, the blocking copies of npp.h2d) over the summed wall of its
npp.block spans, in %, in the profiled block.

Read from the port's span record (npp_tpu_torch/utils/debug.py), which is
filled only while a profiler records: the traced block. Only npp.draw
spans inside a block and not inside another npp.draw count, so the share
is a part of its denominator. None where the program keeps no such
record."""

BLOCK, DRAW = 'npp.block', 'npp.draw'


def _record():
    try:
        from npp_tpu_torch.utils import debug
    except ImportError:
        return None
    rec = getattr(debug, 'RECORD', None)
    return rec if rec is not None and getattr(rec, 'spans', None) else None


def _ancestors(spans, i):
    p = spans[i].parent
    while p >= 0:
        yield spans[p].name
        p = spans[p].parent


def read(ctx):
    rec = _record()
    if rec is None:
        return None
    spans = list(rec.spans)
    closed = [s.end >= s.start for s in spans]     # NaN: still open
    blocks = sum(s.end - s.start for s, c in zip(spans, closed)
                 if c and s.name == BLOCK)
    if blocks <= 0:
        return None
    child = [0.0] * len(spans)
    for s, c in zip(spans, closed):
        if c and s.parent >= 0:
            child[s.parent] += s.end - s.start
    own = 0.0
    for i, s in enumerate(spans):
        if s.name == DRAW and closed[i]:
            up = list(_ancestors(spans, i))
            if BLOCK in up and DRAW not in up:
                own += s.end - s.start - child[i]
    return 100.0 * own / blocks
