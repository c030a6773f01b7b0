"""host_wait_share: the host's wall inside the program's npp.h2d spans
(blocking host-to-card copies of the draws and row indices, each waiting
for the card's queue to drain) over the summed wall of its npp.block
spans, in %, in the profiled block.

Read from the port's span record (npp_tpu_torch/utils/debug.py), which is
filled only while a profiler records: the traced block. Only npp.h2d
spans inside a block and not inside another npp.h2d count, so the share
is a part of its denominator. None where the program keeps no such
record."""

BLOCK, H2D = 'npp.block', 'npp.h2d'


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
    wait = 0.0
    for i, s in enumerate(spans):
        if s.name == H2D and closed[i]:
            up = list(_ancestors(spans, i))
            if BLOCK in up and H2D not in up:
                wait += s.end - s.start
    return 100.0 * wait / blocks
