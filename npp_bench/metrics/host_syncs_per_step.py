"""host_syncs_per_step: the card's synchronising operations per fit step in
the profiled block, counted by the program itself.

The port's spans (npp_tpu_torch/utils/debug.py) record only while a
profiler records, which is the traced block alone; while its outermost
span is open, each of PyTorch's sync-debug warnings (a blocking copy, an
.item()) counts against the innermost open span. This is every sync the
record counted over its npp.step spans. None where the program keeps no
such record."""


def _record():
    try:
        from npp_tpu_torch.utils import debug
    except ImportError:
        return None
    rec = getattr(debug, 'RECORD', None)
    return rec if rec is not None and getattr(rec, 'spans', None) else None


def read(ctx):
    rec = _record()
    if rec is None:
        return None
    steps = sum(s.name == 'npp.step' for s in rec.spans)
    if steps <= 0:
        return None
    return sum(s.syncs for s in rec.spans) / steps
