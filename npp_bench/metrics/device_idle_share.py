"""device_idle_share: the share of the traced block's wall in which no
operation runs on the card, in %: one minus the union of its kernel, copy
and fill intervals over the block's wall between its two
synchronisations, both from the one profile. Recording every host
operation slows the host (a flagship step took 38 ms profiled against
27 ms without), so this reads higher than an unprofiled step would."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
