"""launches_per_step: device kernels per fit step (B stacked images count
one step), counted in the profiled block."""


def read(ctx):
    s = ctx.summary
    if s is None or s.steps <= 0 or not s.kernels:
        return None
    return s.launches() / s.steps
