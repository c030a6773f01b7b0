"""The kind 'batched_fit_block': B images stacked in one step,
`parallel/batch.py::make_batched_fit_block`'s run_block, built as
`parallel/runner.py::fit_images` builds one bucket (program.py). Every other
step is the fit kinds' shared code (fit.py)."""
from npp_bench import program
from npp_bench.fit import (calibrate, check, first_block, limits,  # noqa: F401
                           make_inputs, staged, work)


def build(config: dict, traffic: dict, inputs, device) -> program.Fit:
    return program.build(config, traffic, inputs.arrays, inputs.base, device,
                         stacked=True)
