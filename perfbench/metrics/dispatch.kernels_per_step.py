"""dispatch.kernels_per_step: kernels the device ran inside the traced
forecasts (copies and sets not counted) over their model steps.
The port's launch counters give the hand-written kernels' share, which
the result's standard error prints beside it."""


def read(record):
    tr = record.trace
    if not tr or not record.steps:
        return None
    return tr["kernels"] / record.steps
