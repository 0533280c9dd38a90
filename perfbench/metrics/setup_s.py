"""setup_s: from the start of the process until the first timed forecast:
imports, the CUDA context, the kernel's load (its build, in the first run
of a checkout) and the warm-up forecasts of the cell's own shapes."""


def read(record):
    return record.setup_s
