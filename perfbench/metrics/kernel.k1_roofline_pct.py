"""kernel.k1_roofline_pct: K1 (ops/csrc/swe_rk4.cu), its launches' least time
(``perfbench/cost/k1.py``, at the data sheet's 3.35 TB/s) over their
device time in the trace, in percent."""
from perfbench.metrics._roofline import share


def read(record):
    return share(record, "k1")
