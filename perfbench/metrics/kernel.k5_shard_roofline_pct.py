"""kernel.k5_shard_roofline_pct: K5 (ops/csrc/pe_stage.cu) in its padded
form on rank 0's block, its launches' least time
(``perfbench/cost/k5_shard.py``, at the data sheet's 3.35 TB/s) over their
device time in the trace, in percent."""
from perfbench.metrics._roofline import share


def read(record):
    return share(record, "k5_shard")
