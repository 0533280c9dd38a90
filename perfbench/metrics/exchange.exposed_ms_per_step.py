"""exchange.exposed_ms_per_step: rank 0's device time inside the port's
``sim.step`` spans in which a NCCL kernel ran and no other kernel, copy or
set did (the halo exchange the step waits for, not hidden behind other
work), over the steps of those spans, in ms (``drivers/process_mesh.py``
``_exchange_exposed``). None where the trace holds no such span."""


def read(record):
    tr = record.trace
    if not tr or not tr.get("exchange_steps"):
        return None
    return 1e3 * tr["exchange_exposed_s"] / tr["exchange_steps"]
