"""output.ms_per_snapshot: the port's own output time,
``Simulation.metrics.io_time_ms`` (a host clock around ``_store_output``:
the output function and the copy of its fields to the host), over the
snapshots it stored."""


def read(record):
    n = sum(f.snapshots for f in record.forecasts)
    if not n:
        return None
    return sum(f.io_ms for f in record.forecasts) / n
