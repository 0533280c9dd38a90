"""output.d2h_gbps: the rate of the port's copy of its snapshots to the
host: the ``bytes`` its ``sim.output.copy`` spans count (the
``.cpu().numpy()`` of the output function's fields in
``Simulation._store_output``) over their time, in 10^9 bytes a second.
The time includes the first field's wait for the output function's
kernels, which its copy synchronises on. None where the port keeps no
such span (see ``dispatch.enqueue_us_per_step.py``)."""


def read(record):
    from njw_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "spans", list)()
             if s.name == "sim.output.copy"]
    ns = sum(s.duration_ns for s in spans)
    if not spans or ns <= 0:
        return None
    return sum(s.counters["bytes"] for s in spans) / ns   # bytes/ns = GB/s
