"""dispatch.enqueue_us_per_step: the host's time to enqueue a model step:
the port's ``sim.step.enqueue`` spans (``Simulation.step``'s loop over the
stepper, up to its synchronise) over the steps they count, in
microseconds. The port keeps its spans (``njw_tpu_torch.utils.profiling``)
while a profiler session records, which the traced run opens on its
window alone. None where the port keeps no such span."""


def read(record):
    from njw_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "spans", list)()
             if s.name == "sim.step.enqueue"]
    steps = sum(s.counters["steps"] for s in spans)
    if not steps:
        return None
    return sum(s.duration_ns for s in spans) / 1e3 / steps
