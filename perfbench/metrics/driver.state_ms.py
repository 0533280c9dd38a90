"""driver.state_ms: the port's ``sim.build.state`` span (the initial
state made on the device inside ``Simulation.from_config``), mean over
the traced forecasts, in ms. No synchronise ends it: it holds the
device's time only where the host waits for the device. None where the
port keeps no such span (see ``dispatch.enqueue_us_per_step.py``)."""


def read(record):
    from njw_tpu_torch.utils import profiling

    spans = [s for s in getattr(profiling, "spans", list)()
             if s.name == "sim.build.state"]
    if not spans:
        return None
    return sum(s.duration_ns for s in spans) / 1e6 / len(spans)
