"""forecast.outside_port_ms: what a forecast costs its caller outside the
port: the harness's time of each traced forecast (``Forecast.seconds``,
from the build call until its output can be read and is released) less
its simulation's ``sim.build`` and ``sim.run`` spans, mean over the
forecasts, in ms. That is the caller's synchronise, its first read of the
last snapshot and the releases. Forecasts and simulations pair in the
order of the simulations' identifiers. None where a forecast failed, or
where the port keeps no such span (see
``dispatch.enqueue_us_per_step.py``)."""


def read(record):
    from njw_tpu_torch.utils import profiling

    if record.failed or not record.forecasts:
        return None
    port: dict = {}
    for s in getattr(profiling, "spans", list)():
        if s.name in ("sim.build", "sim.run"):
            port[s.sim] = port.get(s.sim, 0) + s.duration_ns
    if len(port) != len(record.forecasts):
        return None
    return sum(f.seconds * 1e3 - port[sim] / 1e6 for f, sim in
               zip(record.forecasts, sorted(port))) / len(port)
