"""driver.build_ms: the mean of the benchmark's host span around
``Simulation.from_config`` over the window's forecasts (configuration
checks, the initial state on the card, the stepper)."""


def read(record):
    if not record.forecasts:
        return None
    return 1e3 * sum(f.build_s for f in record.forecasts) \
        / len(record.forecasts)
