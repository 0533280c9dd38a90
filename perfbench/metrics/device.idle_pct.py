"""device.idle_pct: the share of the traced forecasts' time in which no
kernel, copy or set ran on the device, in percent."""


def read(record):
    tr = record.trace
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
