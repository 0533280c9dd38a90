"""The share of a kernel's roofline: the least time its launches in the
trace could take (its cost module's ``bound_s``) over the time they took,
in percent. None where the trace holds no launch of it."""
import importlib


def share(record, cost_module: str):
    tr = record.trace
    if not tr:
        return None
    cost = importlib.import_module(f"perfbench.cost.{cost_module}")
    n, seconds = tr["by_kernel"].get(cost.KERNEL, (0, 0.0))
    if not n or seconds <= 0:
        return None
    return 100.0 * cost.bound_s(record.cell.config, n) / seconds
