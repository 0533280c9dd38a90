"""step_mfu: the whole model step's share of the card's peak: the least
time one step of the configuration takes as a function (its state read
and written once and its operations, ``perfbench/cost/<cost>.py``, on
one card's part of the domain) times the traced steps, over the traced
window, in percent. Whatever kernels do the step, it bounds their
rooflines from below."""
import importlib


def read(record):
    tr = record.trace
    if not tr or tr["window_s"] <= 0 or not record.steps:
        return None
    cost = importlib.import_module(
        f"perfbench.cost.{record.cell.config['cost']}")
    return 100.0 * record.steps * cost.step_bound_s(record.cell.config) \
        / tr["window_s"]
