"""mesh.step_mfu: ``step_mfu`` on a mesh: the whole model step's share
of one card's peak on that card's part of the domain (the configuration's
``mesh`` divides the domain in its cost module), over rank 0's traced
window, in percent."""
from perfbench import harness


def read(record):
    return harness.reader("step_mfu").read(record)
