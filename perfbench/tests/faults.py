"""Faults planted under the timed path for the tests of ``correct``:
each breaks what the port produces, and the run must judge it wrong.
"""
import numpy as np


def frozen_step():
    """Every RK4 step returns its state unchanged."""
    from njw_tpu_torch.weather import integrators

    def rk4(tendency):
        def step(carry, s, dt):
            return carry, s

        return integrators.Stepper(lambda s: None, step, "rk4", 4)

    integrators.INTEGRATORS["rk4"] = rk4


def altered_answer(field: str):
    """Each snapshot's ``field`` is altered at one point as it is stored,
    by a hundredth of the field's largest magnitude."""
    from njw_tpu_torch.weather.model import Simulation

    store = Simulation._store_output

    def altered(self):
        store(self)
        a = self.snapshots[-1][field]
        a.flat[a.size // 3] += 0.01 * float(np.abs(a).max())

    Simulation._store_output = altered

