"""N-body simulation driver: step and run (by duration or steps, with a
callback interval), diagnostics, performance metrics, save and load.

Counterpart of ``njw_tpu/nbody/simulation.py``. The JAX package runs a
chunk of steps in one jitted ``lax.scan``; here a chunk is a host loop of
eager steps, and ``step(n)`` synchronises once at its end (as
``block_until_ready`` does there). The saved ``.npz`` has the JAX
package's keys, so a state saved by either package loads in the other.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from njw_tpu_torch.nbody.forces import accelerations
from njw_tpu_torch.nbody.integrators import make_nbody_stepper
from njw_tpu_torch.nbody.system import NBodySystem, system_diagnostics
from njw_tpu_torch.platform.device import require_device


class NBodySimulation:
    """Drives an ``NBodySystem`` on its device with a chosen integrator."""

    def __init__(self, system: NBodySystem, *, integrator: str = "leapfrog",
                 dt: float = 0.01, acc_chunk: int = 1024,
                 force_method: str = "auto", pm_box: float = 0.0,
                 pm_mesh: int = 64):
        self.system = system
        self.dt = float(dt)
        self.integrator_name = integrator
        self.time = 0.0
        self.step_count = 0
        self.metrics = {"total_time_ms": 0.0, "num_steps": 0}

        def acc_fn(s):
            return accelerations(s, chunk=acc_chunk, method=force_method,
                                 pm_box=pm_box, pm_mesh=pm_mesh)

        self.stepper = make_nbody_stepper(integrator, acc_fn)
        self._carry = self.stepper.init(system)

    def advance(self, carry, system: NBodySystem):
        """One step from (carry, system), mutating nothing: the step that
        ``step`` takes (and that a CUDA graph may capture)."""
        return self.stepper.step(carry, system, self.dt)

    def step(self, n: int = 1, synchronize: bool = True) -> NBodySystem:
        """Take ``n`` steps. With ``synchronize=False`` it returns once the
        steps are enqueued (the host's cost alone)."""
        t0 = time.perf_counter()
        carry, system = self._carry, self.system
        for _ in range(n):
            carry, system = self.advance(carry, system)
        self._carry, self.system = carry, system
        if synchronize and system.pos.is_cuda:
            torch.cuda.synchronize(system.pos.device)
        self.metrics["total_time_ms"] += (time.perf_counter() - t0) * 1e3
        self.metrics["num_steps"] += n
        self.step_count += n
        self.time += n * self.dt
        return self.system

    def run(self, duration: Optional[float] = None, *,
            n_steps: Optional[int] = None,
            callback: Optional[Callable] = None,
            callback_interval: int = 10) -> NBodySystem:
        """Run for a duration or an exact step count, calling
        ``callback(self)`` every ``callback_interval`` steps."""
        if n_steps is None:
            n_steps = int(round((duration or 0.0) / self.dt))
        remaining = n_steps
        chunk = callback_interval if callback is not None else n_steps
        while remaining > 0:
            n = min(chunk, remaining)
            self.step(n)
            remaining -= n
            if callback is not None:
                callback(self)
        return self.system

    def diagnostics(self) -> dict:
        return {k: v.cpu().numpy().tolist()
                for k, v in system_diagnostics(self.system).items()}

    def performance_metrics(self) -> dict:
        m = dict(self.metrics)
        steps = max(m["num_steps"], 1)
        n = self.system.n
        m["ms_per_step"] = m["total_time_ms"] / steps
        m["steps_per_second"] = steps / (m["total_time_ms"] / 1e3 or 1e-9)
        # pairwise interactions per second: the N-body throughput metric
        m["interactions_per_second"] = n * n * m["steps_per_second"]
        return m

    def save_state(self, path: str) -> str:
        """An ``.npz`` with the JAX package's keys (positions, velocities,
        masses, ids, time, step, dt, G, softening, integrator)."""
        n = self.system.n
        np.savez(
            path,
            positions=self.system.pos.cpu().numpy(),
            velocities=self.system.vel.cpu().numpy(),
            masses=self.system.mass.cpu().numpy(),
            ids=np.arange(n, dtype=np.int64),
            time=self.time,
            step=self.step_count,
            dt=self.dt,
            G=float(self.system.G),
            softening=float(self.system.softening),
            integrator=self.integrator_name,
        )
        if not path.endswith(".npz"):
            path = path + ".npz"
        return path

    @classmethod
    def load_state(cls, path: str, *, device="cuda",
                   **kwargs) -> "NBodySimulation":
        dev = require_device(device)
        with np.load(path, allow_pickle=False) as d:
            def t(key):
                return torch.from_numpy(
                    np.asarray(d[key], np.float32)).to(dev)

            system = NBodySystem(pos=t("positions"), vel=t("velocities"),
                                 mass=t("masses"), G=float(d["G"]),
                                 softening=float(d["softening"]))
            sim = cls(system, integrator=str(d["integrator"]),
                      dt=float(d["dt"]), **kwargs)
            sim.time = float(d["time"])
            sim.step_count = int(d["step"])
        return sim

    def visualization_data(self) -> dict:
        return {
            "positions": self.system.pos.cpu().numpy(),
            "velocities": self.system.vel.cpu().numpy(),
            "masses": self.system.mass.cpu().numpy(),
            "time": self.time,
        }
