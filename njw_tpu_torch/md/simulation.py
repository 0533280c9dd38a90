"""MD simulation driver: integrators, thermostats and trajectory output.

Counterpart of ``njw_tpu/md/simulation.py``: velocity Verlet, leapfrog and
Beeman; Berendsen, Andersen and Nose-Hoover. The JAX package runs a chunk
of steps in one jitted ``lax.scan``; here a chunk is a host loop of eager
steps, and ``step(n)`` synchronises once at its end. Andersen draws from
a ``torch.Generator`` on the state's device seeded from ``seed``; every
other integrator and thermostat is deterministic.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from njw_tpu_torch.md.forces import make_force_fn
from njw_tpu_torch.md.system import (
    KB, LJParams, MDState, Topology, kinetic_energy, temperature,
)

INTEGRATORS = ("velocity_verlet", "leapfrog", "beeman")
THERMOSTATS = (None, "berendsen", "andersen", "nose_hoover")


class MDSimulation:
    """Velocity Verlet, leapfrog or Beeman dynamics with an optional
    thermostat, on the state's device."""

    def __init__(self, state: MDState, topology: Optional[Topology] = None,
                 lj: Optional[LJParams] = None, *, dt: float = 0.005,
                 integrator: str = "velocity_verlet", cutoff: float = 2.5,
                 thermostat: Optional[str] = None, T0: float = 1.0,
                 tau: float = 0.5, collision_rate: float = 0.1,
                 seed: int = 0, force_method: str = "auto"):
        dev = state.pos.device
        topology = Topology() if topology is None else topology
        if lj is None:
            lj = LJParams(epsilon=torch.ones(1, device=dev),
                          sigma=torch.ones(1, device=dev))
        if integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {integrator!r}; "
                             f"available: {sorted(INTEGRATORS)}")
        if thermostat not in THERMOSTATS:
            raise ValueError(f"unknown thermostat {thermostat!r}")
        self.state = state
        self.topology = topology
        self.lj = lj
        self.dt = float(dt)
        self.integrator = integrator
        self.thermostat = thermostat
        self.T0 = T0
        self.tau = float(tau)
        self.collision_rate = float(collision_rate)
        self.time = 0.0
        self.step_count = 0
        self.metrics = {"total_time_ms": 0.0, "num_steps": 0}
        self.trajectory: list[np.ndarray] = []

        self._force_fn = make_force_fn(
            topology, lj, cutoff, state.n, method=force_method,
            box_static=state.box.cpu().numpy(),
            pos_static=state.pos.cpu().numpy(), device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        f0, _ = self._force_fn(state)
        aux0 = torch.zeros((), device=dev)
        # carry: (state, force (beeman: (force, previous force)), the
        # Nose-Hoover friction xi)
        f = (f0, f0.clone()) if integrator == "beeman" else f0
        self._carry = (state, f, aux0)

    def _thermostat(self, s: MDState, xi):
        dt, T0 = self.dt, self.T0
        if self.thermostat is None:
            return s, xi
        if self.thermostat == "berendsen":
            T = temperature(s)
            lam = torch.sqrt(torch.clamp(
                1.0 + (dt / self.tau) * (T0 / torch.clamp(T, min=1e-8) - 1.0),
                min=0.0))
            return s.replace(vel=s.vel * lam), xi
        if self.thermostat == "andersen":
            gen = self._generator
            hit = torch.rand((s.n, 1), generator=gen, device=s.pos.device) \
                < self.collision_rate * dt
            vnew = torch.randn(s.vel.shape, generator=gen,
                               device=s.pos.device) * torch.sqrt(
                KB * T0 / s.mass[:, None])
            return s.replace(vel=torch.where(hit, vnew, s.vel)), xi
        # Nose-Hoover, one chain: d(xi)/dt = (2 KE - dof kB T0) / Q
        dof = 3 * s.n
        Q = dof * KB * T0 * self.tau * self.tau
        xi = xi + dt * (2.0 * kinetic_energy(s) - dof * KB * T0) / Q
        return s.replace(vel=s.vel * torch.exp(-xi * dt)), xi

    def advance(self, carry):
        """One step from a carry (state, force, xi), mutating nothing: the
        step that ``step`` takes (and that a CUDA graph may capture)."""
        s, f, xi = carry
        dt = self.dt
        m = s.mass[:, None]
        if self.integrator == "velocity_verlet":
            v_half = s.vel + 0.5 * dt * (f / m)
            s = s.replace(pos=torch.remainder(s.pos + dt * v_half, s.box))
            f_new, _ = self._force_fn(s)
            s = s.replace(vel=v_half + 0.5 * dt * f_new / m)
            out = f_new
        elif self.integrator == "leapfrog":
            vel = s.vel + dt * f / m
            s = s.replace(pos=torch.remainder(s.pos + dt * vel, s.box),
                          vel=vel)
            f_new, _ = self._force_fn(s)
            out = f_new
        else:  # beeman
            f, f_prev = f
            a, a_prev = f / m, f_prev / m
            pos = torch.remainder(
                s.pos + dt * s.vel + (dt * dt / 6.0) * (4.0 * a - a_prev),
                s.box)
            s = s.replace(pos=pos)
            f_new, _ = self._force_fn(s)
            vel = s.vel + (dt / 6.0) * (2.0 * (f_new / m) + 5.0 * a - a_prev)
            s = s.replace(vel=vel)
            out = (f_new, f)
        s, xi = self._thermostat(s, xi)
        return s, out, xi

    def step(self, n: int = 1, synchronize: bool = True) -> MDState:
        """Take ``n`` steps. With ``synchronize=False`` it returns once the
        steps are enqueued (the host's cost alone)."""
        t0 = time.perf_counter()
        carry = self._carry
        for _ in range(n):
            carry = self.advance(carry)
        self._carry = carry
        self.state = carry[0]
        if synchronize and self.state.pos.is_cuda:
            torch.cuda.synchronize(self.state.pos.device)
        self.metrics["total_time_ms"] += (time.perf_counter() - t0) * 1e3
        self.metrics["num_steps"] += n
        self.step_count += n
        self.time += n * self.dt
        return self.state

    def run(self, n_steps: int, *, callback: Optional[Callable] = None,
            callback_interval: int = 10,
            record_trajectory: bool = False) -> MDState:
        remaining = n_steps
        chunk = callback_interval if (callback or record_trajectory) \
            else n_steps
        while remaining > 0:
            n = min(chunk, remaining)
            self.step(n)
            remaining -= n
            if record_trajectory:
                self.trajectory.append(self.state.pos.cpu().numpy())
            if callback is not None:
                callback(self)
        return self.state

    def energies(self) -> dict:
        _, e = self._force_fn(self.state)
        ke = kinetic_energy(self.state)
        return {
            "kinetic": float(ke),
            "potential": float(e["potential"]),
            "nonbonded": float(e["nonbonded"]),
            "bonded": float(e["bonded"]),
            "total": float(ke + e["potential"]),
        }

    def temperature(self) -> float:
        return float(temperature(self.state))

    def performance_metrics(self) -> dict:
        m = dict(self.metrics)
        steps = max(m["num_steps"], 1)
        m["ms_per_step"] = m["total_time_ms"] / steps
        m["atom_steps_per_second"] = (
            self.state.n * steps / (m["total_time_ms"] / 1e3 or 1e-9))
        return m

    def save_state(self, path: str) -> str:
        """JSON with the JAX package's keys."""
        s = self.state
        payload = {
            "time": self.time, "step_count": self.step_count, "dt": self.dt,
            "integrator": self.integrator,
            **{k: getattr(s, k).cpu().numpy().tolist()
               for k in ("pos", "vel", "mass", "charge", "type_id", "box")},
        }
        with open(path, "w") as fh:
            json.dump(payload, fh)
        return path

    def save_trajectory(self, path: str) -> str:
        """The recorded frames as an ``.npz`` (arr_0, arr_1, ...)."""
        np.savez_compressed(path, *self.trajectory)
        return path
