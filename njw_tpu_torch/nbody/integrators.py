"""N-body integrators: Euler, leapfrog (kick-drift-kick), velocity Verlet
and RK4, as ``Stepper``s of the weather package's protocol.

Counterpart of ``njw_tpu/nbody/integrators.py``. The leapfrog and Verlet
carries hold the cached acceleration, so each step evaluates the forces
once."""
from __future__ import annotations

import dataclasses

from njw_tpu_torch.nbody.forces import accelerations
from njw_tpu_torch.nbody.system import NBodySystem
from njw_tpu_torch.weather.integrators import Stepper


def _with(s: NBodySystem, **fields) -> NBodySystem:
    return dataclasses.replace(s, **fields)


def euler(acc_fn=accelerations) -> Stepper:
    def step(carry, s, dt):
        a = acc_fn(s)
        return carry, _with(s, pos=s.pos + dt * s.vel, vel=s.vel + dt * a)

    return Stepper(lambda s: (), step, "euler", 1)


def leapfrog(acc_fn=accelerations) -> Stepper:
    """Kick-drift-kick; symplectic. The carry is a(x)."""

    def step(a0, s, dt):
        v_half = s.vel + 0.5 * dt * a0
        pos = s.pos + dt * v_half
        a1 = acc_fn(_with(s, pos=pos))
        vel = v_half + 0.5 * dt * a1
        return a1, _with(s, pos=pos, vel=vel)

    return Stepper(acc_fn, step, "leapfrog", 1)


def verlet(acc_fn=accelerations) -> Stepper:
    """Velocity Verlet: the same update as KDK leapfrog under its own
    name."""
    lf = leapfrog(acc_fn)
    return Stepper(lf.init, lf.step, "verlet", 1)


def rk4(acc_fn=accelerations) -> Stepper:
    """RK4 on the (pos, vel) system."""

    def deriv(s):
        return s.vel, acc_fn(s)

    def step(carry, s, dt):
        k1p, k1v = deriv(s)
        k2p, k2v = deriv(_with(s, pos=s.pos + 0.5 * dt * k1p,
                               vel=s.vel + 0.5 * dt * k1v))
        k3p, k3v = deriv(_with(s, pos=s.pos + 0.5 * dt * k2p,
                               vel=s.vel + 0.5 * dt * k2v))
        k4p, k4v = deriv(_with(s, pos=s.pos + dt * k3p,
                               vel=s.vel + dt * k3v))
        sixth = dt / 6.0
        pos = s.pos + sixth * (k1p + 2 * k2p + 2 * k3p + k4p)
        vel = s.vel + sixth * (k1v + 2 * k2v + 2 * k3v + k4v)
        return carry, _with(s, pos=pos, vel=vel)

    return Stepper(lambda s: (), step, "rk4", 4)


INTEGRATORS = {
    "euler": euler,
    "leapfrog": leapfrog,
    "verlet": verlet,
    "rk4": rk4,
}


def make_nbody_stepper(method: str, acc_fn=accelerations) -> Stepper:
    try:
        return INTEGRATORS[method](acc_fn)
    except KeyError:
        raise ValueError(
            f"unknown integrator {method!r}; available: {sorted(INTEGRATORS)}"
        ) from None
