"""Time integrators as higher-order functions.

Counterpart of ``njw_tpu/weather/integrators.py``. An integrator is a
``Stepper``:

    carry0 = stepper.init(state)
    carry, state = stepper.step(carry, state, dt)

The carry holds multi-step history (AB2) and is an empty tuple for the
single-step methods. The semi-implicit steppers live in
``semi_implicit.py``; ``make_stepper`` hands them out too. The combine arithmetic (order and constants) is the
JAX package's, so the two agree to float32 rounding.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from njw_tpu_torch.weather.grid import FieldState

TendencyFn = Callable  # state -> d(state)/dt


def _axpy(a, x: FieldState, y: FieldState) -> FieldState:
    """y + a * x field-wise, on any state with ``map`` (``WeatherState``,
    ``BarotropicState``, ``PEState``)."""
    return y.map(lambda yi, xi: yi + a * xi, x)


class Stepper(NamedTuple):
    init: Callable  # state -> carry
    step: Callable  # (carry, state, dt) -> (carry, state)
    name: str
    stages: int     # tendency evaluations per step


def euler(tendency: TendencyFn) -> Stepper:
    """Explicit Euler."""

    def step(carry, s, dt):
        return carry, _axpy(dt, tendency(s), s)

    return Stepper(lambda s: (), step, "euler", 1)


def rk2(tendency: TendencyFn) -> Stepper:
    """Midpoint RK2."""

    def step(carry, s, dt):
        k1 = tendency(s)
        mid = _axpy(0.5 * dt, k1, s)
        k2 = tendency(mid)
        return carry, _axpy(dt, k2, s)

    return Stepper(lambda s: (), step, "rk2", 2)


def rk4(tendency: TendencyFn) -> Stepper:
    """Classic RK4: s + dt * (k1 + 2 k2 + 2 k3 + k4) / 6."""

    def step(carry, s, dt):
        k1 = tendency(s)
        k2 = tendency(_axpy(0.5 * dt, k1, s))
        k3 = tendency(_axpy(0.5 * dt, k2, s))
        k4 = tendency(_axpy(dt, k3, s))
        incr = k1.map(
            lambda a, b, c, d: (a + 2.0 * b + 2.0 * c + d) * (1.0 / 6.0),
            k2, k3, k4,
        )
        return carry, _axpy(dt, incr, s)

    return Stepper(lambda s: (), step, "rk4", 4)


def ab2(tendency: TendencyFn) -> Stepper:
    """2nd-order Adams-Bashforth, s' = s + dt (3/2 T_n - 1/2 T_{n-1}),
    bootstrapped with T_{-1} := T_0 (the first step is Euler)."""

    def init(s):
        return tendency(s)  # carry = previous tendency

    def step(t_prev, s, dt):
        t_now = tendency(s)
        incr = t_now.map(lambda a, b: 1.5 * a - 0.5 * b, t_prev)
        return t_now, _axpy(dt, incr, s)

    return Stepper(init, step, "ab2", 1)


def rk4_lists(tendency: Callable, states: list, dt: float,
              n_steps: int) -> list:
    """``n_steps`` RK4 steps of a list of states (the shards this process
    holds) under ``tendency(list) -> list``, in the JAX sharded steppers'
    arithmetic: s + (dt / 6) (k1 + 2 k2 + 2 k3 + k4), with 0.5 dt and
    dt / 6 rounded to float32. A whole-domain run is a list of one."""
    f32 = np.float32
    dt = float(f32(dt))
    half = float(f32(0.5) * f32(dt))
    sixth = float(f32(dt) / f32(6.0))

    def ax(a, ks):
        return [s.map(lambda x, y: x + a * y, k) for s, k in zip(states, ks)]

    for _ in range(n_steps):
        k1 = tendency(states)
        k2 = tendency(ax(half, k1))
        k3 = tendency(ax(half, k2))
        k4 = tendency(ax(dt, k3))
        comb = [a.map(lambda w, x, y, z: w + 2 * x + 2 * y + z, b, c, d)
                for a, b, c, d in zip(k1, k2, k3, k4)]
        states = ax(sixth, comb)
    return states


class ListRK4:
    """``step(states, dt) -> states``: ``n_steps`` steps of ``rk4_lists``
    under ``tendency`` (a list of the local shards' states -> their
    tendencies): the stepper of the sharded spectral and icosahedral
    cores."""

    stages = 4

    def __init__(self, name: str, tendency: Callable, n_steps: int):
        self.name = name
        self.tendency = tendency
        self.n_steps = n_steps

    def __call__(self, states: list, dt: float) -> list:
        return rk4_lists(self.tendency, states, dt, self.n_steps)


INTEGRATORS: dict[str, Callable[[TendencyFn], Stepper]] = {
    "euler": euler,
    "rk2": rk2,
    "rk4": rk4,
    "adams_bashforth": ab2,
}


def make_stepper(method: str, tendency: TendencyFn, **kwargs) -> Stepper:
    """Look up an integrator by name. ``semi_implicit`` needs the linear
    split and a spectral solve, so it is built by
    :mod:`njw_tpu_torch.weather.semi_implicit` (the shallow-water stepper,
    from ``grid``, ``params`` and ``order`` in ``kwargs``); the registry
    holds the four explicit methods."""
    if method == "semi_implicit":
        from njw_tpu_torch.weather.semi_implicit import semi_implicit_swe

        return semi_implicit_swe(tendency, **kwargs)
    try:
        return INTEGRATORS[method](tendency)
    except KeyError:
        raise ValueError(
            f"unknown integration method {method!r}; "
            f"available: {sorted(INTEGRATORS) + ['semi_implicit']}"
        ) from None
