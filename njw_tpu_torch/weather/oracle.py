"""NumPy oracle for the shallow-water core (``--validate`` and the tests).

A copy of the SWE part of ``njw_tpu/weather/oracle.py`` (the package keeps
its own copy rather than import the JAX package): ``_shift``,
``swe_tendencies_np``, ``diagnostics_np`` and ``SWEOracle``. Written
directly against NumPy, independent of ``dynamics.py``, so that a fault in
the torch path cannot hide in a shared helper. Float32 throughout.
"""
from __future__ import annotations

import numpy as np

F = np.float32


def _shift(f: np.ndarray, delta: int, axis: int, bc: str,
           edge_sign: float = 1.0) -> np.ndarray:
    """g[i] = f[i+delta] with boundary handling. Scalar ghost rule:
    'clamped'/'outflow'/'reflective' all clamp the edge cell (see
    dynamics.scalar_bc); edge_sign=-1 applies the reflective wall-normal
    velocity sign flip."""
    if bc == "periodic":
        return np.roll(f, -delta, axis=axis)
    g = np.empty_like(f)
    src = [slice(None)] * f.ndim
    dst = [slice(None)] * f.ndim
    edge = [slice(None)] * f.ndim
    n = f.shape[axis]
    if delta == 1:
        dst[axis] = slice(0, n - 1)
        src[axis] = slice(1, n)
        edge[axis] = slice(n - 1, n)
        g[tuple(dst)] = f[tuple(src)]
        g[tuple(edge)] = F(edge_sign) * f[tuple(edge)]
    else:
        dst[axis] = slice(1, n)
        src[axis] = slice(0, n - 1)
        edge[axis] = slice(0, 1)
        g[tuple(dst)] = f[tuple(src)]
        g[tuple(edge)] = F(edge_sign) * f[tuple(edge)]
    return g


def d_dx(f, dx, bc):
    return (_shift(f, 1, -1, bc) - _shift(f, -1, -1, bc)) * F(0.5 / dx)


def d_dy(f, dy, bc):
    return (_shift(f, 1, -2, bc) - _shift(f, -1, -2, bc)) * F(0.5 / dy)


def laplacian(f, dx, dy, bc):
    fxx = (_shift(f, 1, -1, bc) - F(2.0) * f + _shift(f, -1, -1, bc)) / F(dx * dx)
    fyy = (_shift(f, 1, -2, bc) - F(2.0) * f + _shift(f, -1, -2, bc)) / F(dy * dy)
    return fxx + fyy


def swe_tendencies_np(u, v, h, *, dx, dy, bc, gravity, coriolis_f,
                      beta=0.0, viscosity=0.0):
    """du/dt, dv/dt, dh/dt per ref: weather_simulation.cpp:530-537."""
    u = u.astype(F, copy=False)
    v = v.astype(F, copy=False)
    h = h.astype(F, copy=False)
    bc_s = "clamped" if bc in ("clamped", "outflow", "reflective") else bc
    if bc == "reflective":
        # wall-normal velocity ghosts flip sign (no-flux walls)
        cxs = F(0.5 / dx)
        cys = F(0.5 / dy)
        u_x = (_shift(u, 1, -1, bc_s, -1.0)
               - _shift(u, -1, -1, bc_s, -1.0)) * cxs
        v_y = (_shift(v, 1, -2, bc_s, -1.0)
               - _shift(v, -1, -2, bc_s, -1.0)) * cys
        u_y = d_dy(u, dy, bc_s)
        v_x = d_dx(v, dx, bc_s)
    else:
        u_x, u_y = d_dx(u, dx, bc_s), d_dy(u, dy, bc_s)
        v_x, v_y = d_dx(v, dx, bc_s), d_dy(v, dy, bc_s)
    h_x, h_y = d_dx(h, dx, bc_s), d_dy(h, dy, bc_s)
    reflective = bc == "reflective"
    bc = bc_s

    ny = u.shape[-2]
    y_norm = (np.arange(ny, dtype=F)[:, None] / F(max(ny - 1, 1)))
    f = F(coriolis_f) + F(beta) * (y_norm - F(0.5))
    g = F(gravity)

    du = -u * u_x - v * u_y - g * h_x + f * v
    dv = -u * v_x - v * v_y - g * h_y - f * u
    dh = -h * (u_x + v_y) - u * h_x - v * h_y
    if viscosity:
        nu = F(viscosity)
        if reflective:
            # velocity laplacians use the same flipped wall-normal ghosts
            def lap_signed(a, sx, sy):
                axx = (_shift(a, 1, -1, bc, sx) - F(2.0) * a
                       + _shift(a, -1, -1, bc, sx)) / F(dx * dx)
                ayy = (_shift(a, 1, -2, bc, sy) - F(2.0) * a
                       + _shift(a, -1, -2, bc, sy)) / F(dy * dy)
                return axx + ayy

            du = du + nu * lap_signed(u, -1.0, 1.0)
            dv = dv + nu * lap_signed(v, 1.0, -1.0)
        else:
            du = du + nu * laplacian(u, dx, dy, bc)
            dv = dv + nu * laplacian(v, dx, dy, bc)
    return du, dv, dh


def diagnostics_np(u, v, *, dx, dy, bc):
    """vorticity = dv/dx - du/dy; divergence = du/dx + dv/dy
    (ref: weather_grid.cpp:82-121)."""
    return (
        d_dx(v, dx, bc) - d_dy(u, dy, bc),
        d_dx(u, dx, bc) + d_dy(v, dy, bc),
    )


class SWEOracle:
    """Step-loop oracle with euler / rk2 / rk4 / adams_bashforth."""

    def __init__(self, *, dx=1.0, dy=1.0, bc="periodic", gravity=9.81,
                 coriolis_f=0.0, beta=0.0, viscosity=0.0):
        self.kw = dict(dx=dx, dy=dy, bc=bc, gravity=gravity,
                       coriolis_f=coriolis_f, beta=beta, viscosity=viscosity)
        self._t_prev = None  # AB2 history

    def tendency(self, state):
        u, v, h = state
        return swe_tendencies_np(u, v, h, **self.kw)

    @staticmethod
    def _axpy(a, k, s):
        a = F(a)
        return tuple(si + a * ki for si, ki in zip(s, k))

    def step(self, state, dt, method="rk4"):
        s = tuple(np.asarray(f, dtype=F) for f in state)
        dt = float(dt)
        if method == "euler":
            return self._axpy(dt, self.tendency(s), s)
        if method == "rk2":
            k1 = self.tendency(s)
            k2 = self.tendency(self._axpy(0.5 * dt, k1, s))
            return self._axpy(dt, k2, s)
        if method == "rk4":
            k1 = self.tendency(s)
            k2 = self.tendency(self._axpy(0.5 * dt, k1, s))
            k3 = self.tendency(self._axpy(0.5 * dt, k2, s))
            k4 = self.tendency(self._axpy(dt, k3, s))
            incr = tuple(
                (a + F(2.0) * b + F(2.0) * c + d) * F(1.0 / 6.0)
                for a, b, c, d in zip(k1, k2, k3, k4)
            )
            return self._axpy(dt, incr, s)
        if method == "adams_bashforth":
            t_now = self.tendency(s)
            t_prev = self._t_prev if self._t_prev is not None else t_now
            incr = tuple(F(1.5) * a - F(0.5) * b for a, b in zip(t_now, t_prev))
            self._t_prev = t_now
            return self._axpy(dt, incr, s)
        raise ValueError(f"unknown method {method!r}")

    def run(self, state, dt, n_steps, method="rk4"):
        self._t_prev = None
        s = tuple(np.asarray(f, dtype=F) for f in state)
        for _ in range(n_steps):
            s = self.step(s, dt, method)
        return s
