"""Icosahedral-grid shallow water.

Counterpart of ``njw_tpu/weather/icosa.py``:

* The sphere is cut into the 10 rhombic panels of the icosahedron; fields
  are stored structured, ``(10, n, n)`` cell-centred, so every stencil is
  a slice. Cell-centred storage keeps every cell at exactly 4 edge
  neighbours (the 12 vertices are cell corners).
* The halo exchange between panels is 8 slice copies (``pad_halo``): the
  5-fold symmetry maps panel k's edges to panels k +- 1.
* The operators are least-squares tangent-plane reconstructions with
  weights precomputed per cell (float64 NumPy at set-up): exact for
  linear fields, four multiply-adds over shifted slabs at run time.
* The dynamics use the Cartesian vector-velocity method: velocity is a 3-
  vector constrained to the tangent plane, so panel edges need no vector
  rotation and the Coriolis term is ``-2 Omega x V``; the tendencies are
  projected on the tangent plane, and any RK combination stays tangent.

Each operator needing a halo is written once as a generator that yields
the field to pad and receives it padded (``_gradient``, ``_divergence``,
``_tendency_parts``). The whole-domain functions drive it with ``pad``
(``pad_halo`` by default); the panel-pair sharded stepper
(``njw_tpu_torch.parallel.icosa``) drives one generator a shard in
lockstep and pads them together with two ring exchanges.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar

import numpy as np
import torch

from njw_tpu_torch.weather.grid import FieldState

EARTH_RADIUS = 6.37122e6
EARTH_OMEGA = 7.292e-5


# --------------------------------------------------------------------------
# Geometry (NumPy, set-up time)
# --------------------------------------------------------------------------

def _base_vertices():
    lat = np.arctan(0.5)
    N = np.array([0.0, 0.0, 1.0])
    U = [np.array([np.cos(lat) * np.cos(2 * np.pi * k / 5),
                   np.cos(lat) * np.sin(2 * np.pi * k / 5),
                   np.sin(lat)]) for k in range(5)]
    L = [np.array([np.cos(lat) * np.cos(2 * np.pi * (k + 0.5) / 5),
                   np.cos(lat) * np.sin(2 * np.pi * (k + 0.5) / 5),
                   -np.sin(lat)]) for k in range(5)]
    return N, -N, U, L


def panel_vertices(n: int) -> np.ndarray:
    """(10, n+1, n+1, 3) unit vertices by recursive great-circle bisection
    (n a power of 2). Northern panel k corners: (0,0)=N, (n,0)=U_k,
    (0,n)=U_{k+1}, (n,n)=L_k; southern panel k: (0,0)=U_{k+1}, (n,0)=L_k,
    (0,n)=L_{k+1}, (n,n)=S. The subdivision diagonal is the anti-diagonal,
    the icosahedron's edge U_k-U_{k+1}."""
    if n & (n - 1):
        raise ValueError(f"icosahedral n must be a power of 2, got {n}")
    N, S, U, L = _base_vertices()
    corners = [(N, U[k], U[(k + 1) % 5], L[k]) for k in range(5)]
    corners += [(U[(k + 1) % 5], L[k], L[(k + 1) % 5], S) for k in range(5)]
    out = np.zeros((10, n + 1, n + 1, 3))
    for p, (c00, c10, c01, c11) in enumerate(corners):
        V = np.zeros((2, 2, 3))
        V[0, 0], V[1, 0], V[0, 1], V[1, 1] = c00, c10, c01, c11
        m = 1
        while m < n:
            W = np.zeros((2 * m + 1, 2 * m + 1, 3))
            W[::2, ::2] = V
            W[1::2, ::2] = V[:-1, :] + V[1:, :]
            W[::2, 1::2] = V[:, :-1] + V[:, 1:]
            W[1::2, 1::2] = V[1:, :-1] + V[:-1, 1:]
            W /= np.linalg.norm(W, axis=-1, keepdims=True)
            V, m = W, 2 * m
        out[p] = V
    return out


def cell_centers(n: int) -> np.ndarray:
    """(10, n, n, 3) unit cell centres (normalised quad-vertex means)."""
    v = panel_vertices(n)
    c = v[:, :-1, :-1] + v[:, 1:, :-1] + v[:, :-1, 1:] + v[:, 1:, 1:]
    return c / np.linalg.norm(c, axis=-1, keepdims=True)


# --------------------------------------------------------------------------
# Halo exchange: 8 slice copies
# --------------------------------------------------------------------------

def _fill_halo(p, f, roll) -> None:
    """Write the 8 edge maps of ``f`` (10, n, n, ...) into the padded
    ``p`` (10, n+2, n+2, ...) in place (corner slots unused)."""
    n = f.shape[1]
    fN, fS = f[:5], f[5:]
    rN1 = roll(fN, 1)    # panel k-1 -> slot k
    rNm1 = roll(fN, -1)  # panel k+1 -> slot k
    rS1 = roll(fS, 1)
    rSm1 = roll(fS, -1)
    p[:5, 1:-1, 0] = rN1[:, 0, :]        # (i,-1) = N_{k-1}(0,i)
    p[:5, 0, 1:-1] = rNm1[:, :, 0]       # (-1,j) = N_{k+1}(j,0)
    p[:5, -1, 1:-1] = rS1[:, 0, :]       # (n,j)  = S_{k-1}(0,j)
    p[:5, 1:-1, -1] = fS[:, :, 0]        # (i,n)  = S_k(i,0)
    p[5:, 0, 1:-1] = rNm1[:, n - 1, :]   # (-1,j) = N_{k+1}(n-1,j)
    p[5:, 1:-1, 0] = fN[:, :, n - 1]     # (i,-1) = N_k(i,n-1)
    p[5:, -1, 1:-1] = rS1[:, :, n - 1]   # (n,j)  = S_{k-1}(j,n-1)
    p[5:, 1:-1, -1] = rSm1[:, n - 1, :]  # (i,n)  = S_{k+1}(n-1,i)


def pad_halo(f: torch.Tensor) -> torch.Tensor:
    """(10, n, n, ...) -> a new (10, n+2, n+2, ...) with one-cell edge
    halos from the four neighbouring panels, built once and filled by
    slices; the corner slots are 0 (the 4-neighbour stencil reads none)."""
    n = f.shape[1]
    p = f.new_zeros((10, n + 2, n + 2) + tuple(f.shape[3:]))
    p[:, 1:-1, 1:-1] = f
    _fill_halo(p, f, lambda a, k: torch.roll(a, k, 0))
    return p


def pad_halo_np(f: np.ndarray) -> np.ndarray:
    """``pad_halo`` for NumPy arrays (the operators' set-up)."""
    n = f.shape[1]
    p = np.zeros((10, n + 2, n + 2) + f.shape[3:], f.dtype)
    p[:, 1:-1, 1:-1] = f
    _fill_halo(p, f, lambda a, k: np.roll(a, k, 0))
    return p


def _shift_slabs(p):
    """The 4 edge-neighbour slabs of a padded array: i+1, i-1, j+1, j-1."""
    return (p[:, 2:, 1:-1], p[:, :-2, 1:-1], p[:, 1:-1, 2:], p[:, 1:-1, :-2])


# --------------------------------------------------------------------------
# Least-squares tangent-plane operators
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IcosaOperators:
    """The per-cell geometry. ``radius`` is a 0-d float32 tensor, as the
    JAX package's (its arithmetic with Python floats stays float32)."""

    w: torch.Tensor       # (4, 10, n, n, 3) LSQ gradient weights
    r: torch.Tensor       # (10, n, n, 3) unit radial = cell centres
    east: torch.Tensor    # (10, n, n, 3) local east basis
    north: torch.Tensor   # (10, n, n, 3) local north basis
    radius: torch.Tensor  # () sphere radius (m)

    @property
    def n(self) -> int:
        return self.r.shape[1]

    @property
    def device(self) -> torch.device:
        return self.r.device

    def map(self, fn) -> "IcosaOperators":
        return IcosaOperators(**{f.name: fn(f.name, getattr(self, f.name))
                                 for f in dataclasses.fields(self)})


def build_operators(n: int, radius: float = EARTH_RADIUS,
                    device="cuda") -> IcosaOperators:
    """LSQ gradient weights: per cell, fit
    ``f_e - f_c ~= a (d_e . e1) + b (d_e . e2) + beta (d_e . r)`` over the
    4 edge chords d_e and return grad f = a e1 + b e2. The radial column
    absorbs the chords' O(h^2) curvature, so the gradient is exact for
    linear functions of the embedding coordinates and 2nd order for smooth
    fields. float64 NumPy, then float32 on ``device``."""
    from njw_tpu_torch.platform.device import require_device

    device = require_device(device)
    c = cell_centers(n)
    pc = pad_halo_np(c)
    nbrs = np.stack([pc[:, 2:, 1:-1], pc[:, :-2, 1:-1],
                     pc[:, 1:-1, 2:], pc[:, 1:-1, :-2]])  # (4,10,n,n,3)
    d = (nbrs - c) * radius
    r = c

    z = np.array([0.0, 0.0, 1.0])
    east = np.cross(z, c)
    east /= np.maximum(np.linalg.norm(east, axis=-1, keepdims=True), 1e-12)
    north = np.cross(c, east)

    # (10, n, n, 4, 3) design matrix in the (east, north, radial) basis
    A = np.stack([np.einsum("e...i,...i->...e", d, east),
                  np.einsum("e...i,...i->...e", d, north),
                  np.einsum("e...i,...i->...e", d, r)], -1)
    AtA = np.einsum("...ei,...ej->...ij", A, A)
    W = np.einsum("...ij,...ej->...ie", np.linalg.inv(AtA), A)
    # the tangential rows only; the curvature (beta) row is dropped
    w = (np.einsum("...e,...i->e...i", W[..., 0, :], east)
         + np.einsum("...e,...i->e...i", W[..., 1, :], north))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return IcosaOperators(w=f32(w), r=f32(c), east=f32(east),
                          north=f32(north),
                          radius=torch.tensor(radius, dtype=torch.float32,
                                              device=device))


def _drive(gen, pad: Callable):
    """Run an operator generator on the whole domain, padding each field
    it yields with ``pad``."""
    try:
        x = next(gen)
        while True:
            x = gen.send(pad(x))
    except StopIteration as done:
        return done.value


def _gradient(f, ops: IcosaOperators):
    p = yield f
    out = torch.zeros(f.shape + (3,), dtype=f.dtype, device=f.device)
    for e, s in enumerate(_shift_slabs(p)):
        out = out + ops.w[e] * (s - f)[..., None]
    return out


def _gradient_vec(V, ops: IcosaOperators):
    p = yield V
    out = torch.zeros(V.shape + (3,), dtype=V.dtype, device=V.device)
    for e, s in enumerate(_shift_slabs(p)):
        out = out + ops.w[e][..., None, :] * (s - V)[..., :, None]
    return out


def _divergence(V, ops: IcosaOperators):
    p = yield V
    out = torch.zeros(V.shape[:-1], dtype=V.dtype, device=V.device)
    for e, s in enumerate(_shift_slabs(p)):
        out = out + torch.sum(ops.w[e] * (s - V), -1)
    return out


def _laplacian(f, ops: IcosaOperators):
    g = yield from _gradient(f, ops)
    return (yield from _divergence(g, ops))


def gradient(f, ops: IcosaOperators, pad: Callable = pad_halo):
    """Tangential gradient of a scalar: (P, n, n) -> (P, n, n, 3); ``pad``
    the halo exchange of one field."""
    return _drive(_gradient(f, ops), pad)


def gradient_vec(V, ops: IcosaOperators, pad: Callable = pad_halo):
    """Per-component gradient of a 3-vector field:
    (P, n, n, 3) -> (P, n, n, 3 components, 3 directions)."""
    return _drive(_gradient_vec(V, ops), pad)


def divergence(V, ops: IcosaOperators, pad: Callable = pad_halo):
    """LSQ divergence: (P, n, n, 3) -> (P, n, n)."""
    return _drive(_divergence(V, ops), pad)


def laplacian(f, ops: IcosaOperators, pad: Callable = pad_halo):
    """div(grad f): two halo exchanges; the explicit diffusion."""
    return _drive(_laplacian(f, ops), pad)


# --------------------------------------------------------------------------
# Shallow water in Cartesian vector form
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IcosaSWEState(FieldState):
    FIELDS: ClassVar[tuple[str, ...]] = ("V", "h")

    V: torch.Tensor  # (P, n, n, 3) tangent Cartesian velocity (m/s)
    h: torch.Tensor  # (P, n, n) fluid depth (m)


def _tendency_parts(s: IcosaSWEState, ops: IcosaOperators, g: float,
                    omega: float, nu: float):
    """dV/dt = P[-(V.grad)V - g grad h - 2 Omega x V], P = I - r r^T;
    dh/dt = -(h div V + V . grad h). The projection P absorbs the
    constraint force; r is fixed per cell, so RK combinations of projected
    tendencies stay tangent."""
    V, h = s.V, s.h
    gh = yield from _gradient(h, ops)
    gV = yield from _gradient_vec(V, ops)
    adv = torch.einsum("...d,...cd->...c", V, gV)
    zxV = torch.stack([-V[..., 1], V[..., 0], torch.zeros_like(V[..., 0])],
                      -1)
    dV = -adv - g * gh - (2.0 * omega) * zxV
    dV = dV - torch.sum(dV * ops.r, -1, keepdim=True) * ops.r
    divV = yield from _divergence(V, ops)
    dh = -(h * divV + torch.sum(V * gh, -1))
    if nu:
        lapV = []
        for i in range(3):
            lapV.append((yield from _laplacian(V[..., i], ops)))
        dV = dV + nu * torch.stack(lapV, -1)
        dh = dh + nu * (yield from _laplacian(h, ops))
    return IcosaSWEState(V=dV, h=dh)


def swe_tendencies_icosa(s: IcosaSWEState, ops: IcosaOperators,
                         g: float = 9.80616, omega: float = EARTH_OMEGA,
                         nu: float = 0.0,
                         pad: Callable = pad_halo) -> IcosaSWEState:
    return _drive(_tendency_parts(s, ops, g, omega, nu), pad)


def advection_tendency(q, V, ops: IcosaOperators):
    """Passive-scalar advection dq/dt = -V . grad q (Williamson TC1)."""
    return -torch.sum(V * gradient(q, ops), -1)


# --------------------------------------------------------------------------
# Initial conditions (Williamson et al. 1992)
# --------------------------------------------------------------------------

def solid_body_velocity(ops: IcosaOperators, u0: float) -> torch.Tensor:
    """V = u0 (z x r): solid-body rotation about the polar axis."""
    r = ops.r
    return u0 * torch.stack([-r[..., 1], r[..., 0],
                             torch.zeros_like(r[..., 0])], -1)


def williamson2_icosa(ops: IcosaOperators, omega: float = EARTH_OMEGA,
                      g: float = 9.80616,
                      u0: float = 2.0 * np.pi * EARTH_RADIUS / (12 * 86400),
                      gh0: float = 2.94e4) -> IcosaSWEState:
    """TC2 steady zonal geostrophic flow:
    gh = gh0 - (a Omega u0 + u0^2/2) sin^2(lat)."""
    a = ops.radius
    mu = ops.r[..., 2]
    gh = gh0 - (a * omega * u0 + 0.5 * u0 * u0) * mu * mu
    return IcosaSWEState(V=solid_body_velocity(ops, u0), h=gh / g)


def gaussian_hill(ops: IcosaOperators, lon0: float = 0.0,
                  lat0: float = 0.0, width: float = 0.3) -> torch.Tensor:
    """Unit-amplitude Gaussian bump at (lon0, lat0); width in radians of
    great-circle arc."""
    x0 = np.array([np.cos(lat0) * np.cos(lon0),
                   np.cos(lat0) * np.sin(lon0), np.sin(lat0)])
    d2 = torch.sum((ops.r - torch.as_tensor(x0, dtype=torch.float32,
                                            device=ops.device)) ** 2, -1)
    return torch.exp(-d2 / float(np.float32(width ** 2)))


def uv_from_cartesian(V, ops: IcosaOperators):
    """The Cartesian velocity on the local (east, north) basis."""
    return torch.sum(V * ops.east, -1), torch.sum(V * ops.north, -1)


# --------------------------------------------------------------------------
# Simulation wiring
# --------------------------------------------------------------------------

def make_icosa_sim(sim_cls, config, initial_condition: str, *, device,
                   **ic_params):
    """A Simulation on the icosahedral grid: ``config.grid_height`` = n
    (cells per rhombus edge, a power of 2), 10 n^2 cells. Model
    shallow_water (or general); IC 'williamson2' (aliases zonal, uniform,
    default, vortex) or 'gaussian' (TC2's flow carrying a Gaussian height
    anomaly)."""
    n = config.grid_height
    omega = float(ic_params.pop("omega", EARTH_OMEGA))
    radius = float(ic_params.pop("radius", EARTH_RADIUS))
    g = config.gravity or 9.80616
    nu = config.viscosity
    if config.model not in ("shallow_water", "general"):
        raise ValueError("icosahedral grid implements the shallow_water "
                         f"core (got model={config.model!r})")
    ops = build_operators(n, radius=radius, device=device)

    if initial_condition in ("williamson2", "zonal", "uniform", "default",
                             "vortex"):
        state0 = williamson2_icosa(ops, omega=omega, g=g, **ic_params)
    elif initial_condition == "gaussian":
        base = williamson2_icosa(ops, omega=omega, g=g)
        amp = float(ic_params.pop("amplitude", 100.0))
        state0 = IcosaSWEState(
            V=base.V, h=base.h + amp * gaussian_hill(ops, **ic_params))
    else:
        raise ValueError(
            f"unknown icosahedral IC {initial_condition!r} "
            "(use williamson2 | gaussian)")

    def tendency(s):
        return swe_tendencies_icosa(s, ops, g=g, omega=omega, nu=nu)

    def output_fn(s):
        u, v = uv_from_cartesian(s.V, ops)
        return {"h": s.h, "u": u, "v": v}

    sim = sim_cls(state0, tendency, dt=config.dt,
                  method=config.integration_method, grid=None,
                  output_fn=output_fn)
    sim.config = config
    sim.icosa_ops = ops
    return sim
