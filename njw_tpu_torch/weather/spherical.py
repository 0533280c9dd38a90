"""Global spectral dynamical cores on the sphere (spherical harmonics).

Counterpart of ``njw_tpu/weather/spherical.py``: the spectral transform
method with two cores,

* the barotropic vorticity equation (BVE): prognostic spectral relative
  vorticity; a Rossby-Haurwitz wave rotates exactly;
* spherical shallow water in vorticity-divergence-geopotential form,
  held to Williamson et al. (1992) test case 2 (steady geostrophic flow).

All run-time work is rfft plus one batched product per Legendre table
(``njw_tpu_torch.ops.sht``); the nonlinear products are formed on the
Gaussian grid. The states hold complex64 spectral tensors.
``pack_state`` / ``unpack_state`` convert to and from the JAX package's
(2, ...) float pairs (its states cross its jit boundaries packed); the
packing is linear, so an RK step of either is the same step.

Each tendency is written once as a generator (``_bve_parts``,
``_swe_parts``): it yields its quadrature partial sums (the analysis
contractions over the latitudes it holds) and receives them summed over
all latitudes. The whole-domain tendency hands them straight back; the
latitude-sharded stepper (``njw_tpu_torch.parallel.sphere``) sums them
across its shards first, the counterpart of the JAX package's psum.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from njw_tpu_torch.ops.sht import SphericalHarmonicTransform
from njw_tpu_torch.weather.grid import FieldState
from njw_tpu_torch.weather.integrators import Stepper

EARTH_RADIUS = 6.371e6       # m
EARTH_OMEGA = 7.292e-5       # rad/s


@dataclasses.dataclass(frozen=True)
class SphericalBarotropicState(FieldState):
    FIELDS: ClassVar[tuple[str, ...]] = ("zeta",)

    zeta: torch.Tensor  # packed spectral relative vorticity (T+1, T+2)


@dataclasses.dataclass(frozen=True)
class SphericalSWEState(FieldState):
    FIELDS: ClassVar[tuple[str, ...]] = ("zeta", "div", "phi")

    zeta: torch.Tensor  # spectral relative vorticity
    div: torch.Tensor   # spectral divergence
    phi: torch.Tensor   # spectral geopotential g h


def pack_state(s):
    """Complex spectral state -> the JAX package's (2, ...) float pairs."""
    return s.map(lambda a: torch.stack([a.real, a.imag]))


def unpack_state(p):
    """Inverse of pack_state."""
    return p.map(lambda a: torch.complex(a[0], a[1]))


def coriolis_spectral(sht: SphericalHarmonicTransform, omega: float):
    """f = 2 Omega mu is proportional to Y_1^0: its exact coefficient."""
    a = torch.zeros(sht.spec_shape, dtype=sht.cdtype, device=sht.device)
    a[0, 1] = 2.0 * omega / np.sqrt(3.0)   # mu = Pbar_1^0 / sqrt(3)
    return a


def _drive(parts):
    """Run a tendency generator on the whole domain: its quadrature
    partials are already the sums."""
    partial = next(parts)
    try:
        parts.send(partial)
    except StopIteration as done:
        return done.value
    raise RuntimeError("a tendency yields its partials once")


def _bve_parts(s: SphericalBarotropicState, sht, omega: float, nu4: float):
    """d zeta / dt = -div((zeta + f) V), V nondivergent from psi. Every
    quantity against one table goes through one stacked contraction."""
    zeta = s.zeta
    psi = sht.inverse_laplacian(zeta)
    inv_a = 1.0 / sht.radius

    Fp = sht.syn_stack(torch.stack([sht.d_dlon(psi), zeta]), "P")
    Fh = sht.syn_stack(psi[None], "H")
    FU = -Fh[0] * inv_a                      # chi = 0 for the BVE
    FV = Fp[0] * inv_a
    G = sht.to_grid(torch.stack([FU, FV, Fp[1]]))
    U, V, zeta_g = G[0], G[1], G[2]

    eta = zeta_g + 2.0 * omega * sht.grid_of_mu()
    F = sht.fourier(torch.stack([U * eta, V * eta]))
    Dp, Dh = yield (sht.anal_stack((F[0] * sht.im)[None], "Pw_over_c2"),
                    sht.anal_stack(F[1][None], "Hw_over_c2"))
    dzeta = -sht.masked((Dp[0] - Dh[0]) * inv_a)
    if nu4:
        dzeta = dzeta - nu4 * (sht.lap ** 2) * zeta
    return SphericalBarotropicState(zeta=dzeta)


def _swe_parts(s: SphericalSWEState, sht, omega: float, nu4: float):
    """Vector-invariant spherical shallow water (Williamson et al. 1992):

        d zeta/dt = -div(eta V)
        d div /dt =  curl(eta V) - Lap(Phi + (u^2+v^2)/2)
        d Phi /dt = -div(Phi V)

    with eta = zeta + f, Phi = g h (flat bottom), every product on the
    grid: one stacked contraction per table (five table reads) and one
    batched FFT each way."""
    psi = sht.inverse_laplacian(s.zeta)
    chi = sht.inverse_laplacian(s.div)
    inv_a = 1.0 / sht.radius

    Fp = sht.syn_stack(torch.stack([sht.d_dlon(chi), sht.d_dlon(psi),
                                    s.zeta, s.phi]), "P")
    Fh = sht.syn_stack(torch.stack([psi, chi]), "H")
    FU = (Fp[0] - Fh[0]) * inv_a
    FV = (Fp[1] + Fh[1]) * inv_a
    G = sht.to_grid(torch.stack([FU, FV, Fp[2], Fp[3]]))
    U, V, zeta_g, phi_g = G[0], G[1], G[2], G[3]

    eta = zeta_g + 2.0 * omega * sht.grid_of_mu()
    inv_c2 = 1.0 / sht.cos_lat() ** 2
    energy = 0.5 * (U * U + V * V) * inv_c2

    F = sht.fourier(torch.stack([U * eta, V * eta, U * phi_g, V * phi_g,
                                 energy]))
    im = sht.im
    Dp, Dh, E = yield (
        sht.anal_stack(torch.stack([F[0] * im, F[1] * im, F[2] * im]),
                       "Pw_over_c2"),
        sht.anal_stack(torch.stack([F[1], F[0], F[3]]), "Hw_over_c2"),
        sht.anal_stack(F[4][None], "Pw"))

    div_eta = sht.masked((Dp[0] - Dh[0]) * inv_a)
    curl_eta = sht.masked((Dp[1] + Dh[1]) * inv_a)
    div_phi = sht.masked((Dp[2] - Dh[2]) * inv_a)
    e_spec = sht.masked(E[0])

    dzeta = -div_eta
    ddiv = curl_eta - sht.laplacian(s.phi + e_spec)
    dphi = -div_phi
    if nu4:
        damp = nu4 * (sht.lap ** 2)
        dzeta = dzeta - damp * s.zeta
        ddiv = ddiv - damp * s.div
        dphi = dphi - damp * s.phi
    return SphericalSWEState(zeta=dzeta, div=ddiv, phi=dphi)


TENDENCY_PARTS = {"bve": _bve_parts, "swe": _swe_parts}


def bve_tendencies(s: SphericalBarotropicState, sht, omega: float,
                   nu4: float = 0.0) -> SphericalBarotropicState:
    return _drive(_bve_parts(s, sht, omega, nu4))


def swe_tendencies(s: SphericalSWEState, sht, omega: float,
                   nu4: float = 0.0) -> SphericalSWEState:
    return _drive(_swe_parts(s, sht, omega, nu4))


# -- initial conditions ------------------------------------------------------

def rossby_haurwitz_bve(sht, m: int = 4, n: int = 5,
                        amplitude: float = 8.0e-5):
    """Single-harmonic Rossby-Haurwitz vorticity: an exact solution of the
    nonlinear BVE that retrogresses at angular rate -2 Omega / (n (n+1))."""
    return SphericalBarotropicState(zeta=sht.spectral_mode(m, n, amplitude))


def williamson2_state(sht, omega: float, *, u0: float = 2.0 * np.pi
                      * EARTH_RADIUS / (12.0 * 86400.0),
                      gh0: float = 2.94e4):
    """Williamson et al. (1992) TC2, steady zonal geostrophic flow:
    u = u0 cos(lat), v = 0, gh = gh0 - (a Omega u0 + u0^2/2) sin^2(lat);
    zeta = (2 u0 / a) sin(lat), div = 0."""
    a = sht.radius
    mu = sht.grid_of_mu()
    zeta_g = (2.0 * u0 / a) * mu
    phi_g = gh0 - (a * omega * u0 + 0.5 * u0 * u0) * mu * mu
    return SphericalSWEState(
        zeta=sht.analysis(zeta_g),
        div=torch.zeros(sht.spec_shape, dtype=sht.cdtype, device=sht.device),
        phi=sht.analysis(phi_g))


def rossby_haurwitz_swe(sht, omega: float, *, R: int = 4,
                        K: float = 7.848e-6, gh0: float = 9.80616 * 8000.0):
    """Williamson TC6: the wavenumber-4 Rossby-Haurwitz SWE state
    (Williamson et al. 1992, eqs 141-149), made in float64 NumPy."""
    a = sht.radius
    mu = np.asarray(sht.mu)
    coslat = np.cos(np.arcsin(mu))[:, None]
    lam = np.asarray(sht.lons)[None, :]
    w = K  # the same rotational amplitude for the zonal part

    zeta_g = (2.0 * w * mu[:, None]
              - K * mu[:, None] * coslat ** R
              * (R * R + 3.0 * R + 2.0) * np.cos(R * lam))
    c2 = coslat ** 2
    A = (w / 2.0 * (2.0 * omega + w) * c2
         + 0.25 * K * K * coslat ** (2 * R)
         * ((R + 1.0) * c2 + (2.0 * R * R - R - 2.0)
            - 2.0 * R * R / np.maximum(c2, 1e-12)))
    B = (2.0 * (omega + w) * K / ((R + 1.0) * (R + 2.0)) * coslat ** R
         * ((R * R + 2.0 * R + 2.0) - (R + 1.0) ** 2 * c2))
    C = 0.25 * K * K * coslat ** (2 * R) * ((R + 1.0) * c2 - (R + 2.0))
    phi_g = gh0 + a * a * (A + B * np.cos(R * lam) + C * np.cos(2 * R * lam))

    def grid(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(sht.device)

    return SphericalSWEState(
        zeta=sht.analysis(grid(zeta_g)),
        div=torch.zeros(sht.spec_shape, dtype=sht.cdtype, device=sht.device),
        phi=sht.analysis(grid(phi_g)))


def semi_implicit_spherical_swe(sht, omega: float, *, phi_ref: float,
                                nu4: float = 0.0, order: int = 1) -> Stepper:
    """Crank-Nicolson gravity-wave stepper for the spectral SWE: the
    linearised pair (L_div = -Lap Phi, L_phi = -phi_ref div) is
    trapezoidal and its Helmholtz solve is one divide per coefficient by
    (1 - a^2 lap phi_ref). order 2: the nonlinear terms at a CN-predicted
    midpoint (one more tendency a step)."""
    lap = sht.lap  # (T+1, T+2) real eigenvalues, <= 0

    def nonlin(s: SphericalSWEState):
        full = swe_tendencies(s, sht, omega, nu4)
        return SphericalSWEState(zeta=full.zeta,
                                 div=full.div - (-lap * s.phi),
                                 phi=full.phi - (-phi_ref * s.div))

    def advance(s: SphericalSWEState, n_val, dt_eff):
        a = 0.5 * dt_eff
        zeta_s = s.zeta + dt_eff * n_val.zeta
        div_s = s.div + dt_eff * n_val.div + a * (-lap * s.phi)
        phi_s = s.phi + dt_eff * n_val.phi + a * (-phi_ref * s.div)
        denom = 1.0 - (a * a) * lap * phi_ref
        div_n = (div_s - a * lap * phi_s) / denom
        phi_n = phi_s - a * phi_ref * div_n
        return SphericalSWEState(zeta=zeta_s, div=div_n, phi=phi_n)

    def step(carry, s: SphericalSWEState, dt):
        n0 = nonlin(s)
        if order == 1:
            return carry, advance(s, n0, dt)
        s_mid = advance(s, n0, 0.5 * dt)
        return carry, advance(s, nonlin(s_mid), dt)

    return Stepper(lambda s: (), step, "semi_implicit", 2)


# -- Simulation wiring -------------------------------------------------------

def make_spherical_sim(sim_cls, config, initial_condition: str, *, device,
                       **ic_params):
    """A Simulation on the spherical-harmonic grid. ``config.model``:
    'barotropic' -> BVE, 'shallow_water' / 'general' -> spectral SWE.
    grid_height = nlat, grid_width = nlon = 2 nlat. Earth's constants by
    default; ``ic_params`` radius= / omega= / nu4= / fold_parity= override
    them."""
    nlat = config.grid_height
    nlon = config.grid_width
    if nlon != 2 * nlat:
        raise ValueError(
            f"spherical_harmonic grid needs grid_width == 2*grid_height "
            f"(got {nlon} x {nlat})")
    if config.boundary_condition != "periodic":
        raise ValueError("the sphere has no boundaries: bc must stay "
                         "'periodic' for grid_type='spherical_harmonic'")
    radius = float(ic_params.pop("radius", EARTH_RADIUS))
    omega = float(ic_params.pop("omega", EARTH_OMEGA))
    nu4 = float(ic_params.pop("nu4", 0.0))
    fold = ic_params.pop("fold_parity", None)  # None: by size
    table_dtype = ic_params.pop("table_dtype", None)
    sht = SphericalHarmonicTransform(nlat, radius=radius, fold_parity=fold,
                                     table_dtype=table_dtype, device=device)

    model = config.model
    if model == "barotropic":
        if initial_condition in ("rossby_haurwitz", "uniform", "default"):
            state0 = rossby_haurwitz_bve(sht, **ic_params)
        elif initial_condition == "random":
            gen = torch.Generator().manual_seed(config.random_seed)
            zg = 1e-5 * torch.randn((nlat, nlon), generator=gen)
            state0 = SphericalBarotropicState(
                zeta=sht.analysis(zg.to(device)))
        else:
            raise ValueError(
                f"unknown spherical barotropic IC {initial_condition!r} "
                "(use rossby_haurwitz | random)")

        def tendency(s):
            return bve_tendencies(s, sht, omega, nu4)

        def output_fn(s):
            psi = sht.inverse_laplacian(s.zeta)
            U, V = sht.uv_from_psi_chi(psi, torch.zeros_like(psi))
            c = sht.cos_lat()
            return {"zeta": sht.synthesis(s.zeta), "psi": sht.synthesis(psi),
                    "u": U / c, "v": V / c}
    elif model in ("shallow_water", "general"):
        if initial_condition in ("williamson2", "zonal", "uniform",
                                 "default"):
            state0 = williamson2_state(sht, omega, **ic_params)
        elif initial_condition in ("rossby_haurwitz", "williamson6"):
            state0 = rossby_haurwitz_swe(sht, omega, **ic_params)
        else:
            raise ValueError(
                f"unknown spherical SWE IC {initial_condition!r} "
                "(use williamson2 | rossby_haurwitz)")

        def tendency(s):
            return swe_tendencies(s, sht, omega, nu4)

        g = config.gravity or 9.80616

        def output_fn(s):
            psi = sht.inverse_laplacian(s.zeta)
            chi = sht.inverse_laplacian(s.div)
            U, V = sht.uv_from_psi_chi(psi, chi)
            c = sht.cos_lat()
            return {"h": sht.synthesis(s.phi) / g, "u": U / c, "v": V / c,
                    "zeta": sht.synthesis(s.zeta),
                    "divergence": sht.synthesis(s.div)}
    else:
        raise ValueError(
            f"model {model!r} has no spherical-harmonic core "
            "(use barotropic | shallow_water)")

    stepper_factory = None
    if config.integration_method == "semi_implicit":
        if model == "barotropic":
            raise ValueError(
                "semi_implicit applies to models with fast gravity-wave "
                "modes; the spherical BVE has none — use rk4/rk2/euler.")
        phi_ref = float(state0.phi[0, 0].real)
        si = semi_implicit_spherical_swe(sht, omega, phi_ref=phi_ref,
                                         nu4=nu4, order=config.si_order)

        def stepper_factory(_tendency):
            return si

    sim = sim_cls(state0, tendency, dt=config.dt,
                  method=config.integration_method, grid=None,
                  output_fn=output_fn, stepper_factory=stepper_factory)
    sim.config = config
    sim.sht = sht
    sim.omega = omega
    return sim
