"""Semi-implicit (Crank-Nicolson gravity-wave) integrators: SWE and PE.

Counterpart of ``njw_tpu/weather/semi_implicit.py``. The stiff linearised
gravity-wave terms are treated implicitly with a trapezoidal step and
eliminated to one spectral Helmholtz solve: scalar for the shallow-water
core, one solve per vertical normal mode for the primitive equations. The
time step is then limited by the advective speed, not by the gravity-wave
speed (sqrt(g H), or ~sqrt(R T) for the PE Lamb mode).

Scheme (periodic boundaries):
    T(s)   = N(s) + L(s)
    L      = [ -g dh/dx;  -g dh/dy;  -H (du/dx + dv/dy) ],  H = mean depth
    s*     = s + dt N(s) + (dt/2) L s
    (I - (dt/2) L) s'   = s*          (solved in Fourier space)

Elimination (a = dt/2, k_eff = the central difference's modified
wavenumbers, so the implicit operator matches the explicit stencils):
    h' = (h* - a H i(kx u* + ky v*)) / (1 + a^2 g H |k|^2)
    u' = u* - a g i kx h'
    v' = v* - a g i ky h'

order=2 is the two-time-level predictor-corrector: a CN half step
predicts the midpoint and the corrector evaluates the nonlinear terms
there. The transforms are ``torch.fft.fft2`` / ``ifft2`` in complex64
(cuFFT on the card): library calls, as the JAX package leaves them to
XLA. No kernel of this package runs here. The wavenumbers and mode
matrices are built once per device, at the first step on it.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.ops.spectral import fd_wavenumbers
from njw_tpu_torch.weather.dynamics import d_dx, d_dy
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState
from njw_tpu_torch.weather.integrators import Stepper, _axpy


def _check(grid: GridSpec, order: int, what: str) -> None:
    if grid.bc != "periodic":
        raise NotImplementedError(
            f"{what} requires periodic boundaries (spectral Helmholtz solve)")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")


def _per_device(build):
    """``build(device)`` once per device, then from a cache."""
    cache: dict = {}

    def get(device: torch.device):
        if device not in cache:
            cache[device] = build(device)
        return cache[device]

    return get


def _wavenumbers(grid: GridSpec, device) -> tuple:
    """kx (1, nx), ky (ny, 1) and |k|^2 (ny, nx), float32, central."""
    kx = fd_wavenumbers(grid.nx, grid.dx, "central", device=device)[None, :]
    ky = fd_wavenumbers(grid.ny, grid.dy, "central", device=device)[:, None]
    return kx, ky, kx * kx + ky * ky


def _inverse(f: torch.Tensor, dtype) -> torch.Tensor:
    return torch.fft.ifft2(f).real.to(dtype).contiguous()


def _two_level(nonlin, advance):
    """The step of both orders: CN with the nonlinear terms at s (order 1)
    or at the CN-predicted midpoint (order 2)."""
    def step(order, s, dt):
        n0 = nonlin(s)
        if order == 1:
            return advance(s, n0, dt)
        s_mid = advance(s, n0, 0.5 * dt)
        return advance(s, nonlin(s_mid), dt)

    return step


def semi_implicit_swe(tendency, *, grid: GridSpec, params: PhysicsParams,
                      order: int = 1) -> Stepper:
    """Semi-implicit shallow-water stepper: order 1 = Crank-Nicolson,
    order 2 = predictor-corrector. ``tendency``: the full SWE tendency."""
    _check(grid, order, "semi-implicit integrator")
    g, H = params.gravity, params.mean_depth
    waves = _per_device(lambda dev: _wavenumbers(grid, dev))

    def linear(s: WeatherState) -> WeatherState:
        return WeatherState(
            u=-g * d_dx(s.h, grid.dx, grid.bc),
            v=-g * d_dy(s.h, grid.dy, grid.bc),
            h=-H * (d_dx(s.u, grid.dx, grid.bc) + d_dy(s.v, grid.dy, grid.bc)),
        )

    def nonlin(s: WeatherState) -> WeatherState:
        return tendency(s).map(lambda tf, lf: tf - lf, linear(s))

    def advance(s: WeatherState, n_val: WeatherState, dt_eff):
        """CN over dt_eff: (I - a L) s' = s + dt_eff*N + a*L s."""
        kx, ky, k2 = waves(s.u.device)
        a = 0.5 * dt_eff
        s_star = _axpy(a, linear(s), _axpy(dt_eff, n_val, s))
        u_hat = torch.fft.fft2(s_star.u)
        v_hat = torch.fft.fft2(s_star.v)
        h_hat = torch.fft.fft2(s_star.h)

        denom = 1.0 + (a * a) * g * H * k2
        h_new_hat = (h_hat - a * H * 1j * (kx * u_hat + ky * v_hat)) / denom
        u_new_hat = u_hat - a * g * 1j * kx * h_new_hat
        v_new_hat = v_hat - a * g * 1j * ky * h_new_hat

        dtype = s.u.dtype
        return WeatherState(u=_inverse(u_new_hat, dtype),
                            v=_inverse(v_new_hat, dtype),
                            h=_inverse(h_new_hat, dtype))

    two_level = _two_level(nonlin, advance)

    def step(carry, s: WeatherState, dt):
        return carry, two_level(order, s, dt)

    return Stepper(lambda s: (), step, "semi_implicit", 2)


# ---------------------------------------------------------------------------
# Primitive equations: vertical-normal-mode Helmholtz solve.
#
# Linearise the hydrostatic PE about a resting isothermal reference state
# (T_r const, ps_r const, u = v = 0). The fast (gravity/Lamb wave) terms are
#
#   du/dt = -d/dx (G T + c ps)          c = R T_r / ps_r   (lnps linearised)
#   dv/dt = -d/dy (G T + c ps)
#   dT/dt = kappa T_r M D               D_k = div(u_k)
#   dps/dt = -ps_r dsig 1^T D
#
# where G (L x L) is the discrete hydrostatic-integral matrix (Phi' = G T')
# and M (L x L) the linearised omega/p response to divergence, both taken
# from the port's own primitive-core code applied to unit vectors, so that
# the implicit operator matches the explicit tendencies to rounding.
#
# Trapezoidal elimination to the divergence (a = dt/2, spectral space,
# modified wavenumbers; hats = fft2):
#
#   (I - a^2 k^2 A) D' = D* + a k^2 (G T* + c ps* 1),
#   A = kappa T_r G M - R T_r dsig 1 1^T
#
# A's eigenvalues are -g x (equivalent depths) < 0, so (1 - a^2 k^2 lam)
# never vanishes. A = V diag(lam) V^-1 is decomposed once at set-up (NumPy),
# and a step projects to mode space, divides and projects back.
# ---------------------------------------------------------------------------


def _pe_vertical_matrices(L: int, t_ref: float, ps_ref: float):
    """G, M, and the mode decomposition (V, V^-1, lam) of the coupling
    matrix A = kappa T_r G M - R T_r dsig 11^T, from the primitive core's
    code applied to unit vectors."""
    from njw_tpu_torch.weather.primitive import (
        KAPPA, R_DRY, hydrostatic_geopotential, sigma_levels,
    )

    sig, sig_half = (a.numpy().astype(np.float64)
                     for a in sigma_levels(L, device="cpu"))
    dsig = 1.0 / L

    # G: Phi' = G T' (the hydrostatic integral applied to unit columns)
    G = np.zeros((L, L))
    for j in range(L):
        e = torch.zeros((L, 1, 1), dtype=torch.float32)
        e[j] = 1.0
        G[:, j] = hydrostatic_geopotential(e, L)[:, 0, 0].numpy()

    # M: dT' = kappa T_r (M D), the linearised sigma-dot and omega/p
    # response, following pe_tendencies_from_shifts with ps = ps_r and
    # flux_div_j = ps_r D_j
    M = np.zeros((L, L))
    for j in range(L):
        D = np.zeros(L)
        D[j] = 1.0
        dps = -ps_ref * dsig * D.sum()
        cum = np.cumsum(ps_ref * D) * dsig
        sdot_int = (-sig_half[1:-1] * dps - cum[:-1]) / ps_ref
        sdot_half = np.concatenate([[0.0], sdot_int, [0.0]])
        sdot_full = 0.5 * (sdot_half[:-1] + sdot_half[1:])
        M[:, j] = sdot_full / sig + dps / ps_ref

    A = KAPPA * t_ref * (G @ M) - R_DRY * t_ref * dsig * np.ones((L, L))
    lam, V = np.linalg.eig(A)
    if np.abs(lam.imag).max() > 1e-8 * np.abs(lam.real).max():
        raise ValueError("PE vertical structure matrix has complex modes")
    lam, V = lam.real, V.real
    if lam.max() >= 0:
        raise ValueError(
            "PE vertical structure matrix must be negative definite "
            f"(got max eigenvalue {lam.max():.3g}); the isothermal "
            "reference state should always satisfy this")
    return G, M, V, np.linalg.inv(V), lam


def semi_implicit_pe(tendency, *, grid: GridSpec, params: PhysicsParams,
                     t_ref: float = 300.0, ps_ref: float = 1013.25,
                     order: int = 1) -> Stepper:
    """Semi-implicit stepper for the primitive-equations core.

    ``tendency``: the full nonlinear PE tendency (terrain included: any
    time-independent forcing lands in the explicit part). ``t_ref``,
    ``ps_ref``: the isothermal reference state (a t_ref at or above the
    domain's largest temperature is the stable choice). ``params`` is
    taken for the signature of the SWE stepper; the linear part needs none
    of it."""
    from njw_tpu_torch.weather.primitive import KAPPA, R_DRY, PEState

    _check(grid, order, "semi-implicit PE")
    L = grid.levels
    dsig = 1.0 / L
    c_ps = R_DRY * t_ref / ps_ref
    mats = _pe_vertical_matrices(L, t_ref, ps_ref)

    def build(dev):
        G, M, V, Vinv, lam = (torch.as_tensor(m, dtype=torch.float32,
                                              device=dev) for m in mats)
        # the complex solve promotes the real (L, L) matrices to complex64
        # for its products, as JAX does; a real matrix stored as complex
        # changes no value
        cplx = {name: m.to(torch.complex64)
                for name, m in (("G", G), ("M", M), ("V", V),
                                ("Vinv", Vinv))}
        return {"G": G, "M": M, "lam": lam, "c": cplx,
                "k": _wavenumbers(grid, dev)}

    consts = _per_device(build)

    def vmat(A, f):                             # (L, L) x (L, ny, nx)
        return torch.einsum("kl,lyx->kyx", A, f)

    def linear(s: PEState) -> PEState:
        """Grid-space linear operator (central differences, which match the
        spectral solve through the modified wavenumbers)."""
        c = consts(s.u.device)

        def ddx(f):
            return d_dx(f, grid.dx, "periodic")

        def ddy(f):
            return d_dy(f, grid.dy, "periodic")

        P = vmat(c["G"], s.T) + c_ps * s.ps[None]
        D = ddx(s.u) + ddy(s.v)
        return PEState(
            u=-ddx(P), v=-ddy(P),
            T=KAPPA * t_ref * vmat(c["M"], D),
            q=torch.zeros_like(s.q),
            ps=-ps_ref * dsig * torch.sum(D, dim=0),
        )

    def nonlin(s: PEState) -> PEState:
        return tendency(s).map(lambda tf, lf: tf - lf, linear(s))

    def advance(s: PEState, n_val: PEState, dt_eff):
        """CN over dt_eff: (I - a L) s' = s + dt_eff*N + a*L s."""
        c = consts(s.u.device)
        cm = c["c"]
        kx, ky, k2 = c["k"]
        a = 0.5 * dt_eff
        s_star = _axpy(a, linear(s), _axpy(dt_eff, n_val, s))

        u_h = torch.fft.fft2(s_star.u)
        v_h = torch.fft.fft2(s_star.v)
        T_h = torch.fft.fft2(s_star.T)
        ps_h = torch.fft.fft2(s_star.ps)

        ikx = 1j * kx
        iky = 1j * ky
        D_h = ikx * u_h + iky * v_h
        rhs = D_h + (a * k2) * (vmat(cm["G"], T_h) + c_ps * ps_h[None])
        # mode space: divide each vertical mode by its Helmholtz symbol
        r = vmat(cm["Vinv"], rhs)
        r = r / (1.0 - (a * a) * k2[None] * c["lam"][:, None, None])
        D_new = vmat(cm["V"], r)

        T_new = T_h + (a * KAPPA * t_ref) * vmat(cm["M"], D_new)
        ps_new = ps_h - (a * ps_ref * dsig) * torch.sum(D_new, dim=0)
        P_new = vmat(cm["G"], T_new) + c_ps * ps_new[None]
        u_new = u_h - a * (ikx * P_new)
        v_new = v_h - a * (iky * P_new)

        dtype = s.u.dtype
        return PEState(u=_inverse(u_new, dtype), v=_inverse(v_new, dtype),
                       T=_inverse(T_new, dtype), q=s_star.q,
                       ps=_inverse(ps_new, dtype))

    two_level = _two_level(nonlin, advance)

    def step(carry, s: PEState, dt):
        return carry, two_level(order, s, dt)

    return Stepper(lambda s: (), step, "semi_implicit", 2)
