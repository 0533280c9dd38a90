"""Portfolio optimization and wealth simulation.

Counterpart of ``njw_tpu/geofinancial/portfolio.py``. The solvers work
on the long-only box-constrained simplex {0 <= w <= max_weight, sum w =
1}; they are the JAX package's NumPy float64 loops, copied (tens to
hundreds of assets: host work). ``monte_carlo_simulation`` draws every
path's daily normals at once on ``device`` (CUDA unless given) from a
``torch.Generator`` seeded by ``seed`` and compounds them there
(``terminal_wealth``), in float32 with full float32 products, as the JAX
package does; ``normals=`` replaces the draw.
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.geofinancial.risk_metrics import standard_normals
from njw_tpu_torch.platform.precision import float32_products
from njw_tpu_torch.platform.tensors import as_tensor

__all__ = [
    "project_to_simplex", "mean_variance_optimize", "efficient_frontier",
    "risk_parity", "black_litterman", "monte_carlo_simulation",
    "PortfolioOptimizer", "terminal_wealth",
]


def project_to_simplex(v, max_weight: float = 1.0) -> np.ndarray:
    """Euclidean projection of v onto {0 <= w <= ub, sum w = 1}.

    w(tau) = clip(v - tau, 0, ub) has a non-increasing, continuous sum in
    tau; bisect for sum == 1. Feasible iff n * ub >= 1.
    """
    v = np.asarray(v, np.float64).ravel()
    n = v.size
    if n * max_weight < 1.0 - 1e-12:
        raise ValueError(
            f"infeasible: {n} assets with max_weight={max_weight} "
            "cannot sum to 1")
    lo, hi = v.min() - 1.0, v.max()
    for _ in range(100):
        tau = 0.5 * (lo + hi)
        s = np.clip(v - tau, 0.0, max_weight).sum()
        if s > 1.0:
            lo = tau
        else:
            hi = tau
    w = np.clip(v - 0.5 * (lo + hi), 0.0, max_weight)
    return w / w.sum()  # kill the ~1e-12 bisection residue


def mean_variance_optimize(expected_returns, cov_matrix,
                           target_return=None, *, max_weight: float = 1.0,
                           risk_aversion: float = 1.0,
                           n_iters: int = 2000) -> dict:
    """Long-only mean-variance optimization by projected gradient.

    Without target_return: maximize mu'w - (risk_aversion/2) w'Sigma w.
    With target_return: minimize w'Sigma w subject to mu'w >= target
    (enforced by an adaptive quadratic penalty).
    ref: geo_risk.py:424 call shape; financial_modeling.yaml:113.
    """
    mu = np.asarray(expected_returns, np.float64).ravel()
    sigma = np.atleast_2d(np.asarray(cov_matrix, np.float64))
    n = mu.size
    # Lipschitz constant of the gradient -> safe fixed step.
    lam_max = float(np.linalg.eigvalsh(sigma)[-1])

    def solve(gamma: float) -> np.ndarray:
        """argmin_w 0.5 w'Sigma w - gamma mu'w over the box-simplex."""
        scale = max(lam_max, 1e-12)
        step = 1.0 / scale
        w = project_to_simplex(np.full(n, 1.0 / n), max_weight)
        for _ in range(n_iters):
            w_new = project_to_simplex(
                w - step * (sigma @ w - gamma * mu), max_weight)
            if np.max(np.abs(w_new - w)) < 1e-13:
                return w_new
            w = w_new
        return w

    if target_return is None:
        w = solve(1.0 / max(risk_aversion, 1e-12))
    else:
        # mu'w(gamma) is non-decreasing in gamma (frontier monotonicity
        # over a convex feasible set); bisect for the target.
        gamma_hi = 1.0
        while float(mu @ solve(gamma_hi)) < target_return \
                and gamma_hi < 1e8:
            gamma_hi *= 4.0
        lo, hi = 0.0, gamma_hi
        w = solve(gamma_hi)
        if float(mu @ w) >= target_return:  # else: infeasible, best effort
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                w_mid = solve(mid)
                if float(mu @ w_mid) >= target_return:
                    hi, w = mid, w_mid
                else:
                    lo = mid
    ret = float(mu @ w)
    vol = float(np.sqrt(max(w @ sigma @ w, 0.0)))
    return {
        "weights": w,
        "expected_return": ret,
        "volatility": vol,
        "sharpe": ret / vol if vol > 0 else 0.0,
    }


def efficient_frontier(expected_returns, cov_matrix, n_points: int = 20,
                       *, max_weight: float = 1.0) -> dict:
    """Sweep of minimum-variance portfolios across feasible target
    returns. ref: financial_modeling.yaml:116."""
    mu = np.asarray(expected_returns, np.float64).ravel()
    lo = mean_variance_optimize(mu, cov_matrix, None,
                                max_weight=max_weight,
                                risk_aversion=1e6)  # ~min-variance
    targets = np.linspace(lo["expected_return"], mu.max(), n_points)
    rows = [mean_variance_optimize(mu, cov_matrix, float(t),
                                   max_weight=max_weight)
            for t in targets]
    return {
        "target_returns": targets,
        "returns": np.array([r["expected_return"] for r in rows]),
        "volatilities": np.array([r["volatility"] for r in rows]),
        "weights": np.stack([r["weights"] for r in rows]),
    }


def risk_parity(cov_matrix, budgets=None, *, n_sweeps: int = 500) -> dict:
    """Equal (or budgeted) risk-contribution portfolio.

    Minimizes the convex potential 0.5 x'Sigma x - sum b_i log x_i (whose
    stationary point satisfies x_i (Sigma x)_i = b_i, i.e. risk parity)
    by cyclical coordinate descent — each coordinate update is the exact
    positive root of Sigma_ii x_i^2 + c_i x_i - b_i = 0.
    ref: financial_modeling.yaml:119.
    """
    sigma = np.atleast_2d(np.asarray(cov_matrix, np.float64))
    n = sigma.shape[0]
    b = (np.full(n, 1.0 / n) if budgets is None
         else np.asarray(budgets, np.float64) /
         np.sum(budgets))
    x = 1.0 / np.sqrt(np.maximum(np.diag(sigma), 1e-18))
    for _ in range(n_sweeps):
        x_prev = x.copy()
        for i in range(n):
            c = float(sigma[i] @ x) - sigma[i, i] * x[i]
            x[i] = (-c + np.sqrt(c * c + 4.0 * sigma[i, i] * b[i])) / (
                2.0 * sigma[i, i])
        if np.max(np.abs(x - x_prev)) < 1e-14:
            break
    w = x / x.sum()
    contrib = w * (sigma @ w)
    return {
        "weights": w,
        "risk_contributions": contrib / contrib.sum(),
        "volatility": float(np.sqrt(w @ sigma @ w)),
    }


def black_litterman(market_weights, cov_matrix, *, views_P=None,
                    views_Q=None, view_confidence=None, tau: float = 0.05,
                    risk_aversion: float = 2.5) -> dict:
    """Black-Litterman posterior expected returns.

    pi = delta Sigma w_mkt (implied equilibrium returns); with views
    P mu = Q (+noise Omega), the posterior is
    mu_BL = [(tau Sigma)^-1 + P' Omega^-1 P]^-1
            [(tau Sigma)^-1 pi + P' Omega^-1 Q].
    ref: financial_modeling.yaml:125.
    """
    w = np.asarray(market_weights, np.float64).ravel()
    sigma = np.atleast_2d(np.asarray(cov_matrix, np.float64))
    pi = risk_aversion * sigma @ w
    if views_P is None or views_Q is None:
        return {"posterior_returns": pi, "implied_returns": pi}
    P = np.atleast_2d(np.asarray(views_P, np.float64))
    Q = np.asarray(views_Q, np.float64).ravel()
    ts = tau * sigma
    if view_confidence is None:
        omega = np.diag(np.diag(P @ ts @ P.T))
    else:
        omega = np.diag(np.asarray(view_confidence, np.float64).ravel())
    ts_inv = np.linalg.inv(ts)
    om_inv = np.linalg.inv(omega)
    post = np.linalg.solve(ts_inv + P.T @ om_inv @ P,
                           ts_inv @ pi + P.T @ om_inv @ Q)
    return {"posterior_returns": post, "implied_returns": pi}


def terminal_wealth(z: torch.Tensor, weights, mean, chol, n_paths: int,
                    horizon: int) -> torch.Tensor:
    """Terminal wealth per $1 of every path: z (n_paths * horizon, n)
    standard normals (path-major: a path's days are consecutive rows),
    asset returns mean + z @ chol.T, portfolio daily returns that @
    weights, log-compounded over each path's days. float32, full float32
    products; weights, mean, chol: NumPy or tensors on z's device."""
    weights, mean, chol = (as_tensor(a, z.device)
                           for a in (weights, mean, chol))
    with float32_products():
        asset_r = mean + z @ chol.T                  # (paths*days, n)
        port_r = asset_r @ weights                   # (paths*days,)
    logs = torch.log1p(port_r).reshape(n_paths, horizon)
    return torch.exp(torch.sum(logs, dim=1))


def monte_carlo_simulation(weights, returns=None, *, mean=None, cov=None,
                           n_paths: int = 10_000, horizon: int = 252,
                           seed: int = 0, device=None, normals=None) -> dict:
    """Terminal-wealth distribution of a weighted portfolio under a
    Gaussian daily-return model, simulated on ``device`` (CUDA unless
    given); ``normals``, a float32 (n_paths * horizon, n_assets) tensor,
    replaces the draw (and sets the device). The statistics are NumPy
    float64 on the host."""
    if returns is not None:
        r = np.asarray(returns, np.float64)
        r = r[:, None] if r.ndim == 1 else r
        mean = r.mean(axis=0)
        cov = np.atleast_2d(np.cov(r, rowvar=False))
    mean = np.asarray(mean, np.float64).ravel()
    cov = np.atleast_2d(np.asarray(cov, np.float64))
    w = np.asarray(weights, np.float64).ravel()
    chol = np.linalg.cholesky(cov + 1e-12 * np.eye(mean.size))
    z = (standard_normals((n_paths * horizon, mean.size), seed, device)
         if normals is None else normals)
    wealth = terminal_wealth(z, w, mean, chol, n_paths,
                             horizon).cpu().numpy().astype(np.float64)
    return {
        "terminal_wealth": wealth,
        "mean": float(wealth.mean()),
        "median": float(np.median(wealth)),
        "q05": float(np.quantile(wealth, 0.05)),
        "q95": float(np.quantile(wealth, 0.95)),
        "prob_loss": float((wealth < 1.0).mean()),
    }


class PortfolioOptimizer:
    """Facade over the solvers; the simulation runs on ``device``
    (``cuda:<device_id>`` unless given)."""

    def __init__(self, device_id: int = 0, *, device=None):
        self.device_id = device_id
        self.device = f"cuda:{device_id}" if device is None else device

    def optimize(self, expected_returns, cov_matrix, target_return=None,
                 constraints=None, **kw) -> dict:
        constraints = constraints or {}
        return mean_variance_optimize(
            expected_returns, cov_matrix, target_return,
            max_weight=float(constraints.get("max_weight", 1.0)), **kw)

    def efficient_frontier(self, expected_returns, cov_matrix,
                           n_points: int = 20, constraints=None) -> dict:
        constraints = constraints or {}
        return efficient_frontier(
            expected_returns, cov_matrix, n_points,
            max_weight=float(constraints.get("max_weight", 1.0)))

    def risk_parity(self, cov_matrix, budgets=None) -> dict:
        return risk_parity(cov_matrix, budgets)

    def black_litterman(self, market_weights, cov_matrix, **kw) -> dict:
        return black_litterman(market_weights, cov_matrix, **kw)

    def monte_carlo_simulation(self, weights, **kw) -> dict:
        return monte_carlo_simulation(weights, **{"device": self.device,
                                                  **kw})
