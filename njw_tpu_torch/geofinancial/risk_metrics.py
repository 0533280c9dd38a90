"""Returns-based financial risk metrics.

Counterpart of ``njw_tpu/geofinancial/risk_metrics.py``. The historical,
parametric and Gaussian metrics (VaR, CVaR, volatility, covariance,
Sharpe, Sortino, drawdown, attribution) are the JAX package's NumPy
float64 code, copied. The Monte-Carlo VaR draws its standard normals on
``device`` (CUDA unless given) from a ``torch.Generator`` seeded by
``seed`` and correlates them with one float32 product there
(``portfolio_samples``); the VaR and CVaR of the samples are then taken
in NumPy float64, as the JAX package does. JAX's threefry bits cannot be
matched, so a caller that needs the same draw on two devices passes the
normals in (``normals=``).

Conventions: `returns` is (n_days,) portfolio returns or (n_days, n_assets)
per-asset simple returns, oldest first. VaR/CVaR are reported as POSITIVE
loss fractions (0.05 = 5% loss at the confidence level).
"""
from __future__ import annotations

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.platform.precision import float32_products
from njw_tpu_torch.platform.tensors import as_tensor

__all__ = [
    "historical_var", "parametric_var", "monte_carlo_var", "cvar",
    "volatility", "covariance_matrix", "sharpe_ratio", "sortino_ratio",
    "max_drawdown", "risk_attribution", "RiskMetricsAnalyzer",
    "standard_normals", "portfolio_samples",
]

TRADING_DAYS = 252


def _as_2d(returns) -> np.ndarray:
    r = np.asarray(returns, np.float64)
    return r[:, None] if r.ndim == 1 else r


def historical_var(returns, confidence: float = 0.95) -> float:
    """Empirical-quantile VaR of a return series (positive loss)."""
    r = np.asarray(returns, np.float64).ravel()
    return float(max(0.0, -np.quantile(r, 1.0 - confidence)))


def parametric_var(returns, confidence: float = 0.95) -> float:
    """Gaussian (variance-covariance) VaR: -(mu + sigma*z_{1-c})."""
    r = np.asarray(returns, np.float64).ravel()
    z = _norm_ppf(1.0 - confidence)
    return float(max(0.0, -(r.mean() + r.std(ddof=1) * z)))


def cvar(returns, confidence: float = 0.95) -> float:
    """Conditional VaR / expected shortfall: mean loss beyond VaR."""
    r = np.asarray(returns, np.float64).ravel()
    cut = np.quantile(r, 1.0 - confidence)
    tail = r[r <= cut]
    if tail.size == 0:
        return historical_var(r, confidence)
    return float(max(0.0, -tail.mean()))


def volatility(returns, *, annualize: bool = True) -> np.ndarray:
    """Per-asset return volatility (std of daily returns), optionally
    annualized by sqrt(252)."""
    r = _as_2d(returns)
    v = r.std(axis=0, ddof=1)
    out = v * np.sqrt(TRADING_DAYS) if annualize else v
    return out if out.size > 1 else float(out[0])


def covariance_matrix(returns, *, annualize: bool = True) -> np.ndarray:
    """(n_assets, n_assets) sample covariance of daily returns."""
    r = _as_2d(returns)
    c = np.cov(r, rowvar=False)
    c = np.atleast_2d(c)
    return c * TRADING_DAYS if annualize else c


def standard_normals(shape, seed: int, device=None) -> torch.Tensor:
    """float32 standard normals of ``shape`` on ``device`` (CUDA unless
    given), from a generator of that device seeded by ``seed``. The CUDA
    and CPU generators give different streams for one seed."""
    dev = require_device("cuda" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=dev,
                       dtype=torch.float32)


def portfolio_samples(z: torch.Tensor, mean, chol, weights) -> torch.Tensor:
    """Correlated return draws -> portfolio returns: with asset returns
    mean + z @ chol.T, the portfolio's are mean @ w + z @ (chol.T @ w),
    so the large product is (n_samples, n) x (n,). float32 throughout,
    full float32 products (no TF32). z: (n_samples, n) on its device;
    mean, chol, weights: NumPy or tensors there."""
    mean, chol, weights = (as_tensor(a, z.device)
                           for a in (mean, chol, weights))
    with float32_products():
        proj = chol.T @ weights                  # (n,)
        return mean @ weights + z @ proj         # (n_samples,)


def monte_carlo_var(returns=None, confidence: float = 0.95, *,
                    weights=None, mean=None, cov=None,
                    n_samples: int = 100_000, seed: int = 0,
                    return_cvar: bool = False, device=None, normals=None):
    """Monte-Carlo VaR under a Gaussian copula of the assets.

    Either pass per-asset `returns` (history; mean/cov estimated) or
    explicit `mean`/`cov` of daily asset returns. `weights` defaults to
    equal-weight. The samples are drawn and correlated on ``device``
    (CUDA unless given); ``normals``, a float32 (n_samples, n_assets)
    tensor, replaces the draw (and sets the device).
    """
    if returns is not None:
        r = _as_2d(returns)
        mean = r.mean(axis=0)
        cov = covariance_matrix(r, annualize=False)
    mean = np.asarray(mean, np.float64).ravel()
    cov = np.atleast_2d(np.asarray(cov, np.float64))
    n = mean.shape[0]
    if weights is None:
        weights = np.full(n, 1.0 / n)
    weights = np.asarray(weights, np.float64).ravel()
    # Cholesky with a tiny jitter for near-singular covs.
    chol = np.linalg.cholesky(cov + 1e-12 * np.eye(n))
    z = (standard_normals((n_samples, n), seed, device) if normals is None
         else normals)
    samples = portfolio_samples(z, mean, chol, weights).cpu().numpy()
    var = historical_var(samples, confidence)
    if return_cvar:
        return var, cvar(samples, confidence)
    return var


def sharpe_ratio(returns, risk_free_rate: float = 0.0) -> float:
    """Annualized Sharpe ratio of a daily return series."""
    r = np.asarray(returns, np.float64).ravel()
    excess = r - risk_free_rate / TRADING_DAYS
    sd = excess.std(ddof=1)
    if sd == 0:
        return 0.0
    return float(excess.mean() / sd * np.sqrt(TRADING_DAYS))


def sortino_ratio(returns, risk_free_rate: float = 0.0) -> float:
    """Sharpe with downside deviation in the denominator."""
    r = np.asarray(returns, np.float64).ravel()
    excess = r - risk_free_rate / TRADING_DAYS
    downside = np.minimum(excess, 0.0)
    dd = np.sqrt((downside ** 2).mean())
    if dd == 0:
        return float("inf") if excess.mean() > 0 else 0.0
    return float(excess.mean() / dd * np.sqrt(TRADING_DAYS))


def max_drawdown(returns) -> float:
    """Largest peak-to-trough equity drop as a positive fraction."""
    r = np.asarray(returns, np.float64).ravel()
    equity = np.cumprod(1.0 + r)
    peak = np.maximum.accumulate(equity)
    return float(np.max(1.0 - equity / peak, initial=0.0))


def risk_attribution(weights, cov) -> dict:
    """Decompose portfolio volatility into per-asset contributions.

    marginal_i = (cov w)_i / sigma_p; contribution_i = w_i * marginal_i
    (contributions sum to sigma_p).
    """
    w = np.asarray(weights, np.float64).ravel()
    c = np.atleast_2d(np.asarray(cov, np.float64))
    cw = c @ w
    var_p = float(w @ cw)
    sigma_p = np.sqrt(max(var_p, 0.0))
    marginal = cw / sigma_p if sigma_p > 0 else np.zeros_like(cw)
    contrib = w * marginal
    pct = contrib / sigma_p if sigma_p > 0 else np.zeros_like(contrib)
    return {
        "volatility": sigma_p,
        "marginal": marginal,
        "contribution": contrib,
        "pct_contribution": pct,
    }


def _norm_ppf(p: float) -> float:
    """Standard-normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9 — enough for VaR z-scores; avoids a scipy dep)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0, 1)")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                * q + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q
                                + d[3]) * q + 1)
    if p > phigh:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r
                                 + b[3]) * r + b[4]) * r + 1)


class RiskMetricsAnalyzer:
    """Facade over the metrics. The Monte-Carlo method runs on ``device``
    (``cuda:<device_id>`` unless given)."""

    def __init__(self, device_id: int = 0, *, device=None):
        self.device_id = device_id
        self.device = f"cuda:{device_id}" if device is None else device

    def calculate_var(self, returns, confidence_level: float = 0.95,
                      method: str = "historical") -> float:
        if method == "historical":
            return historical_var(returns, confidence_level)
        if method == "parametric":
            return parametric_var(returns, confidence_level)
        if method == "monte_carlo":
            r = _as_2d(returns)
            if r.shape[1] == 1:  # single series: bootstrap mean/std
                return parametric_var(returns, confidence_level)
            return monte_carlo_var(r, confidence_level, device=self.device)
        raise ValueError(f"unknown VaR method: {method!r}")

    def calculate_cvar(self, returns, confidence_level: float = 0.95
                       ) -> float:
        return cvar(returns, confidence_level)

    def calculate_volatility(self, returns, annualize: bool = True):
        return volatility(returns, annualize=annualize)

    def calculate_covariance(self, returns, annualize: bool = True):
        return covariance_matrix(returns, annualize=annualize)

    def calculate_sharpe(self, returns, risk_free_rate: float = 0.0):
        return sharpe_ratio(returns, risk_free_rate)

    def calculate_sortino(self, returns, risk_free_rate: float = 0.0):
        return sortino_ratio(returns, risk_free_rate)

    def calculate_max_drawdown(self, returns):
        return max_drawdown(returns)

    def calculate_risk_attribution(self, weights, cov):
        return risk_attribution(weights, cov)
