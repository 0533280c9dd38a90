"""Risk aggregation and risk surfaces.

Counterpart of ``njw_tpu/geofinancial/aggregation.py``: the JAX
package's NumPy float64 code, copied (host work, as there).
"""
from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np


class AggregationMethod(str, Enum):
    WEIGHTED_AVERAGE = "weighted_average"
    MAXIMUM = "maximum"
    WEIGHTED_MAXIMUM = "weighted_maximum"
    PRODUCT = "product"          # 1 - prod(1 - r_i)
    COPULA_GAUSSIAN = "copula_gaussian"


class RiskAggregator:
    """Combine multiple per-asset risk-factor scores into one score
    (ref: risk_aggregation.py:33)."""

    def __init__(self,
                 method: AggregationMethod = AggregationMethod.WEIGHTED_AVERAGE,
                 correlation: Optional[np.ndarray] = None):
        self.method = AggregationMethod(method)
        self.correlation = correlation

    def aggregate(self, risks: np.ndarray,
                  weights: Optional[np.ndarray] = None) -> np.ndarray:
        """risks: (n_factors, n_assets) in [0,1] -> (n_assets,)."""
        r = np.asarray(risks, np.float64)
        if r.ndim == 1:
            r = r[None, :]
        k = r.shape[0]
        w = (np.ones(k) if weights is None
             else np.asarray(weights, np.float64))
        w = w / max(w.sum(), 1e-12)
        m = self.method
        if m == AggregationMethod.WEIGHTED_AVERAGE:
            out = (w[:, None] * r).sum(axis=0)
        elif m == AggregationMethod.MAXIMUM:
            out = r.max(axis=0)
        elif m == AggregationMethod.WEIGHTED_MAXIMUM:
            out = (w[:, None] * r).max(axis=0) * k
        elif m == AggregationMethod.PRODUCT:
            out = 1.0 - np.prod(1.0 - r, axis=0)
        elif m == AggregationMethod.COPULA_GAUSSIAN:
            out = self._gaussian_copula(r, w)
        else:  # pragma: no cover
            raise ValueError(m)
        return np.clip(out, 0.0, 1.0)

    def _gaussian_copula(self, r, w):
        """Correlation-aware aggregation: map risks to normal quantiles,
        combine with the correlation matrix, map back."""
        from math import erf, sqrt

        k = r.shape[0]
        C = (np.eye(k) if self.correlation is None
             else np.asarray(self.correlation, np.float64))
        eps = 1e-6
        z = np.sqrt(2.0) * _erfinv(2.0 * np.clip(r, eps, 1 - eps) - 1.0)
        var = float(w @ C @ w)
        combined = (w[:, None] * z).sum(axis=0) / max(np.sqrt(var), 1e-12)
        return 0.5 * (1.0 + np.vectorize(lambda v: erf(v / sqrt(2.0)))(combined))

    @staticmethod
    def correlation_matrix(risks: np.ndarray) -> np.ndarray:
        """Empirical factor correlation (ref: risk_aggregation.py:743)."""
        return np.corrcoef(np.asarray(risks, np.float64))


def _erfinv(y):
    """Vectorized inverse error function (Winitzki approximation +
    one Newton step)."""
    y = np.clip(np.asarray(y, np.float64), -1 + 1e-12, 1 - 1e-12)
    a = 0.147
    ln = np.log(1.0 - y * y)
    t = 2.0 / (np.pi * a) + ln / 2.0
    x = np.sign(y) * np.sqrt(np.sqrt(t * t - ln / a) - t)
    # Newton refinement: f(x) = erf(x) - y
    from math import erf

    fx = np.vectorize(erf)(x) - y
    x = x - fx * np.sqrt(np.pi) / 2.0 * np.exp(x * x)
    return x


class RiskSurfaceGenerator:
    """Interpolate sparse per-asset risks into a continuous surface
    (ref: risk_aggregation.py:447, :819) via inverse-distance weighting."""

    def __init__(self, power: float = 2.0, eps: float = 1e-6):
        self.power = power
        self.eps = eps

    def generate(self, xs, ys, risks, grid_shape, extent) -> np.ndarray:
        """extent = (xmin, xmax, ymin, ymax) -> (H, W) surface. NumPy
        float64 on the host, as in the JAX package: it builds the
        (H, W, n_assets) distance and weight arrays in full (8 bytes a
        cell and asset each)."""
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        risks = np.asarray(risks, np.float64)
        h, w = grid_shape
        gx = np.linspace(extent[0], extent[1], w)
        gy = np.linspace(extent[2], extent[3], h)
        gxx, gyy = np.meshgrid(gx, gy)
        d2 = ((gxx[..., None] - xs) ** 2
              + (gyy[..., None] - ys) ** 2 + self.eps)
        wgt = d2 ** (-self.power / 2.0)
        return (wgt * risks).sum(axis=-1) / wgt.sum(axis=-1)
