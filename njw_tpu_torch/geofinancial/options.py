"""Options pricing: Black-Scholes with autograd Greeks, the CRR binomial
tree, and Monte-Carlo prices of European, barrier and Asian options.

Counterpart of ``njw_tpu/geofinancial/options.py``. Everything runs on
``device`` (CUDA unless given; tensor arguments keep their own device),
vectorised over a batch of options:

- ``black_scholes`` in float32, the normal CDF by ``torch.special.erfc``
  (the JAX package's ``1 + erf`` cancels in the lower tail);
- ``greeks`` by ``torch.autograd.grad`` of the summed price (gamma: the
  gradient of the summed delta, built with ``create_graph=True``, as the
  JAX package's nested ``jax.grad``);
- ``binomial_tree``: a host loop of ``n_steps`` backward levels over an
  (..., n_steps + 1) float32 value array, batched over the leading
  option dimensions (``torch.roll`` wraps as ``jnp.roll`` does; the
  wrapped node is never read at a valid depth);
- the Monte-Carlo prices: float32 normals from a ``torch.Generator``
  seeded by ``seed`` (``normals=`` replaces the draw), GBM paths by one
  ``torch.cumsum`` of log-increments (``gbm_paths``), and the payoffs,
  means and standard errors in float64 on the same device (the JAX
  package takes them in NumPy float64 on the host); only the scalars come
  back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from njw_tpu_torch.geofinancial.risk_metrics import standard_normals
from njw_tpu_torch.platform.tensors import (
    as_tensor, device_of, divide, rdivide, to_numpy,
)

__all__ = [
    "black_scholes", "greeks", "binomial_tree", "monte_carlo_price",
    "barrier_option_price", "asian_option_price", "OptionsPricer",
    "gbm_paths",
]

_SQRT2 = float(np.float32(math.sqrt(2.0)))   # jnp.sqrt(2.0), a float32


def _norm_cdf(x):
    """N(x) = erfc(-x / sqrt 2) / 2. The JAX package's 0.5 (1 + erf(x /
    sqrt 2)) loses every digit in the lower tail (1 + erf cancels): out of
    the money, its float32 prices and Greeks are wrong (ROADMAP.md
    section 3); erfc keeps the tail's relative precision."""
    return 0.5 * torch.special.erfc(divide(-x, _SQRT2))


def _bs(spot, strike, t, r, sigma, call: bool):
    sqrt_t = torch.sqrt(t)
    d1 = (torch.log(spot / strike) + (r + 0.5 * sigma ** 2) * t) / (
        sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    disc = torch.exp(-r * t)
    if call:
        return spot * _norm_cdf(d1) - strike * disc * _norm_cdf(d2)
    return strike * disc * _norm_cdf(-d2) - spot * _norm_cdf(-d1)


def _float32_args(args, device):
    dev = device_of(*args, device=device)
    return [as_tensor(a, dev) for a in args]


def _out(v):
    return float(v) if v.ndim == 0 else to_numpy(v)


def black_scholes(spot, strike, t, r, sigma, kind: str = "call", *,
                  device=None):
    """European Black-Scholes price; all args broadcastable arrays."""
    out = _bs(*_float32_args((spot, strike, t, r, sigma), device),
              call=(kind == "call"))
    return _out(out)


def greeks(spot, strike, t, r, sigma, kind: str = "call", *,
           device=None) -> dict:
    """Exact autodiff Greeks of the Black-Scholes price.

    delta = dV/dS, gamma = d2V/dS2, vega = dV/dsigma (per 1.0 vol),
    theta = -dV/dt (per year), rho = dV/dr (per 1.0 rate); an argument
    broadcast over the batch gets the summed derivative, as in JAX.
    """
    out = _greeks(*_float32_args((spot, strike, t, r, sigma), device),
                  call=(kind == "call"))
    return {k_: _out(v) for k_, v in out.items()}


def _greeks(spot, strike, t, r, sigma, call: bool) -> dict:
    s, tt, rr, sig = (a.detach().requires_grad_(True)
                      for a in (spot, t, r, sigma))
    price = torch.sum(_bs(s, strike, tt, rr, sig, call))
    delta, vega, dvdt, rho = torch.autograd.grad(
        price, (s, sig, tt, rr), create_graph=True)
    gamma, = torch.autograd.grad(torch.sum(delta), s)
    out = {"delta": delta, "gamma": gamma, "vega": vega, "theta": -dvdt,
           "rho": rho}
    return {k_: v.detach() for k_, v in out.items()}


def _binomial(spot, strike, t, r, sigma, n_steps: int, call: bool,
              american: bool):
    """CRR tree by backward induction over a static width n_steps + 1;
    node i at depth m holds S u^i d^(m-i). Batched over the leading
    option dims (args shaped (...,))."""
    dt = divide(t, float(n_steps))
    u = torch.exp(sigma * torch.sqrt(dt))
    d = rdivide(1.0, u)
    p = (torch.exp(r * dt) - d) / (u - d)
    disc = torch.exp(-r * dt)[..., None]
    i = torch.arange(n_steps + 1, dtype=torch.float32, device=spot.device)
    up = spot[..., None] * u[..., None] ** i       # S u^i
    d_, k_ = d[..., None], strike[..., None]
    p_, q_ = p[..., None], 1.0 - p[..., None]

    def payoff(s):
        return (torch.clamp_min(s - k_, 0.0) if call
                else torch.clamp_min(k_ - s, 0.0))

    values = payoff(up * d_ ** (n_steps - i))     # terminal prices
    for m in range(n_steps - 1, -1, -1):
        # one level up: node i combines children i (down) and i + 1 (up)
        values = disc * (p_ * torch.roll(values, -1, dims=-1) + q_ * values)
        if american:
            values = torch.maximum(values, payoff(up * d_ ** (m - i)))
    return values[..., 0]


def binomial_tree(spot, strike, t, r, sigma, *, n_steps: int = 200,
                  kind: str = "call", american: bool = False, device=None):
    """Cox-Ross-Rubinstein binomial price, European or American."""
    args = [torch.atleast_1d(a) for a in
            _float32_args((spot, strike, t, r, sigma), device)]
    args = torch.broadcast_tensors(*args)
    out = _binomial(*args, n_steps=n_steps, call=(kind == "call"),
                    american=american)
    return float(out[0]) if tuple(out.shape) == (1,) else to_numpy(out)


def gbm_paths(z: torch.Tensor, spot: float, t: float, r: float,
              sigma: float) -> torch.Tensor:
    """(n_paths, n_steps + 1) float32 GBM price paths from the standard
    normals z (n_paths, n_steps): log-increments (r - sigma^2 / 2) dt +
    sigma sqrt(dt) z, one cumulative sum along the steps, spot in column
    0. The parameters are float32 on z's device."""
    n_paths, n_steps = z.shape
    s, tt, rr, sig = (torch.full((), float(v), dtype=torch.float32,
                                 device=z.device)
                      for v in (spot, t, r, sigma))
    dt = divide(tt, float(n_steps))
    incr = (rr - 0.5 * sig ** 2) * dt + sig * torch.sqrt(dt) * z
    log_s = torch.log(s) + torch.cumsum(incr, dim=1)
    return torch.cat([s.expand(n_paths, 1), torch.exp(log_s)], dim=1)


def _price_stats(payoff: torch.Tensor, disc: float,
                 *extra) -> torch.Tensor:
    """[price, standard error, *extra] as one float64 tensor."""
    n = payoff.shape[0]
    return torch.stack([disc * payoff.mean(),
                        disc * payoff.std(correction=1) / math.sqrt(n),
                        *extra])


def _payoff(s, strike, kind):
    return (torch.clamp_min(s - strike, 0.0) if kind == "call"
            else torch.clamp_min(strike - s, 0.0))


def monte_carlo_price(spot, strike, t, r, sigma, *, kind: str = "call",
                      n_paths: int = 100_000, seed: int = 0, device=None,
                      normals=None) -> dict:
    """Monte-Carlo European price with a standard-error estimate: a
    float32 draw of n_paths normals, the terminal prices and payoffs in
    float64 on the same device."""
    z = (standard_normals((n_paths,), seed, device) if normals is None
         else normals)
    s_t = spot * torch.exp((r - 0.5 * sigma ** 2) * t
                           + sigma * math.sqrt(t) * z.double())
    price, stderr = _price_stats(_payoff(s_t, strike, kind),
                                 math.exp(-r * t)).tolist()
    return {"price": price, "stderr": stderr}


def _paths(spot, t, r, sigma, n_paths, n_steps, seed, device, normals):
    z = (standard_normals((n_paths, n_steps), seed, device)
         if normals is None else normals)
    return gbm_paths(z, spot, t, r, sigma).double()


def barrier_option_price(spot, strike, barrier, t, r, sigma, *,
                         kind: str = "call",
                         barrier_type: str = "up-and-out",
                         n_paths: int = 100_000, n_steps: int = 252,
                         seed: int = 0, device=None, normals=None) -> dict:
    """Knock-in/out barrier option by Monte-Carlo paths (float32 paths,
    float64 payoffs, both on the device)."""
    paths = _paths(spot, t, r, sigma, n_paths, n_steps, seed, device,
                   normals)
    price, stderr, knock = _barrier_stats(paths, strike, barrier, t, r,
                                          kind, barrier_type).tolist()
    return {"price": price, "stderr": stderr, "knock_prob": knock}


def _barrier_stats(paths, strike, barrier, t, r, kind, barrier_type):
    if barrier_type.startswith("up"):
        hit = paths.amax(dim=1) >= barrier
    else:
        hit = paths.amin(dim=1) <= barrier
    alive = ~hit if barrier_type.endswith("out") else hit
    payoff = _payoff(paths[:, -1], strike, kind) * alive
    return _price_stats(payoff, math.exp(-r * t), hit.double().mean())


def asian_option_price(spot, strike, t, r, sigma, *, kind: str = "call",
                       n_paths: int = 100_000, n_steps: int = 252,
                       seed: int = 0, device=None, normals=None) -> dict:
    """Arithmetic-average-price Asian option by Monte-Carlo (float32
    paths, float64 averages and payoffs, both on the device)."""
    paths = _paths(spot, t, r, sigma, n_paths, n_steps, seed, device,
                   normals)
    price, stderr = _asian_stats(paths, strike, t, r, kind).tolist()
    return {"price": price, "stderr": stderr}


def _asian_stats(paths, strike, t, r, kind):
    avg = paths[:, 1:].mean(dim=1)
    return _price_stats(_payoff(avg, strike, kind), math.exp(-r * t))


class OptionsPricer:
    """Facade over the pricing functions, on ``device``
    (``cuda:<device_id>`` unless given)."""

    def __init__(self, device_id: int = 0, *, device=None):
        self.device_id = device_id
        self.device = f"cuda:{device_id}" if device is None else device

    def _call(self, fn, args, kw):
        return fn(*args, **{"device": self.device, **kw})

    def black_scholes(self, *args, **kw):
        return self._call(black_scholes, args, kw)

    def greeks(self, *args, **kw):
        return self._call(greeks, args, kw)

    def binomial_tree(self, *args, **kw):
        return self._call(binomial_tree, args, kw)

    def monte_carlo(self, *args, **kw):
        return self._call(monte_carlo_price, args, kw)

    def barrier(self, *args, **kw):
        return self._call(barrier_option_price, args, kw)

    def asian(self, *args, **kw):
        return self._call(asian_option_price, args, kw)
