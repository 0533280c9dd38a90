"""The port's financial layer (risk metrics, portfolio optimisation,
options pricing) held against the JAX package, on the CPU.

JAX's threefry draws cannot be matched, so each Monte-Carlo function is
held to JAX on JAX's own normals: the test draws
``jax.random.normal(PRNGKey(seed), shape, float32)`` and hands it to the
port's transform (``portfolio_samples``, ``terminal_wealth``,
``gbm_paths``) or to the public function's ``normals=``. Tolerances: the
transforms normalised 1e-5 (by the largest |value|; measured 1.6e-7,
1.1e-7 and 4.7e-7), the public Monte-Carlo results 1e-5 relative;
Black-Scholes and the Greeks rtol 1e-5 (gamma 1e-4) where both packages
are accurate, and normalised 1e-5 over the whole 32 x 32 chain; the
binomial tree rtol 1e-5; the NumPy copies (the historical and Gaussian
metrics, the optimisers) bit for bit. The JAX file's own tests
(tests/test_financial.py) run again on the port's draws at their bounds.
The port's normal CDF is erfc-based: JAX's 1 + erf loses the lower tail
in float32 (ROADMAP.md section 3), which the tail test shows against a
float64 evaluation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import njw_tpu.geofinancial as J  # noqa: E402
from njw_tpu.geofinancial import options as jo  # noqa: E402
from njw_tpu.geofinancial import portfolio as jp  # noqa: E402
from njw_tpu.geofinancial import risk_metrics as jrm  # noqa: E402

import njw_tpu_torch.geofinancial as T  # noqa: E402
from njw_tpu_torch.geofinancial import options as to  # noqa: E402
from njw_tpu_torch.geofinancial import portfolio as tp  # noqa: E402
from njw_tpu_torch.geofinancial import risk_metrics as trm  # noqa: E402
from njw_tpu_torch.geofinancial.main_paths import (  # noqa: E402
    market, option_chain,
)

CPU = "cpu"
NORM = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_normals(seed, shape) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                      jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def normalised(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def assert_same(a, b):
    """Equal bit for bit: arrays, floats, dicts and lists of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b or (a != a and b != b)


# ------------------------------------------------------------ the draws

class TestTransformsOnJaxNormals:
    def test_portfolio_samples(self):
        mean, cov, w, chol = market(20)
        key = jax.random.PRNGKey(3)
        want = jrm._mc_portfolio_samples(
            jnp.asarray(mean, jnp.float32), jnp.asarray(chol, jnp.float32),
            jnp.asarray(w, jnp.float32), key, 5000)
        got = trm.portfolio_samples(_t(jax_normals(3, (5000, 20))), mean,
                                    chol, w)
        assert got.dtype == torch.float32
        assert normalised(want, got.numpy()) <= NORM

    def test_terminal_wealth(self):
        mean, cov, w, chol = market(12)
        want = jp._mc_terminal_wealth(
            jnp.asarray(w, jnp.float32), jnp.asarray(mean, jnp.float32),
            jnp.asarray(chol, jnp.float32), jax.random.PRNGKey(5), 64, 40)
        got = tp.terminal_wealth(_t(jax_normals(5, (64 * 40, 12))), w, mean,
                                 chol, 64, 40)
        assert normalised(want, got.numpy()) <= NORM

    @pytest.mark.parametrize("spot,t,r,sigma,steps",
                             [(100.0, 1.0, 0.05, 0.2, 252),
                              (42.0, 0.25, 0.01, 0.6, 63)])
    def test_gbm_paths(self, spot, t, r, sigma, steps):
        want = jo._gbm_paths(spot, t, r, sigma, jax.random.PRNGKey(7), 300,
                             steps)
        got = to.gbm_paths(_t(jax_normals(7, (300, steps))), spot, t, r,
                           sigma)
        assert got.shape == (300, steps + 1)
        assert normalised(want, got.numpy()) <= NORM

    def test_monte_carlo_var(self):
        mean, cov, w, _ = market(20)
        want = J.monte_carlo_var(mean=mean, cov=cov, weights=w,
                                 n_samples=20_000, seed=2, return_cvar=True)
        got = T.monte_carlo_var(mean=mean, cov=cov, weights=w,
                                n_samples=20_000, seed=2, return_cvar=True,
                                normals=_t(jax_normals(2, (20_000, 20))))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_monte_carlo_var_from_history(self):
        r = np.random.default_rng(0).normal(0.0, 0.01, (500, 4))
        want = J.monte_carlo_var(r, 0.99, n_samples=10_000, seed=1)
        got = T.monte_carlo_var(r, 0.99, n_samples=10_000, seed=1,
                                normals=_t(jax_normals(1, (10_000, 4))))
        assert got == pytest.approx(want, rel=1e-5)

    def test_monte_carlo_simulation(self):
        mean, cov, w, _ = market(8)
        want = J.monte_carlo_simulation(w, mean=mean, cov=cov, n_paths=200,
                                        horizon=50, seed=4)
        got = T.monte_carlo_simulation(
            w, mean=mean, cov=cov, n_paths=200, horizon=50, seed=4,
            normals=_t(jax_normals(4, (200 * 50, 8))))
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["terminal_wealth"],
                                   want["terminal_wealth"], rtol=1e-5)
        for k in ("mean", "median", "q05", "q95"):
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        assert got["prob_loss"] == want["prob_loss"]

    @pytest.mark.parametrize("kind", ["call", "put"])
    def test_monte_carlo_price(self, kind):
        want = J.monte_carlo_price(100, 95, 0.75, 0.03, 0.3, kind=kind,
                                   n_paths=20_000, seed=6)
        got = T.monte_carlo_price(100, 95, 0.75, 0.03, 0.3, kind=kind,
                                  n_paths=20_000, seed=6,
                                  normals=_t(jax_normals(6, (20_000,))))
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5)

    @pytest.mark.parametrize("barrier,btype,kind", [
        (130.0, "up-and-out", "call"), (120.0, "up-and-in", "call"),
        (85.0, "down-and-out", "put"), (90.0, "down-and-in", "put")])
    def test_barrier(self, barrier, btype, kind):
        kw = dict(kind=kind, barrier_type=btype, n_paths=3000, n_steps=100,
                  seed=8)
        want = J.barrier_option_price(100, 100, barrier, 1.0, 0.05, 0.2, **kw)
        got = T.barrier_option_price(100, 100, barrier, 1.0, 0.05, 0.2,
                                     normals=_t(jax_normals(8, (3000, 100))),
                                     **kw)
        assert got["knock_prob"] == want["knock_prob"]
        for k in ("price", "stderr"):
            assert got[k] == pytest.approx(want[k], rel=1e-5)

    @pytest.mark.parametrize("kind", ["call", "put"])
    def test_asian(self, kind):
        want = J.asian_option_price(100, 100, 1.0, 0.05, 0.2, kind=kind,
                                    n_paths=3000, n_steps=100, seed=9)
        got = T.asian_option_price(100, 100, 1.0, 0.05, 0.2, kind=kind,
                                   n_paths=3000, n_steps=100, seed=9,
                                   normals=_t(jax_normals(9, (3000, 100))))
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5)

    def test_draw_is_seeded_float32_on_the_device(self):
        a = trm.standard_normals((1000, 3), 5, CPU)
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, trm.standard_normals((1000, 3), 5, CPU))
        assert not torch.equal(a, trm.standard_normals((1000, 3), 6, CPU))
        assert abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1) < 0.1


# ------------------------------------------------------------ options

BATCH = dict(spot=np.array([80.0, 100.0, 120.0]), strike=100.0, t=0.5,
             r=0.03, sigma=0.25)
SCALAR = dict(spot=100.0, strike=100.0, t=1.0, r=0.05, sigma=0.2)
PAIRS = dict(spot=np.array([90.0, 100.0, 110.0, 95.0]),
             strike=np.array([100.0, 95.0, 105.0, 100.0]),
             t=np.array([0.5, 1.0, 1.5, 0.25]), r=0.04,
             sigma=np.array([0.2, 0.3, 0.25, 0.35]))
CASES = {"scalar": SCALAR, "batch": BATCH, "pairs": PAIRS}


def _args(case):
    c = CASES[case]
    return c["spot"], c["strike"], c["t"], c["r"], c["sigma"]


class TestOptionsAgainstJax:
    @pytest.mark.parametrize("case", list(CASES))
    @pytest.mark.parametrize("kind", ["call", "put"])
    def test_black_scholes(self, case, kind):
        want = J.black_scholes(*_args(case), kind)
        got = T.black_scholes(*_args(case), kind, device=CPU)
        assert type(got) is type(want)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("case", list(CASES))
    @pytest.mark.parametrize("kind", ["call", "put"])
    def test_greeks(self, case, kind):
        want = J.greeks(*_args(case), kind)
        got = T.greeks(*_args(case), kind, device=CPU)
        assert got.keys() == want.keys()
        for k in want:
            assert type(got[k]) is type(want[k])
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=1e-4 if k == "gamma" else 1e-5)

    @pytest.mark.parametrize("kind", ["call", "put"])
    def test_chain_normalised(self, kind):
        k, t = option_chain()
        args = (100.0, k, t, 0.05, 0.2)
        assert normalised(J.black_scholes(*args, kind),
                          T.black_scholes(*args, kind, device=CPU)) <= NORM
        want = J.greeks(*args, kind)
        got = T.greeks(*args, kind, device=CPU)
        for g in want:
            assert normalised(want[g], got[g]) <= NORM, g

    @pytest.mark.parametrize("case", ["scalar", "batch", "pairs"])
    @pytest.mark.parametrize("american", [False, True])
    @pytest.mark.parametrize("kind", ["call", "put"])
    @pytest.mark.parametrize("steps", [200, 300])
    def test_binomial_tree(self, case, american, kind, steps):
        kw = dict(n_steps=steps, kind=kind, american=american)
        want = J.binomial_tree(*_args(case), **kw)
        got = T.binomial_tree(*_args(case), device=CPU, **kw)
        assert type(got) is type(want)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_binomial_tree_two_leading_dims(self):
        s = np.array([[90.0, 100.0], [110.0, 120.0]])
        want = J.binomial_tree(s, 100.0, 1.0, 0.05, 0.2, kind="put",
                               american=True, n_steps=60)
        got = T.binomial_tree(s, 100.0, 1.0, 0.05, 0.2, kind="put",
                              american=True, n_steps=60, device=CPU)
        assert got.shape == (2, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_pricer_facade_runs_on_its_device(self):
        p = T.OptionsPricer(device=CPU)
        assert p.black_scholes(100, 100, 1.0, 0.05, 0.2) == pytest.approx(
            J.OptionsPricer().black_scholes(100, 100, 1.0, 0.05, 0.2),
            rel=1e-5)
        assert p.binomial_tree(100, 100, 1.0, 0.05, 0.2, n_steps=50) == \
            pytest.approx(J.binomial_tree(100, 100, 1.0, 0.05, 0.2,
                                          n_steps=50), rel=1e-5)
        assert set(p.monte_carlo(100, 100, 1.0, 0.05, 0.2,
                                 n_paths=1000)) == {"price", "stderr"}
        assert p.device == CPU and T.OptionsPricer(1).device == "cuda:1"


def _bs64(s, k, t, r, sig, kind):
    """Black-Scholes put price, theta and rho in float64 (scipy-free)."""
    from math import erfc, exp, log, pi, sqrt

    def cdf(x):
        return 0.5 * erfc(-x / sqrt(2.0))

    d1 = (log(s / k) + (r + 0.5 * sig * sig) * t) / (sig * sqrt(t))
    d2 = d1 - sig * sqrt(t)
    pdf = exp(-0.5 * d1 * d1) / sqrt(2 * pi)
    assert kind == "put"
    price = k * exp(-r * t) * cdf(-d2) - s * cdf(-d1)
    theta = -s * pdf * sig / (2 * sqrt(t)) + r * k * exp(-r * t) * cdf(-d2)
    rho = -k * t * exp(-r * t) * cdf(-d2)
    return {"price": price, "theta": theta, "rho": rho}


class TestLowerTail:
    """ROADMAP.md section 3: the JAX package's float32 N(x) = (1 + erf(x /
    sqrt 2)) / 2 cancels for x << 0, so a far out-of-the-money put's price
    and Greeks lose their digits. A put at strike 70, spot 100, 0.1 y,
    r 0.05, sigma 0.2 (a corner of the options_chain_1024 chain)."""

    ARGS = (100.0, 70.0, 0.1, 0.05, 0.2)

    def test_port_holds_the_float64_values(self):
        ref = _bs64(*self.ARGS, "put")
        got = T.greeks(*self.ARGS, "put", device=CPU)
        # tests/test_financial.py:206-214's relative bounds for theta, rho
        assert got["theta"] == pytest.approx(ref["theta"], rel=0.02)
        assert got["rho"] == pytest.approx(ref["rho"], rel=0.01)
        assert T.black_scholes(*self.ARGS, "put", device=CPU) == \
            pytest.approx(ref["price"], rel=1e-3)

    def test_reference_misses_them(self):
        ref = _bs64(*self.ARGS, "put")
        got = J.greeks(*self.ARGS, "put")
        assert abs(got["rho"] / ref["rho"] - 1) > 1.0
        assert abs(got["theta"] / ref["theta"] - 1) > 0.02
        assert abs(J.black_scholes(*self.ARGS, "put") / ref["price"] - 1) \
            > 1.0


# --------------------------------------------------- NumPy copies, bits

def normal_returns(n_days=2000, mu=0.0005, sd=0.01, seed=3):
    return np.random.default_rng(seed).normal(mu, sd, n_days)


class TestNumpyCopiesBitEqual:
    @pytest.mark.parametrize("fn", ["historical_var", "parametric_var",
                                    "cvar"])
    @pytest.mark.parametrize("conf", [0.9, 0.95, 0.99])
    def test_var_family(self, fn, conf):
        r = normal_returns(seed=11)
        assert getattr(trm, fn)(r, conf) == getattr(jrm, fn)(r, conf)

    def test_series_metrics(self):
        r = normal_returns(seed=12)
        m = J.generate_returns(6, 300, seed=2)
        for fn in ("sharpe_ratio", "sortino_ratio"):
            assert getattr(trm, fn)(r, 0.02) == getattr(jrm, fn)(r, 0.02)
        assert trm.max_drawdown(r) == jrm.max_drawdown(r)
        for ann in (True, False):
            assert_same(trm.volatility(m, annualize=ann),
                        jrm.volatility(m, annualize=ann))
            assert_same(trm.covariance_matrix(m, annualize=ann),
                        jrm.covariance_matrix(m, annualize=ann))
        assert trm.volatility(m[:, 0]) == jrm.volatility(m[:, 0])
        cov = jrm.covariance_matrix(m)
        w = np.arange(1.0, 7.0) / 21.0
        assert_same(trm.risk_attribution(w, cov),
                    jrm.risk_attribution(w, cov))

    @pytest.mark.parametrize("p", [1e-4, 0.01, 0.3, 0.5, 0.9, 0.999])
    def test_norm_ppf(self, p):
        assert trm._norm_ppf(p) == jrm._norm_ppf(p)

    def test_analyzer(self):
        r = normal_returns(seed=13)
        a, b = trm.RiskMetricsAnalyzer(device=CPU), jrm.RiskMetricsAnalyzer()
        for method in ("historical", "parametric", "monte_carlo"):
            assert a.calculate_var(r, 0.97, method) == \
                b.calculate_var(r, 0.97, method)
        assert a.calculate_cvar(r) == b.calculate_cvar(r)
        assert a.calculate_sortino(r) == b.calculate_sortino(r)

    def test_project_to_simplex(self):
        v = np.random.default_rng(1).normal(size=9)
        for ub in (1.0, 0.3, 0.12):
            assert_same(tp.project_to_simplex(v, ub),
                        jp.project_to_simplex(v, ub))

    @pytest.mark.parametrize("target,kw", [
        (None, {}), (None, {"risk_aversion": 1e6}),
        (0.0012, {"max_weight": 0.4}), (0.05, {})])
    def test_mean_variance(self, target, kw):
        mean, cov, _, _ = market(6)
        kw = {"n_iters": 400, **kw}
        assert_same(tp.mean_variance_optimize(mean, cov, target, **kw),
                    jp.mean_variance_optimize(mean, cov, target, **kw))

    MU = np.array([0.02, 0.06, 0.10])
    COV = np.diag([0.01, 0.02, 0.05]) + 0.002

    def test_efficient_frontier(self):
        mu, cov = self.MU, self.COV
        assert_same(tp.efficient_frontier(mu, cov, 2, max_weight=0.6),
                    jp.efficient_frontier(mu, cov, 2, max_weight=0.6))

    def test_risk_parity_and_black_litterman(self):
        cov = self.COV
        assert_same(tp.risk_parity(cov), jp.risk_parity(cov))
        assert_same(tp.risk_parity(cov, [1, 2, 3]),
                    jp.risk_parity(cov, [1, 2, 3]))
        w = np.array([0.3, 0.3, 0.4])
        assert_same(tp.black_litterman(w, cov), jp.black_litterman(w, cov))
        kw = dict(views_P=[[1.0, -1.0, 0.0]], views_Q=[0.02])
        assert_same(tp.black_litterman(w, cov, **kw),
                    jp.black_litterman(w, cov, **kw))
        assert_same(tp.black_litterman(w, cov, view_confidence=[1e-3], **kw),
                    jp.black_litterman(w, cov, view_confidence=[1e-3], **kw))

    def test_optimizer_facade(self):
        mu = np.array([0.08, 0.05, 0.03])
        cov = np.diag([0.04, 0.02, 0.01])
        kw = dict(target_return=0.05, constraints={"max_weight": 0.5})
        assert_same(T.PortfolioOptimizer(device=CPU).optimize(mu, cov, **kw),
                    J.PortfolioOptimizer().optimize(mu, cov, **kw))


# ------------------------------------------ the JAX tests, on the port

class TestRiskMetrics:
    def test_norm_ppf_matches_known_quantiles(self):
        assert trm._norm_ppf(0.975) == pytest.approx(1.959964, abs=1e-5)
        assert trm._norm_ppf(0.05) == pytest.approx(-1.644854, abs=1e-5)
        assert trm._norm_ppf(0.5) == pytest.approx(0.0, abs=1e-9)

    def test_historical_and_parametric_var_agree_on_gaussian(self):
        r = normal_returns()
        h = T.historical_var(r, 0.95)
        p = T.parametric_var(r, 0.95)
        assert h == pytest.approx(0.0159, rel=0.12)
        assert p == pytest.approx(h, rel=0.1)

    def test_cvar_exceeds_var(self):
        r = normal_returns()
        assert T.cvar(r, 0.95) > T.historical_var(r, 0.95)

    def test_monte_carlo_var_matches_parametric(self):
        rng = np.random.default_rng(0)
        r = rng.normal(0.0, 0.01, (3000, 4))
        mc = T.monte_carlo_var(r, 0.95, n_samples=200_000, device=CPU)
        port = r.mean(axis=1)
        assert mc == pytest.approx(T.parametric_var(port, 0.95), rel=0.08)

    def test_mc_var_returns_cvar_pair(self):
        r = normal_returns()[:, None] * np.ones((1, 2))
        v, cv = T.monte_carlo_var(r, 0.95, n_samples=50_000,
                                  return_cvar=True, device=CPU)
        assert cv > v > 0

    def test_sharpe_and_sortino(self):
        r = normal_returns(n_days=60_000, mu=0.001, sd=0.01)
        s = T.sharpe_ratio(r)
        assert s == pytest.approx(0.001 / 0.01 * np.sqrt(252), rel=0.25)
        assert T.sortino_ratio(r) > s

    def test_max_drawdown_known_path(self):
        r = np.array([0.10, -0.50, 0.10])
        assert T.max_drawdown(r) == pytest.approx(0.50)

    def test_risk_attribution_sums_to_volatility(self):
        cov = np.array([[0.04, 0.01], [0.01, 0.09]])
        w = np.array([0.6, 0.4])
        att = T.risk_attribution(w, cov)
        assert att["contribution"].sum() == pytest.approx(att["volatility"])
        assert att["pct_contribution"].sum() == pytest.approx(1.0)

    def test_volatility_and_cov_shapes(self):
        r = T.generate_returns(5, 300, seed=1)
        assert trm.covariance_matrix(r).shape == (5, 5)
        assert trm.volatility(r).shape == (5,)
        assert np.isscalar(trm.volatility(r[:, 0]))

    def test_analyzer_facade_methods(self):
        r = normal_returns()
        an = T.RiskMetricsAnalyzer(device=CPU)
        assert an.calculate_var(r, 0.95) == T.historical_var(r, 0.95)
        assert an.calculate_var(r, 0.95, "parametric") == \
            T.parametric_var(r, 0.95)
        assert an.calculate_cvar(r) == T.cvar(r)
        with pytest.raises(ValueError):
            an.calculate_var(r, 0.95, "nope")


class TestPortfolioOptimization:
    def cov2(self):
        return np.array([[0.04, 0.006], [0.006, 0.01]])

    def test_projection_properties(self):
        w = tp.project_to_simplex(np.array([3.0, -1.0, 0.2]), 0.6)
        assert w.sum() == pytest.approx(1.0)
        assert (w >= -1e-12).all() and (w <= 0.6 + 1e-9).all()
        with pytest.raises(ValueError):
            tp.project_to_simplex(np.ones(3), 0.2)

    def test_min_variance_prefers_low_vol_asset(self):
        res = T.mean_variance_optimize(np.array([0.0, 0.0]), self.cov2(),
                                       risk_aversion=1e6)
        assert res["weights"][1] > 0.85
        assert res["volatility"] == pytest.approx(
            np.sqrt(res["weights"] @ self.cov2() @ res["weights"]))

    def test_target_return_is_met(self):
        mu = np.array([0.10, 0.02])
        res = T.mean_variance_optimize(mu, self.cov2(), target_return=0.06)
        assert res["expected_return"] >= 0.06 - 1e-4
        assert res["weights"][0] >= 0.49

    def test_max_weight_constraint_binds(self):
        mu = np.array([0.10, 0.02, 0.02])
        cov = np.diag([0.01, 0.01, 0.01])
        res = T.mean_variance_optimize(mu, cov, None, max_weight=0.5,
                                       risk_aversion=0.1)
        assert res["weights"][0] == pytest.approx(0.5, abs=1e-6)

    def test_efficient_frontier_monotone_vol(self):
        mu = np.array([0.02, 0.06, 0.10])
        cov = np.diag([0.01, 0.02, 0.05]) + 0.002
        ef = T.efficient_frontier(mu, cov, n_points=8)
        assert ef["volatilities"].shape == (8,)
        assert (np.diff(ef["volatilities"]) >= -1e-6).all()

    def test_risk_parity_equalizes_contributions(self):
        cov = np.array([[0.09, 0.009, 0.0],
                        [0.009, 0.01, 0.002],
                        [0.0, 0.002, 0.04]])
        rp = T.risk_parity(cov)
        assert np.allclose(rp["risk_contributions"], 1.0 / 3.0, atol=1e-4)
        assert rp["weights"].sum() == pytest.approx(1.0)

    def test_black_litterman_no_views_is_equilibrium(self):
        cov = self.cov2()
        w = np.array([0.5, 0.5])
        bl = T.black_litterman(w, cov)
        assert np.allclose(bl["posterior_returns"], 2.5 * cov @ w)

    def test_black_litterman_view_moves_posterior(self):
        cov = self.cov2()
        w = np.array([0.5, 0.5])
        pi = 2.5 * cov @ w
        bl = T.black_litterman(w, cov, views_P=[[1.0, 0.0]], views_Q=[0.10])
        assert bl["posterior_returns"][0] > pi[0]

    def test_monte_carlo_simulation_stats(self):
        mu = np.array([0.0004, 0.0004])
        cov = 1e-4 * np.eye(2)
        sim = T.monte_carlo_simulation(np.array([0.5, 0.5]), mean=mu,
                                       cov=cov, n_paths=4000, horizon=252,
                                       device=CPU)
        assert sim["terminal_wealth"].shape == (4000,)
        assert sim["terminal_wealth"].dtype == np.float64
        assert sim["mean"] == pytest.approx(1.106, rel=0.05)
        assert 0.0 <= sim["prob_loss"] <= 1.0

    def test_optimizer_facade_matches_ref_call_shape(self):
        mu = np.array([0.08, 0.05, 0.03])
        cov = np.diag([0.04, 0.02, 0.01])
        res = T.PortfolioOptimizer(device=CPU).optimize(
            expected_returns=mu, cov_matrix=cov, target_return=0.05,
            constraints={"max_weight": 0.5})
        w = res.get("weights")
        assert w is not None and w.sum() == pytest.approx(1.0)
        assert (w <= 0.5 + 1e-9).all()


class TestOptionsPricing:
    def test_black_scholes_known_values(self):
        assert T.black_scholes(100, 100, 1.0, 0.05, 0.2, device=CPU) == \
            pytest.approx(10.4506, abs=2e-3)
        assert T.black_scholes(100, 100, 1.0, 0.05, 0.2, "put",
                               device=CPU) == pytest.approx(5.5735, abs=2e-3)

    def test_put_call_parity_batched(self):
        s = np.array([80.0, 100.0, 120.0])
        c = T.black_scholes(s, 100, 0.5, 0.03, 0.25, device=CPU)
        p = T.black_scholes(s, 100, 0.5, 0.03, 0.25, "put", device=CPU)
        assert np.allclose(c - p, s - 100 * np.exp(-0.03 * 0.5), atol=1e-3)

    def test_greeks_against_closed_form(self):
        g = T.greeks(100, 100, 1.0, 0.05, 0.2, device=CPU)
        assert g["delta"] == pytest.approx(0.6368, abs=2e-3)
        assert g["gamma"] == pytest.approx(0.01876, abs=5e-4)
        assert g["vega"] == pytest.approx(37.52, rel=0.01)
        assert g["theta"] == pytest.approx(-6.414, rel=0.02)
        assert g["rho"] == pytest.approx(53.23, rel=0.01)

    def test_binomial_converges_to_black_scholes(self):
        bt = T.binomial_tree(100, 100, 1.0, 0.05, 0.2, n_steps=400,
                             device=CPU)
        assert bt == pytest.approx(10.4506, rel=5e-3)

    def test_american_put_premium(self):
        eu = T.binomial_tree(100, 110, 1.0, 0.08, 0.2, kind="put",
                             n_steps=200, device=CPU)
        am = T.binomial_tree(100, 110, 1.0, 0.08, 0.2, kind="put",
                             n_steps=200, american=True, device=CPU)
        assert am > eu

    def test_monte_carlo_matches_bs(self):
        mc = T.monte_carlo_price(100, 100, 1.0, 0.05, 0.2, n_paths=200_000,
                                 device=CPU)
        assert mc["price"] == pytest.approx(10.4506,
                                            abs=4 * mc["stderr"] + 0.05)

    def test_barrier_bounded_by_vanilla(self):
        van = T.black_scholes(100, 100, 1.0, 0.05, 0.2, device=CPU)
        uo = T.barrier_option_price(100, 100, 130.0, 1.0, 0.05, 0.2,
                                    n_paths=20_000, device=CPU)
        assert 0.0 < uo["price"] < van
        assert 0.0 < uo["knock_prob"] < 1.0

    def test_asian_cheaper_than_vanilla_call(self):
        van = T.black_scholes(100, 100, 1.0, 0.05, 0.2, device=CPU)
        asian = T.asian_option_price(100, 100, 1.0, 0.05, 0.2,
                                     n_paths=20_000, device=CPU)
        assert 0.0 < asian["price"] < van


class TestGeoRiskWiring:
    def make_portfolio(self):
        rng = np.random.default_rng(7)
        p = T.GeospatialPortfolio()
        risk_surface = np.tile(
            np.linspace(1.0, 0.0, 64)[:, None], (1, 64)).astype(np.float32)
        model = T.GeospatialRiskModel(
            [T.SpatialRiskFactor("elev", 1.0, risk_surface)])
        for i, (y, mu) in enumerate([(2.0, 0.0002), (60.0, 0.0006),
                                     (50.0, 0.0004)]):
            p.add_asset(f"a{i}", f"A{i}", 100.0 * (i + 1), 32.0, y,
                        {"asset_class": "default"},
                        returns=rng.normal(mu, 0.01, 300))
        return p, model

    def test_calculate_var_from_returns(self):
        p, _ = self.make_portfolio()
        v = p.calculate_var(0.95, lookback_days=252)
        assert 0.001 < v < 0.05

    def test_calculate_var_insufficient_history_raises(self):
        p, _ = self.make_portfolio()
        p.add_asset("short", "S", 10.0, 1.0, 1.0, returns=[0.01] * 10)
        with pytest.raises(ValueError, match="insufficient returns"):
            p.calculate_var(0.95, lookback_days=252)

    def test_optimize_for_geo_risk_excludes_risky(self):
        p, model = self.make_portfolio()
        w = p.optimize_for_geo_risk(model, target_return=0.0002,
                                    max_risk_score=0.5, lookback_days=252,
                                    max_weight=1.0)
        assert set(w) == {"a0", "a1", "a2"}
        assert w["a0"] == 0.0
        assert sum(w.values()) == pytest.approx(1.0)

    def test_optimize_all_excluded_raises(self):
        p, model = self.make_portfolio()
        with pytest.raises(ValueError, match="no assets"):
            p.optimize_for_geo_risk(model, 0.0, max_risk_score=-1.0)

    @pytest.mark.parametrize("method", ["historical", "parametric",
                                        "monte_carlo"])
    def test_wiring_equals_jax(self, method):
        p, model = self.make_portfolio()
        jp_ = J.GeospatialPortfolio()
        for a in p.assets:
            jp_.add_asset(a.id, a.name, a.value, a.x, a.y, a.metadata,
                          returns=a.returns)
        jm = J.GeospatialRiskModel([J.SpatialRiskFactor(
            "elev", 1.0, model.risk_factors[0].risk_data)])
        assert p.calculate_var(0.95, method=method) == \
            jp_.calculate_var(0.95, method=method)
        assert_same(p.optimize_for_geo_risk(model, 0.0002, max_weight=1.0),
                    jp_.optimize_for_geo_risk(jm, 0.0002, max_weight=1.0))

