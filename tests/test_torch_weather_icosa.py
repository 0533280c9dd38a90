"""The port's icosahedral core (njw_tpu_torch.weather.icosa) held against
the JAX package's, and the JAX package's own icosahedral tests
(tests/test_weather_icosa.py) run on the port.

The geometry and operator weights are computed in float64 NumPy by both
packages and are equal; the halo exchange is equal; the operators and
tendencies agree to float32 rounding (normalised 1e-5), and a 20-step
RK4 run at 1e-5 of the scale of h and V.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.weather import icosa as J  # noqa: E402
from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402

from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402
from njw_tpu_torch.weather.icosa import (  # noqa: E402
    IcosaSWEState, advection_tendency, build_operators, cell_centers,
    divergence, gaussian_hill, gradient, gradient_vec, laplacian,
    make_icosa_sim, pad_halo, pad_halo_np, panel_vertices,
    solid_body_velocity, swe_tendencies_icosa, uv_from_cartesian,
    williamson2_icosa,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_OPS: dict = {}


def _ops(n, radius=J.EARTH_RADIUS):
    key = (n, radius)
    if key not in _OPS:
        _OPS[key] = (J.build_operators(n, radius=radius),
                     build_operators(n, radius=radius, device=CPU))
    return _OPS[key]


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hill_state(j, t, amp=50.0):
    js = J.williamson2_icosa(j)
    h = np.asarray(js.h) + amp * np.asarray(J.gaussian_hill(j, lat0=0.4))
    return (J.IcosaSWEState(V=js.V, h=jnp.asarray(h)),
            IcosaSWEState(V=_t(js.V), h=_t(h)))


class TestAgainstJax:
    @pytest.mark.parametrize("n", [8, 16])
    def test_geometry_and_operators(self, n):
        np.testing.assert_array_equal(panel_vertices(n), J.panel_vertices(n))
        np.testing.assert_array_equal(cell_centers(n), J.cell_centers(n))
        j, t = _ops(n)
        for name in ("w", "r", "east", "north", "radius"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)))

    @pytest.mark.parametrize("trail", [(), (3,)])
    def test_pad_halo(self, trail):
        rng = np.random.default_rng(0)
        f = rng.standard_normal((10, 8, 8) + trail).astype(np.float32)
        want = np.asarray(J.pad_halo(jnp.asarray(f)))
        got = pad_halo(_t(f))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(pad_halo_np(f), J.pad_halo(f, xp=np))

    def test_pad_halo_leaves_input(self):
        f = torch.arange(10 * 4 * 4, dtype=torch.float32).reshape(10, 4, 4)
        before = f.clone()
        pad_halo(f)
        assert torch.equal(f, before)

    @pytest.mark.parametrize("n", [8, 16])
    def test_operators(self, n):
        j, t = _ops(n)
        rng = np.random.default_rng(n)
        f = rng.standard_normal((10, n, n)).astype(np.float32)
        V = rng.standard_normal((10, n, n, 3)).astype(np.float32)
        _close(gradient(_t(f), t), J.gradient(jnp.asarray(f), j))
        _close(gradient_vec(_t(V), t), J.gradient_vec(jnp.asarray(V), j))
        _close(divergence(_t(V), t), J.divergence(jnp.asarray(V), j))
        _close(laplacian(_t(f), t), J.laplacian(jnp.asarray(f), j))

    @pytest.mark.parametrize("nu", [0.0, 1e5])
    def test_tendencies(self, nu):
        j, t = _ops(16)
        js, ts = _hill_state(j, t)
        jt = J.swe_tendencies_icosa(js, j, nu=nu)
        tt = swe_tendencies_icosa(ts, t, nu=nu)
        _close(tt.V, jt.V)
        _close(tt.h, jt.h)

    def test_initial_conditions(self):
        j, t = _ops(16)
        for jf, tf in ((J.williamson2_icosa(j), williamson2_icosa(t)),):
            np.testing.assert_array_equal(tf.h.numpy(), np.asarray(jf.h))
            np.testing.assert_array_equal(tf.V.numpy(), np.asarray(jf.V))
        _close(gaussian_hill(t, lon0=0.5, lat0=0.2, width=0.4),
               J.gaussian_hill(j, lon0=0.5, lat0=0.2, width=0.4), atol=1e-6)

    @pytest.mark.parametrize("ic,kw", [("williamson2", {}),
                                       ("gaussian", {"amplitude": 50.0})])
    def test_simulation_run(self, ic, kw):
        """20 RK4 steps through both packages' Simulation.from_config."""
        cfg = dict(model="shallow_water", grid_type="icosahedral",
                   grid_height=8, grid_width=8, dt=900.0, viscosity=1e5)
        jsim = JSimulation.from_config(JSimConfig(**cfg), ic, **kw)
        sim = Simulation.from_config(SimConfig(device=CPU, **cfg), ic, **kw)
        jsim.step(20)
        sim.step(20)
        _close(sim.state.h, jsim.state.h)
        _close(sim.state.V, jsim.state.V)
        jo, to = jsim.output_fn(jsim.state), sim.output_fn(sim.state)
        scale = max(np.abs(np.asarray(jo[k])).max() for k in ("u", "v"))
        for k in ("u", "v"):
            np.testing.assert_allclose(to[k].numpy() / scale,
                                       np.asarray(jo[k]) / scale, rtol=0,
                                       atol=1e-5)


def test_grid_geometry():
    n = 8
    v = panel_vertices(n)
    c = cell_centers(n)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(c, axis=-1), 1.0, atol=1e-12)
    assert np.unique(np.round(v.reshape(-1, 3), 9), axis=0).shape[0] == \
        10 * n * n + 2
    assert np.unique(np.round(c.reshape(-1, 3), 9), axis=0).shape[0] == \
        10 * n * n
    with pytest.raises(ValueError):
        panel_vertices(12)


def test_halo_matches_coords():
    """Every halo slot holds the coordinates of a real cell adjacent to
    the edge cell it neighbours (the torch exchange on the centres)."""
    n = 8
    c = cell_centers(n)
    pc = pad_halo(torch.from_numpy(c)).numpy()
    allc = c.reshape(-1, 3)
    h = np.linalg.norm(c[0, 0, 0] - c[0, 0, 1])
    for p in range(10):
        slots = ([(0, j) for j in range(1, n + 1)]
                 + [(n + 1, j) for j in range(1, n + 1)]
                 + [(i, 0) for i in range(1, n + 1)]
                 + [(i, n + 1) for i in range(1, n + 1)])
        for (ii, jj) in slots:
            x = pc[p, ii, jj]
            assert np.linalg.norm(allc - x, axis=1).min() < 1e-12
            si, sj = min(max(ii, 1), n), min(max(jj, 1), n)
            assert np.linalg.norm(x - pc[p, si, sj]) < 1.6 * h


def test_gradient_exact_on_linear_fields():
    _, ops = _ops(16, 1.0)
    r = ops.r.numpy().astype(np.float64)
    g3 = np.array([0.3, -1.1, 0.7])
    got = gradient(torch.from_numpy((r @ g3).astype(np.float32)),
                   ops).numpy().astype(np.float64)
    np.testing.assert_allclose(got, g3 - (r @ g3)[..., None] * r, atol=5e-5)


def test_divergence_of_solid_body_is_zero():
    _, ops = _ops(16, 1.0)
    d = divergence(solid_body_velocity(ops, 1.0), ops)
    assert float(d.abs().max()) < 5e-4


def test_gradient_second_order_convergence():
    errs = []
    for n in (8, 16):
        _, ops = _ops(n, 1.0)
        r = ops.r.numpy().astype(np.float64)
        got = gradient(torch.from_numpy(r[..., 2].astype(np.float32)),
                       ops).numpy().astype(np.float64)
        want = np.array([0.0, 0.0, 1.0]) - r[..., 2:3] * r
        errs.append(np.sqrt(((got - want) ** 2).sum(-1)).mean())
    assert errs[1] < 1e-4


def _rk4(rhs, s, dt, steps):
    for _ in range(steps):
        k1 = rhs(s)
        k2 = rhs(s.map(lambda a, k: a + 0.5 * dt * k, k1))
        k3 = rhs(s.map(lambda a, k: a + 0.5 * dt * k, k2))
        k4 = rhs(s.map(lambda a, k: a + dt * k, k3))
        comb = k1.map(lambda a, b, c, d: a + 2 * b + 2 * c + d, k2, k3, k4)
        s = s.map(lambda a, c: a + dt / 6.0 * c, comb)
    return s


def test_tc1_advection_matches_analytic_rotation():
    _, ops = _ops(16, 1.0)
    V = solid_body_velocity(ops, 1.0)
    q = gaussian_hill(ops, lon0=0.0, lat0=0.3, width=0.5)
    dt = 0.02
    for _ in range(50):
        k1 = advection_tendency(q, V, ops)
        k2 = advection_tendency(q + 0.5 * dt * k1, V, ops)
        k3 = advection_tendency(q + 0.5 * dt * k2, V, ops)
        k4 = advection_tendency(q + dt * k3, V, ops)
        q = q + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    q_exact = gaussian_hill(ops, lon0=1.0, lat0=0.3, width=0.5).numpy()
    rel = np.sqrt(((q.numpy() - q_exact) ** 2).mean()) / np.sqrt(
        (q_exact ** 2).mean())
    assert rel < 0.05, rel


def test_tc2_steady_state_stays_steady():
    _, ops = _ops(16)
    s0 = williamson2_icosa(ops)
    s_end = _rk4(lambda x: swe_tendencies_icosa(x, ops), s0, 600.0, 144)
    h0, h1 = s0.h.numpy(), s_end.h.numpy()
    assert np.isfinite(h1).all()
    rel = np.sqrt(((h1 - h0) ** 2).mean()) / np.sqrt((h0 ** 2).mean())
    assert rel < 2e-3, rel
    vr = (s_end.V * ops.r).sum(-1).abs()
    assert float(vr.max()) < 1e-3 * float(s_end.V.abs().max())


def test_icosa_sim_and_output():
    cfg = SimConfig(model="shallow_water", grid_type="icosahedral",
                    grid_height=8, grid_width=8, dt=900.0, max_steps=8,
                    output_interval=4, device=CPU)
    sim = make_icosa_sim(Simulation, cfg, "gaussian", device=CPU,
                         amplitude=50.0)
    sim.run(8, output_interval=4)
    snap = sim.snapshots[-1]
    assert snap["h"].shape == (10, 8, 8)
    assert np.isfinite(snap["h"]).all() and np.isfinite(snap["u"]).all()
    assert snap["u"].mean() > 0.0


def test_uv_projection_roundtrip():
    _, ops = _ops(8)
    u, v = uv_from_cartesian(solid_body_velocity(ops, 10.0), ops)
    lat = np.arcsin(ops.r[..., 2].numpy())
    np.testing.assert_allclose(u.numpy(), 10.0 * np.cos(lat), atol=1e-3)
    np.testing.assert_allclose(v.numpy(), 0.0, atol=1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(model="barotropic"), "shallow_water core"),
    (dict(backend="kernel"), "cartesian grid")])
def test_refusals(kw, match):
    cfg = SimConfig(**{**dict(grid_type="icosahedral", grid_height=8,
                              grid_width=8, device=CPU), **kw})
    with pytest.raises(ValueError, match=match):
        Simulation.from_config(cfg, "williamson2")


def test_unknown_ic():
    cfg = SimConfig(grid_type="icosahedral", grid_height=8, grid_width=8,
                    device=CPU)
    with pytest.raises(ValueError, match="unknown icosahedral IC"):
        Simulation.from_config(cfg, "jet_stream")


def test_cli_icosahedral():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--device", "cpu", "--grid-type", "icosahedral",
                       "--height", "8", "--width", "8", "--dt", "450",
                       "--steps", "3", "--initial", "gaussian", "--json"])
    assert rc == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])[
        "num_steps"] == 2
