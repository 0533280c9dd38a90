"""The port's C-grid core (njw_tpu_torch.weather.staggered) held against
the JAX package's, and the JAX package's own C-grid tests
(tests/test_weather_staggered.py) run on the port.

The same NumPy state goes through both packages on the CPU. The
tendencies agree to float32 rounding (rtol 1e-5 / atol 1e-6 of the
field's scale); the invariants carry the JAX tests' bounds.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.weather import GridSpec as JGrid  # noqa: E402
from njw_tpu.weather import PhysicsParams as JParams  # noqa: E402
from njw_tpu.weather import WeatherState as JState  # noqa: E402
from njw_tpu.weather import staggered as jst  # noqa: E402

from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, WeatherState,
    make_stepper, make_tendency_fn,
)
from njw_tpu_torch.weather import staggered as st  # noqa: E402
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402
from njw_tpu_torch.weather.dynamics import swe_tendencies  # noqa: E402

CPU = "cpu"
GRID = GridSpec(nx=64, ny=64, grid_type="staggered")
PARAMS = PhysicsParams(coriolis_f=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_fields(ny, nx, amp=0.2, depth=10.0, seed=3):
    """tests/test_weather_staggered.py's smooth periodic state, as numpy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    f = np.zeros((ny, nx))
    g = np.zeros_like(f)
    hh = np.zeros_like(f)
    for _ in range(4):
        ky, kx = rng.integers(1, 4, 2)
        py, px = rng.uniform(0, 2 * np.pi, 2)
        f += rng.normal() * np.sin(2 * np.pi * ky * y / ny + py) \
            * np.cos(2 * np.pi * kx * x / nx + px)
        g += rng.normal() * np.cos(2 * np.pi * kx * y / ny + px) \
            * np.sin(2 * np.pi * ky * x / nx + py)
        hh += rng.normal() * np.sin(2 * np.pi * kx * x / nx + py) \
            * np.sin(2 * np.pi * ky * y / ny + px)
    return {"u": (amp * f).astype(np.float32),
            "v": (amp * g).astype(np.float32),
            "h": (depth + amp * hh).astype(np.float32)}


def _state(d):
    return WeatherState(**{k: torch.from_numpy(v.copy()) for k, v in d.items()})


def _rk4_run(s, grid, params, dt, n):
    step = make_stepper("rk4", lambda x: st.swe_tendencies_cgrid(
        x, grid, params)).step
    for _ in range(n):
        _, s = step((), s, float(np.float32(dt)))
    return s


class TestAgainstJax:
    @pytest.mark.parametrize("shape,nu,f", [
        ((64, 64), 0.0, 1e-4), ((24, 40), 0.05, 0.3), ((17, 9), 0.0, 0.0)])
    def test_tendencies(self, shape, nu, f):
        d = _smooth_fields(*shape, amp=0.5)
        kw = dict(nx=shape[1], ny=shape[0], dx=2.0, dy=0.5,
                  grid_type="staggered")
        jt = jst.swe_tendencies_cgrid(
            JState(**{k: jnp.asarray(v) for k, v in d.items()}), JGrid(**kw),
            JParams(coriolis_f=f, viscosity=nu))
        tt = st.swe_tendencies_cgrid(_state(d), GridSpec(**kw),
                                     PhysicsParams(coriolis_f=f,
                                                   viscosity=nu))
        for k in ("u", "v", "h"):
            want = np.asarray(getattr(jt, k))
            np.testing.assert_allclose(getattr(tt, k).numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())

    def test_invariants(self):
        d = _smooth_fields(64, 64)
        js = JState(**{k: jnp.asarray(v) for k, v in d.items()})
        jg = JGrid(nx=64, ny=64, grid_type="staggered")
        jp = JParams(coriolis_f=1e-4)
        for name in ("potential_enstrophy", "total_energy"):
            want = float(getattr(jst, name)(js, jg, jp))
            got = float(getattr(st, name)(_state(d), GRID, PARAMS))
            assert got == pytest.approx(want, rel=1e-5)

    def test_geostrophic_state(self):
        """h equals JAX's; u and v follow the discrete relations on the
        (ny, nx) grid. The JAX function broadcasts its fields to
        (ny, 1, nx) (its coordinates are already 2-D), so that its
        y-differences run along a unit axis; the port keeps (ny, nx) and
        is held to a NumPy evaluation of the same relations."""
        grid = GridSpec(nx=32, ny=16, dx=1e4, dy=2e4, grid_type="staggered")
        params = PhysicsParams(coriolis_f=1e-4)
        s = st.geostrophic_balance_state(grid, params, amplitude=0.1,
                                         device=CPU)
        jh = np.asarray(jst.geostrophic_balance_state(
            JGrid(nx=32, ny=16, dx=1e4, dy=2e4, grid_type="staggered"),
            JParams(coriolis_f=1e-4), amplitude=0.1).h)
        assert s.h.shape == (16, 32)
        np.testing.assert_allclose(s.h.numpy(), jh.reshape(16, 32),
                                   rtol=1e-6)
        h = s.h.numpy().astype(np.float64)
        roll = np.roll
        dhdy = (roll(h, -1, 0) - h) / 2e4               # at v points
        dhdx = (roll(h, -1, 1) - h) / 1e4               # at u points
        avx = lambda a: 0.5 * (a + roll(a, -1, 1))
        avy = lambda a: 0.5 * (a + roll(a, -1, 0))
        avxm = lambda a: 0.5 * (a + roll(a, 1, 1))
        avym = lambda a: 0.5 * (a + roll(a, 1, 0))
        k = 9.81 / 1e-4
        np.testing.assert_allclose(s.u.numpy(), -k * avx(avym(dhdy)),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(s.v.numpy(), k * avy(avxm(dhdx)),
                                   rtol=1e-4, atol=1e-6)

    def test_rk4_run_matches_jax(self):
        from njw_tpu.weather.integrators import make_stepper as jmake

        d = _smooth_fields(32, 32)
        jg = JGrid(nx=32, ny=32, grid_type="staggered")
        jp = JParams(coriolis_f=1e-4)
        jstep = jmake("rk4", lambda x: jst.swe_tendencies_cgrid(x, jg, jp))
        js = JState(**{k: jnp.asarray(v) for k, v in d.items()})
        for _ in range(20):
            _, js = jstep.step((), js, jnp.float32(0.005))
        grid = GridSpec(nx=32, ny=32, grid_type="staggered")
        ts = _rk4_run(_state(d), grid, PARAMS, 0.005, 20)
        for k in ("u", "v", "h"):
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(js, k)),
                                       rtol=1e-5, atol=1e-6)


class TestConservation:
    def test_mass_tendency_is_exactly_zero(self):
        t = st.swe_tendencies_cgrid(_state(_smooth_fields(64, 64)), GRID,
                                    PARAMS)
        dh = t.h.numpy().astype(np.float64)
        assert abs(dh.sum()) < 1e-3 * np.abs(dh).sum()

    def test_mass_conserved_over_run(self):
        s = _state(_smooth_fields(64, 64))
        m0 = float(s.h.double().sum())
        s = _rk4_run(s, GRID, PARAMS, 0.005, 200)
        assert torch.isfinite(s.h).all()
        assert abs(float(s.h.double().sum()) - m0) / m0 < 1e-6

    @pytest.mark.parametrize("name", ["total_energy", "potential_enstrophy"])
    def test_invariant_near_conserved(self, name):
        """Energy and potential enstrophy hold within 5e-3 over 500 RK4
        steps (the JAX tests' bound)."""
        fn = getattr(st, name)
        s = _state(_smooth_fields(64, 64))
        e0 = float(fn(s, GRID, PARAMS))
        s = _rk4_run(s, GRID, PARAMS, 0.005, 500)
        e1 = float(fn(s, GRID, PARAMS))
        assert abs(e1 - e0) / abs(e0) < 5e-3


class TestBalanceAndModes:
    def test_geostrophic_state_stays_balanced(self):
        grid = GridSpec(nx=64, ny=64, dx=1e4, dy=1e4, grid_type="staggered")
        params = PhysicsParams(coriolis_f=1e-4)
        amp = 0.1
        s0 = st.geostrophic_balance_state(grid, params, amplitude=amp,
                                          device=CPU)
        s = _rk4_run(s0, grid, params, dt=50.0, n=200)
        assert float((s.h - s0.h).abs().max()) < 0.15 * amp

    def test_cgrid_sees_checkerboard_the_agrid_cannot(self):
        y, x = np.mgrid[0:32, 0:32]
        checker = torch.from_numpy(
            10.0 + 0.5 * ((-1.0) ** (x + y)).astype(np.float32))
        z = torch.zeros(32, 32)
        s = WeatherState(u=z, v=z, h=checker)
        t_a = swe_tendencies(s, GridSpec(nx=32, ny=32), PhysicsParams())
        assert float(t_a.u.abs().max()) < 1e-6
        t_c = st.swe_tendencies_cgrid(
            s, GridSpec(nx=32, ny=32, grid_type="staggered"), PhysicsParams())
        assert float(t_c.u.abs().max()) > 1.0


class TestSimulationIntegration:
    def test_make_tendency_fn_dispatches(self):
        d = _smooth_fields(16, 16)
        got = make_tendency_fn("general", GridSpec(
            nx=16, ny=16, grid_type="staggered"), PARAMS)(_state(d))
        want = st.swe_tendencies_cgrid(_state(d), GridSpec(
            nx=16, ny=16, grid_type="staggered"), PARAMS)
        assert torch.equal(got.h, want.h) and torch.equal(got.u, want.u)

    def test_simulation_runs_and_conserves_mass(self):
        cfg = SimConfig(grid_width=64, grid_height=64, dt=0.005,
                        grid_type="staggered", coriolis_f=1e-4, device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        assert sim.stepper.name == "rk4"   # no kernel for the C-grid
        m0 = float(sim.state.h.double().sum())
        sim.step(100)
        assert torch.isfinite(sim.state.h).all()
        assert abs(float(sim.state.h.double().sum()) - m0) / m0 < 1e-6

    def test_kernel_backend_refuses_the_cgrid(self):
        cfg = SimConfig(grid_width=16, grid_height=16, grid_type="staggered",
                        backend="kernel", device=CPU)
        with pytest.raises(ValueError, match="cartesian grid"):
            Simulation.from_config(cfg, "vortex")

    def test_nonperiodic_staggered_rejected(self):
        with pytest.raises(ValueError, match="periodic-only"):
            GridSpec(nx=32, ny=32, grid_type="staggered",
                     bc="clamped").validate()

    def test_unknown_grid_type_rejected(self):
        with pytest.raises(ValueError, match="unknown grid type"):
            GridSpec(nx=32, ny=32, grid_type="icosahedral").validate()

    def test_cli(self):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--device", "cpu", "--grid-type", "staggered",
                           "--width", "32", "--height", "32", "--steps", "5",
                           "--dt", "0.005", "--coriolis", "1e-4", "--json"])
        assert rc == 0
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert m["num_steps"] == 4
