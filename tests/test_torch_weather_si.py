"""The port's semi-implicit steppers (njw_tpu_torch.weather.semi_implicit)
held against the JAX package's, and the JAX package's own semi-implicit
physics tests run on the port (tests/test_weather_swe.py:103-121,
tests/test_weather_primitive.py:448-503).

The same initial state (made by the JAX package, carried across as numpy)
goes through both packages' ``Simulation`` on the CPU. Differences are
normalised by the scale of each field's group (the largest |value| of the
winds u, v together; of each other field alone): a zonal jet's v is a
Coriolis by-product four orders of magnitude below u, and the FFT
rounding it carries is the winds'. Bounds: 1e-5 after one step, 1e-4
after 20. The one-step bound sits at float32's floor for the PE solve
(u' = u* - a i k P' cancels terms some 25 times larger than u): JAX's
own order-2 step moves by 1.0e-5 when every input moves by one ulp
(48 x 32 x 5, u_jet 8, perturb 0.5, dt 240), so the one-step PE case
runs the unperturbed jet at the pe_si path's dt of 450 s, where the port
is 3.6e-6 (order 1) and 7.8e-6 (order 2) from JAX after one step. That
jet does not vary in x, so the perturbed jet is compared too, after 20
steps.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402

from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, make_tendency_fn,
)
from njw_tpu_torch.weather.convert import (  # noqa: E402
    pe_state_from_numpy, state_from_numpy,
)
from njw_tpu_torch.weather.semi_implicit import (  # noqa: E402
    _pe_vertical_matrices, semi_implicit_pe, semi_implicit_swe,
)
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402

CPU = "cpu"
SWE = dict(grid_width=64, grid_height=64, dt=0.2, coriolis_f=1e-4)
PE = dict(model="primitive", grid_width=48, grid_height=32, num_levels=5,
          dx=1e5, dy=1e5, coriolis_f=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normalised(got: dict, want: dict) -> dict:
    """max |got - want| per field over its group's scale (see the module
    docstring)."""
    def scale(name):
        group = ("u", "v") if name in ("u", "v") else (name,)
        return max(float(np.abs(want[g]).max()) for g in group) + 1e-30

    return {k: float(np.abs(got[k] - want[k]).max()) / scale(k)
            for k in want}


def _jax_numpy(state) -> dict:
    """A JAX WeatherState (which has to_numpy) or PEState as numpy."""
    if hasattr(state, "to_numpy"):
        return state.to_numpy()
    return {k: np.asarray(getattr(state, k)) for k in ("u", "v", "T", "q",
                                                         "ps")}


def _pair(model_kw, ic, ic_kw, order, dt):
    """The JAX and the port's semi-implicit Simulation from the JAX
    package's initial state."""
    cfg = dict(model_kw, dt=dt, integration_method="semi_implicit",
               si_order=order)
    j = JSimulation.from_config(JSimConfig(**cfg), ic, **ic_kw)
    t = Simulation.from_config(SimConfig(device=CPU, **cfg), ic, **ic_kw)
    s0 = _jax_numpy(j.state)
    if cfg.get("model") == "primitive":
        t.state = pe_state_from_numpy(s0, CPU)
    else:
        t.state = state_from_numpy(s0, CPU)
    return j, t


class TestAgainstJax:
    @pytest.mark.parametrize("order", [1, 2])
    @pytest.mark.parametrize("core", ["swe", "pe"])
    def test_one_and_twenty_steps(self, core, order):
        if core == "swe":
            j, t = _pair(SWE, "jet_stream", {"strength": 2.0}, order, 0.2)
        else:
            j, t = _pair(PE, "baroclinic", {"u_jet": 8.0}, order, 450.0)
        assert t.stepper.name == j.stepper.name == "semi_implicit"
        for n, total, bound in ((1, 1, 1e-5), (19, 20, 1e-4)):
            j.step(n)
            t.step(n)
            diffs = _normalised(t.state.to_numpy(), _jax_numpy(j.state))
            assert max(diffs.values()) <= bound, (total, diffs)

    @pytest.mark.parametrize("order", [1, 2])
    def test_perturbed_pe_twenty_steps(self, order):
        """The PE solve's x half (i kx in the divergence and the wind
        update, kx^2 in |k|^2), which the unperturbed jet leaves at zero:
        the perturbed jet's winds vary in x (by 1.2e-2 to 1.5e-2 of max|u|
        after 20 steps), and the port stays within 1e-4 of JAX (3.4e-5
        measured, order 2)."""
        j, t = _pair(PE, "baroclinic", {"u_jet": 8.0, "perturb": 0.5},
                     order, 450.0)
        j.step(20)
        t.step(20)
        want = _jax_numpy(j.state)
        for name in ("u", "v"):
            w = want[name]
            assert float(np.abs(w - w.mean(axis=-1, keepdims=True)).max()) \
                > 1e-3 * float(np.abs(w).max()), name
        diffs = _normalised(t.state.to_numpy(), want)
        assert max(diffs.values()) <= 1e-4, diffs

    def test_vertical_matrices_match_jax(self):
        from njw_tpu.weather.semi_implicit import (
            _pe_vertical_matrices as j_matrices,
        )

        for a, b, name in zip(_pe_vertical_matrices(8, 300.0, 1013.25),
                              j_matrices(8, 300.0, 1013.25),
                              ("G", "M", "V", "Vinv", "lam")):
            if name in ("V", "Vinv"):
                # eigenvectors are defined up to sign and order: compare
                # the operator they rebuild instead
                continue
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9,
                                       err_msg=name)
        G, M, V, Vinv, lam = _pe_vertical_matrices(8, 300.0, 1013.25)
        jG, jM, jV, jVinv, jlam = j_matrices(8, 300.0, 1013.25)
        np.testing.assert_allclose(V @ np.diag(lam) @ Vinv,
                                   jV @ np.diag(jlam) @ jVinv, rtol=1e-5,
                                   atol=1e-6)
        assert lam.max() < 0


def _swe(dt, method, **kw):
    return Simulation.from_config(
        SimConfig(grid_width=64, grid_height=64, dt=dt,
                  integration_method=method, device=CPU, **kw),
        "jet_stream", strength=2.0)


def _pe(dt, method="semi_implicit", ic="baroclinic", **ic_kw):
    return Simulation.from_config(
        SimConfig(dt=dt, integration_method=method, device=CPU, **PE),
        ic, **ic_kw)


def _finite(sim) -> bool:
    return all(bool(torch.isfinite(t).all()) for _, t in sim.state.items())


class TestPhysics:
    def test_swe_stable_beyond_explicit_cfl(self):
        """tests/test_weather_swe.py:103-121: the gravity-wave CFL at
        sqrt(g 10) ~ 9.9 m/s and dx = 1 is dt ~ 0.07; at dt = 0.2 the
        semi-implicit stepper stays finite over 50 steps, Euler does not."""
        si = _swe(0.2, "semi_implicit")
        si.step(50)
        assert _finite(si)
        eu = _swe(0.2, "euler")
        eu.step(50)
        assert not bool(torch.isfinite(eu.state.h).all())

    def test_pe_stable_beyond_explicit_cfl(self):
        """tests/test_weather_primitive.py:486-503: the Lamb mode limits
        explicit dt to ~240 s on this grid; at 900 s the semi-implicit
        stepper stays finite over 50 steps, Euler does not."""
        si = _pe(900.0, u_jet=5.0, perturb=0.5)
        si.step(50)
        assert _finite(si)
        eu = _pe(900.0, "euler", u_jet=5.0, perturb=0.5)
        eu.step(50)
        assert not bool(torch.isfinite(eu.state.ps).all())

    def test_pe_resting_state_stays_resting(self):
        """tests/test_weather_primitive.py:460-468 (the bound is float32
        FFT round-trip rounding)."""
        sim = _pe(600.0, ic="resting")
        sim.step(10)
        assert float(sim.state.u.abs().max()) < 3e-4
        assert float(sim.state.v.abs().max()) < 3e-4

    def test_pe_small_dt_consistent_with_rk4(self):
        """tests/test_weather_primitive.py:470-484: at dt << CFL both
        methods integrate the same equations."""
        si = _pe(5.0, u_jet=8.0, perturb=0.5)
        rk = _pe(5.0, "rk4", u_jet=8.0, perturb=0.5)
        si.step(40)
        rk.step(40)
        np.testing.assert_allclose(si.state.ps.numpy(), rk.state.ps.numpy(),
                                   rtol=2e-4)
        np.testing.assert_allclose(si.state.u.numpy(), rk.state.u.numpy(),
                                   atol=2e-2)

    def test_swe_small_dt_consistent_with_rk4(self):
        si = _swe(0.01, "semi_implicit", si_order=2)
        rk = _swe(0.01, "rk4")
        si.step(20)
        rk.step(20)
        np.testing.assert_allclose(si.state.h.numpy(), rk.state.h.numpy(),
                                   rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("bc", ["clamped", "outflow", "reflective"])
    @pytest.mark.parametrize("core", ["swe", "pe"])
    def test_non_periodic_raises(self, core, bc):
        grid = GridSpec(nx=16, ny=16, levels=3, bc=bc)
        ctor = semi_implicit_swe if core == "swe" else semi_implicit_pe
        with pytest.raises(NotImplementedError, match="periodic"):
            ctor(lambda s: s, grid=grid, params=PhysicsParams())

    @pytest.mark.parametrize("core", ["swe", "pe"])
    def test_order_3_raises(self, core):
        grid = GridSpec(nx=16, ny=16, levels=3)
        ctor = semi_implicit_swe if core == "swe" else semi_implicit_pe
        with pytest.raises(ValueError, match="order must be 1 or 2"):
            ctor(lambda s: s, grid=grid, params=PhysicsParams(), order=3)


class TestEntryPoints:
    def test_si_order_defaults_to_1(self):
        assert SimConfig().si_order == 1

    @pytest.mark.parametrize("order", [1, 2])
    def test_from_config_takes_the_order(self, order):
        """from_config's stepper is semi_implicit_swe(order=si_order)."""
        sim = _swe(0.2, "semi_implicit", si_order=order)
        cfg = sim.config
        grid, params = cfg.grid_spec(), cfg.physics()
        st = semi_implicit_swe(make_tendency_fn("shallow_water", grid,
                                                params),
                               grid=grid, params=params, order=order)
        s = sim.state
        for _ in range(2):
            _, s = st.step((), s, sim._dt_f32)
        sim.step(2)
        for name in ("u", "v", "h"):
            assert torch.equal(getattr(sim.state, name), getattr(s, name))

    def test_orders_differ(self):
        a, b = _swe(0.2, "semi_implicit"), _swe(0.2, "semi_implicit",
                                                  si_order=2)
        a.step(3)
        b.step(3)
        assert float((a.state.u - b.state.u).abs().max()) > 0

    def test_pe_from_config_runs_on_terrain(self):
        y, x = np.mgrid[0:32, 0:48].astype(np.float32)
        oro = 1000.0 * np.exp(-(((y - 15.5) / 4) ** 2 + ((x - 23.5) / 6)
                                ** 2))
        sim = Simulation.from_config(
            SimConfig(dt=600.0, integration_method="semi_implicit",
                      si_order=2, device=CPU, **PE),
            "baroclinic", u_jet=5.0, orography=oro)
        sim.step(5)
        assert sim.stepper.name == "semi_implicit" and _finite(sim)

    def test_cli_json_and_npz(self, tmp_path):
        path = tmp_path / "si.npz"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--device", "cpu", "--method", "semi_implicit",
                           "--si-order", "2", "--width", "32", "--height",
                           "32", "--dt", "0.2", "--steps", "5", "--initial",
                           "jet_stream", "--json", "--output", str(path)])
        assert rc == 0
        m = json.loads(buf.getvalue().strip().splitlines()[0])
        assert m["num_steps"] == 4
        with np.load(path) as z:
            assert np.isfinite(z["final_h"]).all()
