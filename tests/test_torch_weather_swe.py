"""The PyTorch port's shallow-water path held against the JAX package.

Inputs are made with numpy from a fixed seed and carried to both packages
(``njw_tpu_torch.weather.convert``); everything runs on the CPU. The
tolerances are the JAX package's own tests' (tests/test_weather_swe.py,
tests/test_weather_ics.py).
"""
import ast
import io
import json
import contextlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.weather import (  # noqa: E402
    GridSpec as JGrid, PhysicsParams as JParams, WeatherState as JState,
    diagnostics as j_diagnostics, make_initial_state as j_ic,
    make_tendency_fn as j_tendency_fn,
)
from njw_tpu.weather.integrators import make_stepper as j_make_stepper  # noqa: E402
from njw_tpu.weather.oracle import SWEOracle as JOracle  # noqa: E402

from njw_tpu_torch.platform import detect, get_device_info  # noqa: E402
from njw_tpu_torch.platform.device import spec_for  # noqa: E402
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, WeatherState,
    diagnostics, make_initial_state, make_tendency_fn,
)
from njw_tpu_torch.weather.convert import (  # noqa: E402
    grid_from_jax_fields, params_from_jax_fields, state_from_numpy,
    state_to_numpy,
)
from njw_tpu_torch.weather.integrators import make_stepper  # noqa: E402
from njw_tpu_torch.weather.oracle import SWEOracle  # noqa: E402
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _random_state(ny, nx, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
        "v": rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
        "h": (10.0 + rng.uniform(-amp, amp, (ny, nx))).astype(np.float32),
    }


def _both(d):
    """The same numpy state as a JAX and a torch WeatherState."""
    return (JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            state_from_numpy(d, CPU))


def _assert_states_close(t_state, j_state, rtol, atol):
    j = j_state.to_numpy()
    t = state_to_numpy(t_state)
    assert sorted(j) == sorted(t)
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=rtol, atol=atol,
                                   err_msg=name)


class TestInitialConditions:
    @pytest.mark.parametrize("name", [
        "uniform", "zonal_flow", "vortex", "jet_stream", "breaking_wave",
        "front", "mountain", "atmospheric_profile"])
    def test_deterministic_ic_matches_jax(self, name):
        jg = JGrid(nx=40, ny=48)
        ts = make_initial_state(name, grid_from_jax_fields(jg), device=CPU)
        # rtol: XLA's and torch's exp/sin/tanh may differ by an ulp, and
        # fields such as T ~ 300 need the relative term
        _assert_states_close(ts, j_ic(name, jg), rtol=1e-6, atol=1e-6)

    def test_ic_params_are_forwarded(self):
        jg = JGrid(nx=32, ny=32)
        ts = make_initial_state("vortex", grid_from_jax_fields(jg),
                                device=CPU, strength=2.0, radius=0.2)
        _assert_states_close(ts, j_ic("vortex", jg, strength=2.0, radius=0.2),
                             rtol=1e-6, atol=1e-6)

    def test_random_ic_shape_range_and_seed(self):
        grid = GridSpec(nx=24, ny=16)
        a = make_initial_state("random", grid, device=CPU, amplitude=0.5, seed=3)
        b = make_initial_state("random", grid, device=CPU, amplitude=0.5, seed=3)
        c = make_initial_state("random", grid, device=CPU, amplitude=0.5, seed=4)
        for name in ("u", "v", "h"):
            t = getattr(a, name)
            assert t.shape == (16, 24) and t.dtype == torch.float32
            assert torch.equal(t, getattr(b, name))
            assert not torch.equal(t, getattr(c, name))
        assert float(a.u.abs().max()) <= 0.5
        assert float((a.h - 10.0).abs().max()) <= 0.5

    def test_random_ic_uses_the_generator(self):
        grid = GridSpec(nx=8, ny=8)
        g1 = torch.Generator().manual_seed(7)
        g2 = torch.Generator().manual_seed(7)
        a = make_initial_state("random", grid, device=CPU, generator=g1)
        b = make_initial_state("random", grid, device=CPU, generator=g2)
        assert torch.equal(a.u, b.u)

    def test_unknown_ic_raises(self):
        with pytest.raises(ValueError, match="unknown initial condition"):
            make_initial_state("nope", GridSpec(nx=8, ny=8), device=CPU)


BCS = ["periodic", "clamped", "outflow", "reflective"]


class TestTendencies:
    @pytest.mark.parametrize("extra", [
        {}, {"beta": 0.05, "viscosity": 0.1}], ids=["f", "beta_visc"])
    @pytest.mark.parametrize("bc", BCS)
    def test_matches_jax(self, bc, extra):
        jg = JGrid(nx=24, ny=20, dx=1.5, dy=0.75, bc=bc)
        jp = JParams(coriolis_f=1e-2, **extra)
        js, ts = _both(_random_state(20, 24, seed=1))
        jt = j_tendency_fn("shallow_water", jg, jp)(js)
        tt = make_tendency_fn("shallow_water", grid_from_jax_fields(jg),
                              params_from_jax_fields(jp))(ts)
        _assert_states_close(tt, jt, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("bc", BCS)
    def test_matches_oracle(self, bc):
        grid = GridSpec(nx=24, ny=20, bc=bc)
        d = _random_state(20, 24, seed=2)
        t = make_tendency_fn("shallow_water", grid, PhysicsParams(
            coriolis_f=1e-4, viscosity=0.05))(state_from_numpy(d, CPU))
        ref = SWEOracle(bc=bc, coriolis_f=1e-4, viscosity=0.05).tendency(
            (d["u"], d["v"], d["h"]))
        for name, r in zip(("u", "v", "h"), ref):
            np.testing.assert_allclose(getattr(t, name).numpy(), r,
                                       rtol=1e-6, atol=1e-6)

    def test_diagnostics_match_jax(self):
        jg = JGrid(nx=24, ny=20, bc="clamped")
        js, ts = _both(_random_state(20, 24, seed=3))
        jd = j_diagnostics(js, jg)
        td = diagnostics(ts, grid_from_jax_fields(jg))
        for k in ("vorticity", "divergence"):
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("model,grid_type", [
        ("general", "staggered"), ("shallow_water", "staggered")])
    def test_unported_cores_raise(self, model, grid_type):
        """The C-grid core, once refused here, now comes from
        make_tendency_fn: it equals JAX's on the same state."""
        from njw_tpu.weather.staggered import swe_tendencies_cgrid

        jg = JGrid(nx=12, ny=8, grid_type=grid_type)
        js, ts = _both(_random_state(8, 12, seed=5))
        want = swe_tendencies_cgrid(js, jg, JParams(coriolis_f=0.3))
        got = make_tendency_fn(model, GridSpec(nx=12, ny=8,
                                               grid_type=grid_type),
                               PhysicsParams(coriolis_f=0.3))(ts)
        for name in ("u", "v", "h"):
            w = np.asarray(getattr(want, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                       rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


class TestIntegrators:
    @pytest.mark.parametrize("method",
                             ["euler", "rk2", "rk4", "adams_bashforth"])
    def test_two_steps_match_jax(self, method):
        jg = JGrid(nx=32, ny=24)
        jp = JParams(coriolis_f=1e-3, viscosity=0.01)
        js, ts = _both(_random_state(24, 32, seed=4, amp=0.3))
        dt = 0.01
        jst = j_make_stepper(method, j_tendency_fn("shallow_water", jg, jp))
        tst = make_stepper(method, make_tendency_fn(
            "shallow_water", grid_from_jax_fields(jg),
            params_from_jax_fields(jp)))
        jc, tc = jst.init(js), tst.init(ts)
        for _ in range(2):  # two steps: AB2's carry is exercised
            jc, js = jst.step(jc, js, jnp.float32(dt))
            tc, ts = tst.step(tc, ts, float(np.float32(dt)))
        _assert_states_close(ts, js, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("order", [1, 2])
    def test_semi_implicit_matches_jax(self, order):
        """make_stepper hands out the semi-implicit SWE stepper, as in the
        JAX package (tests/test_torch_weather_si.py holds it further)."""
        jg = JGrid(nx=32, ny=24)
        jp = JParams(coriolis_f=1e-3, viscosity=0.01)
        js, ts = _both(_random_state(24, 32, seed=6, amp=0.3))
        kw = dict(grid=grid_from_jax_fields(jg),
                  params=params_from_jax_fields(jp), order=order)
        tst = make_stepper("semi_implicit", make_tendency_fn(
            "shallow_water", kw["grid"], kw["params"]), **kw)
        jst = j_make_stepper("semi_implicit", j_tendency_fn(
            "shallow_water", jg, jp), grid=jg, params=jp, order=order)
        assert tst.name == jst.name == "semi_implicit"
        _, js = jst.step((), js, jnp.float32(0.2))
        _, ts = tst.step((), ts, float(np.float32(0.2)))
        _assert_states_close(ts, js, rtol=1e-5, atol=1e-6)


class TestSimulation:
    @pytest.mark.parametrize("backend,method", [
        ("kernel", "rk4"), ("plain", "rk4"), ("plain", "euler"),
        ("plain", "rk2"), ("plain", "adams_bashforth")])
    def test_matches_oracle_100_steps(self, backend, method):
        cfg = SimConfig(grid_width=64, grid_height=64, dt=0.01,
                        integration_method=method, backend=backend,
                        device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        expect = "rk4_kernel" if backend == "kernel" else {
            "adams_bashforth": "ab2"}.get(method, method)
        assert sim.stepper.name == expect
        s0 = j_ic("vortex", JGrid(nx=64, ny=64), strength=2.0)
        sim.step(100)
        u, v, h = JOracle().run(
            (np.asarray(s0.u), np.asarray(s0.v), np.asarray(s0.h)), 0.01,
            100, method)
        assert np.all(np.isfinite(sim.state.h.numpy()))
        np.testing.assert_allclose(sim.state.h.numpy(), h, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(sim.state.u.numpy(), u, rtol=2e-4, atol=2e-3)

    def test_rk4_oracle_1000_steps(self):
        """BASELINE correctness bar (tests/test_weather_swe.py:89): the
        kernel backend (its plain version on the CPU) allclose with the
        NumPy oracle after 1000 steps, rtol 1e-3 / atol 1e-3 on h."""
        cfg = SimConfig(grid_width=64, grid_height=64, dt=0.01,
                        backend="kernel", device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        assert sim.stepper.name == "rk4_kernel"
        s0 = j_ic("vortex", JGrid(nx=64, ny=64), strength=2.0)
        sim.step(1000)
        _, _, h = SWEOracle().run(
            (np.asarray(s0.u), np.asarray(s0.v), np.asarray(s0.h)), 0.01,
            1000)
        got = sim.state.h.numpy()
        assert np.all(np.isfinite(got)) and np.all(np.isfinite(h))
        np.testing.assert_allclose(got, h, rtol=1e-3, atol=1e-3)

    def test_port_oracle_equals_jax_oracle(self):
        d = _random_state(16, 20, seed=5, amp=0.2)
        s = (d["u"], d["v"], d["h"])
        kw = dict(bc="reflective", coriolis_f=1e-3, beta=0.01, viscosity=0.02)
        a = SWEOracle(**kw).run(s, 0.01, 3, "adams_bashforth")
        b = JOracle(**kw).run(s, 0.01, 3, "adams_bashforth")
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_auto_backend_on_cpu_uses_plain_integrators(self):
        cfg = SimConfig(grid_width=16, grid_height=16, device=CPU)
        assert Simulation.from_config(cfg, "vortex").stepper.name == "rk4"

    def test_run_snapshots_and_metrics(self):
        cfg = SimConfig(grid_width=16, grid_height=16, device=CPU,
                        backend="kernel")
        sim = Simulation.from_config(cfg, "vortex", strength=1.0)
        sim.run(6, output_interval=3)
        assert [s["step"] for s in sim.snapshots] == [3, 6]
        assert set(sim.snapshots[0]) >= {"u", "v", "h", "vorticity",
                                         "divergence", "time"}
        # the kernel stepper reuses two buffers: snapshots must be copies
        assert not np.array_equal(sim.snapshots[0]["h"], sim.snapshots[1]["h"])
        assert sim.metrics.num_steps == 6 and sim.metrics.grid_points == 256
        sim.run_until(0.1)
        assert sim.step_count == 10

    def test_default_config_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation.from_config(SimConfig())

    @pytest.mark.parametrize("cfg_kw,exc", [
        ({"backend": "xla"}, ValueError),
        ({"backend": "kernel", "boundary_condition": "clamped"}, ValueError),
        ({"backend": "kernel", "beta": 0.1}, ValueError),
        ({"integration_method": "semi_implicit",
          "boundary_condition": "clamped"}, NotImplementedError),
        ({"integration_method": "semi_implicit", "si_order": 3},
         ValueError),
    ])
    def test_bad_configs_raise(self, cfg_kw, exc):
        cfg = SimConfig(grid_width=16, grid_height=16, device=CPU, **cfg_kw)
        with pytest.raises(exc):
            Simulation.from_config(cfg, "vortex")


class TestConvert:
    def test_state_round_trip(self):
        js = j_ic("front", JGrid(nx=12, ny=10))
        ts = state_from_numpy(js.to_numpy(), CPU)
        assert ts.T is not None and ts.q is None
        for k, v in js.to_numpy().items():
            np.testing.assert_array_equal(state_to_numpy(ts)[k], v)

    def test_fields_are_read_by_name(self):
        jg = JGrid(nx=12, ny=10, dx=2.0, bc="outflow")
        assert grid_from_jax_fields(jg) == GridSpec(nx=12, ny=10, dx=2.0,
                                                    bc="outflow")
        p = params_from_jax_fields(SimpleNamespace(
            gravity=9.0, coriolis_f=jnp.float32(1e-4), beta=0.0))
        assert p == PhysicsParams(gravity=9.0, coriolis_f=float(
            np.float32(1e-4)), beta=0.0)

    def test_weather_state_zeros(self):
        s = WeatherState.zeros(GridSpec(nx=4, ny=3), CPU, full=True)
        j = JState.zeros(JGrid(nx=4, ny=3), full=True)
        _assert_states_close(s, j, rtol=0, atol=0)


class TestPlatform:
    def test_cpu_caps(self):
        caps = detect(CPU)
        assert caps.platform == "cpu" and not caps.is_cuda
        assert get_device_info(CPU)["platform"] == "cpu"

    @pytest.mark.parametrize("name,bw", [
        ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
        ("NVIDIA H100 NVL", 3900.0), ("NVIDIA H200", 4800.0),
        ("NVIDIA A100-SXM4-80GB", None)])
    def test_spec_table(self, name, bw):
        assert spec_for(name)[0] == bw

    def test_cuda_caps_refuse_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            detect("cuda")


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


class TestCLI:
    def test_json_run(self):
        rc, out = _cli(["--device", "cpu", "--width", "24", "--height", "16",
                        "--steps", "4", "--coriolis", "1e-4", "--json"])
        assert rc == 0
        m = json.loads(out.strip().splitlines()[-1])
        assert m["num_steps"] == 3 and m["grid_points_per_second"] > 0

    @pytest.mark.parametrize("backend", ["plain", "kernel"])
    def test_validate(self, backend):
        rc, out = _cli(["--device", "cpu", "--validate", "--width", "32",
                        "--steps", "20", "--backend", backend])
        line = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and line["allclose"] is True

    def test_output_npz(self, tmp_path):
        path = tmp_path / "out.npz"
        rc, _ = _cli(["--device", "cpu", "--width", "16", "--height", "16",
                      "--steps", "3", "--output", str(path)])
        assert rc == 0
        with np.load(path) as z:
            assert np.isfinite(z["final_h"]).all()
            assert "final_vorticity" in z

    @pytest.mark.parametrize("flags", [
        ["--model", "barotropic", "--grid-type", "spherical_harmonic",
         "--width", "64", "--height", "32", "--dt", "900"],
        ["--grid-type", "staggered"],
        ["--grid-type", "icosahedral", "--width", "8", "--height", "8",
         "--dt", "450"],
        ["--nest-patch", "4,12,4,12"], ["--output-format", "csv"]])
    def test_unported_flags_exit_2(self, flags, tmp_path):
        """Each flag the CLI once refused (exit 2) now runs on --device
        cpu."""
        rc, out = _cli(["--device", "cpu", "--width", "16", "--height",
                        "16", "--steps", "3", "--output-dir",
                        str(tmp_path), "--json", *flags])
        assert rc == 0
        assert json.loads(out.strip().splitlines()[-1])["num_steps"] == 2

    @pytest.mark.parametrize("flags", [
        ["--model", "primitive", "--levels", "3", "--dx", "1e5", "--dy",
         "1e5", "--dt", "300", "--coriolis", "1e-4"],
        ["--dt", "0.2", "--initial", "jet_stream"]],
        ids=["primitive", "shallow_water"])
    def test_semi_implicit_runs(self, flags):
        rc, out = _cli(["--device", "cpu", "--width", "24", "--height",
                        "16", "--steps", "4", "--method", "semi_implicit",
                        "--si-order", "2", "--json", *flags])
        assert rc == 0
        m = json.loads(out.strip().splitlines()[-1])
        assert m["num_steps"] == 3 and m["grid_points_per_second"] > 0

    def test_validate_refuses_semi_implicit(self):
        rc, out = _cli(["--device", "cpu", "--validate", "--width", "16",
                        "--steps", "2", "--method", "semi_implicit"])
        assert rc == 2
        assert "--validate does not support --method semi_implicit" in \
            json.loads(out.strip().splitlines()[-1])["error"]

    def test_default_device_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(["--width", "16", "--height", "16", "--steps", "2"])


def _imports(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "njw_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch.py"]
    assert len(files) > 10
    walked = {f.relative_to(REPO).parts[1] for f in files
              if f.parent.parent.name == "njw_tpu_torch"}
    assert {"nbody", "md", "signal", "weather", "medical",
            "geospatial", "geofinancial"} <= walked
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "njw_tpu")]
    assert bad == []
