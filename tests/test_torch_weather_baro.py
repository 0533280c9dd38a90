"""The PyTorch port's barotropic vorticity core held against the JAX package.

Inputs are made with numpy from a fixed seed and carried to both packages
(``njw_tpu_torch.weather.convert``); everything runs on the CPU, where the
port's stage wrapper runs the kernel's plain version and the JAX stage
kernel runs in Pallas interpret mode. The tolerances are the JAX package's
own tests' (tests/test_weather_barotropic.py).
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops import spectral as j_spectral  # noqa: E402
from njw_tpu.ops.baro_stencil import (  # noqa: E402
    baro_stage_pallas, make_baro_pallas_rk4_stepper,
)
from njw_tpu.weather import (  # noqa: E402
    GridSpec as JGrid, PhysicsParams as JParams, SimConfig as JSimConfig,
    Simulation as JSimulation,
)
from njw_tpu.weather import barotropic as jb  # noqa: E402
from njw_tpu.weather import oracle as j_oracle  # noqa: E402

from njw_tpu_torch.ops import spectral  # noqa: E402
from njw_tpu_torch.ops.baro_stencil import (  # noqa: E402
    baro_kernel_supported, baro_stage, baro_stage_cuda, baro_stage_plain,
    make_baro_kernel_rk4_stepper,
)
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, make_tendency_fn,
)
from njw_tpu_torch.weather import barotropic as tb  # noqa: E402
from njw_tpu_torch.weather import oracle as t_oracle  # noqa: E402
from njw_tpu_torch.weather.convert import (  # noqa: E402
    baro_state_from_numpy, baro_state_to_numpy, grid_from_jax_fields,
    params_from_jax_fields, tensor_from_numpy,
)
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed, shape=(64, 64)):
    """A zero-mean standard-normal float32 field (the JAX tests' input)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape).astype(np.float32)
    return f - f.mean()


def _t(a):
    return tensor_from_numpy(a, CPU)


def _close(t, j, rtol, atol, name=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=name)


class TestSpectral:
    @pytest.mark.parametrize("kind", ["spectral", "central", "laplacian5"])
    def test_wavenumbers_match_jax(self, kind):
        for n, d in ((64, 1.0), (48, 0.7)):
            _close(spectral.fd_wavenumbers(n, d, kind, device=CPU),
                   j_spectral.fd_wavenumbers(n, d, kind), 1e-6, 1e-6, kind)

    def test_wavenumbers_default_to_cuda(self):
        """The default device is the card: without one it raises, and
        does not fall back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spectral.fd_wavenumbers(64, 1.0)

    def test_poisson_single_mode_matches_jax(self):
        n = 64
        x = np.arange(n) * (2 * np.pi / n)
        f = np.broadcast_to(np.sin(x)[None, :], (n, n)).astype(np.float32)
        got = spectral.poisson_solve(_t(f), 1.0, 1.0, kind="laplacian5")
        want = j_spectral.poisson_solve(jnp.asarray(f), 1.0, 1.0,
                                        kind="laplacian5")
        _close(got, want, 1e-4, 1e-4)
        # and the exact answer: psi = -f / k_eff^2
        k_eff2 = 2.0 * (1.0 - np.cos(2 * np.pi / n))
        _close(got, -f / k_eff2, 1e-4, 1e-4)

    # ('central' is singular at the Nyquist mode, in both packages)
    @pytest.mark.parametrize("kind,dy", [("laplacian5", 1.3),
                                         ("laplacian5", 1.0),
                                         ("spectral", 1.3)])
    def test_poisson_random_field_matches_jax(self, kind, dy):
        f = _field(0, (48, 64))
        got = spectral.poisson_solve(_t(f), 1.0, dy, kind=kind)
        want = j_spectral.poisson_solve(jnp.asarray(f), 1.0, dy, kind=kind)
        _close(got, want, 1e-4, 1e-4)
        assert abs(float(got.double().mean())) < 1e-6  # zero-mean gauge

    def test_helmholtz_matches_jax(self):
        f = _field(1, (32, 40))
        got = spectral.helmholtz_solve(_t(f), 1.0, 1.0, alpha=-0.3, beta=2.0)
        want = j_spectral.helmholtz_solve(jnp.asarray(f), 1.0, 1.0,
                                          alpha=-0.3, beta=2.0)
        _close(got, want, 1e-4, 1e-5)


class TestCore:
    def test_arakawa_jacobian_matches_jax(self):
        p, z = _field(1), _field(2)
        _close(tb.arakawa_jacobian(_t(p), _t(z), 1.0, 1.0),
               jb.arakawa_jacobian(jnp.asarray(p), jnp.asarray(z), 1.0, 1.0),
               1e-4, 1e-5)

    def test_arakawa_antisymmetry_and_zero_mean(self):
        p, z = _t(_field(3)), _t(_field(4))
        j_pz = tb.arakawa_jacobian(p, z, 1.0, 1.0)
        torch.testing.assert_close(j_pz, -tb.arakawa_jacobian(z, p, 1.0, 1.0),
                                   rtol=1e-4, atol=1e-5)
        assert abs(float(j_pz.double().sum())) < 1e-3

    @pytest.mark.parametrize("beta,nu", [(0.0, 0.0), (1e-2, 0.0),
                                         (1e-3, 1e-3)])
    def test_tendencies_match_jax(self, beta, nu):
        jg = JGrid(nx=64, ny=48, dx=1.0, dy=1.5)
        jp = JParams(beta=beta, viscosity=nu)
        z = _field(5, (48, 64))
        got = tb.barotropic_tendencies(
            baro_state_from_numpy({"zeta": z}, CPU), grid_from_jax_fields(jg),
            params_from_jax_fields(jp))
        want = jb.barotropic_tendencies(jb.BarotropicState(
            zeta=jnp.asarray(z)), jg, jp)
        _close(got.zeta, want.zeta, 1e-4, 1e-5)

    def test_invert_and_velocities_match_jax(self):
        jg = JGrid(nx=64, ny=64)
        z = _field(6)
        psi_t = tb.invert_vorticity(_t(z), grid_from_jax_fields(jg))
        psi_j = jb.invert_vorticity(jnp.asarray(z), jg)
        _close(psi_t, psi_j, 1e-4, 1e-4)
        for a, b in zip(tb.velocities(psi_t, grid_from_jax_fields(jg)),
                        jb.velocities(psi_j, jg)):
            _close(a, b, 1e-4, 1e-4)

    def test_make_tendency_fn_serves_the_core(self):
        grid, params = GridSpec(nx=24, ny=16), PhysicsParams(beta=1e-2)
        s = baro_state_from_numpy({"zeta": _field(16, (16, 24))}, CPU)
        got = make_tendency_fn("barotropic", grid, params)(s)
        assert torch.equal(got.zeta,
                           tb.barotropic_tendencies(s, grid, params).zeta)

    def test_non_periodic_raises(self):
        s = baro_state_from_numpy({"zeta": _field(7, (8, 8))}, CPU)
        with pytest.raises(NotImplementedError, match="periodic"):
            tb.barotropic_tendencies(s, GridSpec(nx=8, ny=8, bc="clamped"),
                                     PhysicsParams())


class TestStage:
    """The K3 stage's plain version against the JAX stage kernel."""

    @pytest.mark.parametrize("beta,nu", [(0.3, 0.02), (0.0, 0.0)])
    def test_plain_matches_pallas_interpret(self, beta, nu):
        jg = JGrid(nx=128, ny=32, dx=1.0, dy=1.0)
        z, base = _field(3, (32, 128)), _field(4, (32, 128))
        psi = np.asarray(jb.invert_vorticity(jnp.asarray(z), jg))
        want = baro_stage_pallas(jnp.asarray(psi), jnp.asarray(z),
                                 jnp.asarray(base), grid=jg, c_dt=0.7,
                                 beta=beta, nu=nu, by=8, interpret=True)
        got = baro_stage_plain(_t(psi), _t(z), _t(base),
                               grid=grid_from_jax_fields(jg), c_dt=0.7,
                               beta=beta, nu=nu)
        _close(got, want, 1e-5, 1e-5)

    def test_wrapper_runs_plain_on_cpu_and_counts_no_launch(self):
        grid = GridSpec(nx=20, ny=12, dy=0.5)
        z, base = _t(_field(8, (12, 20))), _t(_field(9, (12, 20)))
        psi = tb.invert_vorticity(z, grid)
        before = baro_stage_cuda.launches
        out = torch.empty_like(z)
        got = baro_stage(psi, z, base, grid=grid, c_dt=0.3, beta=0.1, nu=0.01,
                         out=out)
        assert got is out and baro_stage_cuda.launches == before
        ref = base + 0.3 * tb.barotropic_tendencies(
            tb.BarotropicState(zeta=z), grid,
            PhysicsParams(beta=0.1, viscosity=0.01)).zeta
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        grid = GridSpec(nx=8, ny=8)
        z = _t(_field(10, (8, 8)))
        with pytest.raises(ValueError, match="CUDA tensors only"):
            baro_stage_cuda(z, z, z, grid=grid, c_dt=0.1)

    @pytest.mark.parametrize("bad,match", [
        ("dtype", "float32"), ("shape", "shape"), ("alias", "alias")])
    def test_bad_inputs_raise(self, bad, match):
        grid = GridSpec(nx=8, ny=8)
        z = _t(_field(11, (8, 8)))
        psi, base, out = z.clone(), z.clone(), None
        if bad == "dtype":
            psi = psi.double()
        elif bad == "shape":
            base = _t(_field(11, (8, 9)))
        else:
            out = psi
        with pytest.raises((TypeError, ValueError), match=match):
            baro_stage(psi, z, base, grid=grid, c_dt=0.1, out=out)

    def test_supported_predicate(self):
        p = PhysicsParams(beta=1e-3, viscosity=1e-4)
        assert baro_kernel_supported(GridSpec(nx=200, ny=50), p)
        assert not baro_kernel_supported(GridSpec(nx=64, ny=64,
                                                  bc="clamped"), p)
        assert not baro_kernel_supported(GridSpec(nx=64, ny=64), PhysicsParams(
            beta=torch.ones(1)))


class TestStepper:
    def test_one_step_matches_pallas_stepper(self):
        jg = JGrid(nx=128, ny=32, dx=1.0, dy=1.0)
        jp = JParams(beta=0.1)
        z = _field(5, (32, 128)) * np.float32(0.1)
        _, want = make_baro_pallas_rk4_stepper(jg, jp, dt=0.05,
                                               interpret=True).step(
            (), jb.BarotropicState(zeta=jnp.asarray(z)), None)
        st = make_baro_kernel_rk4_stepper(grid_from_jax_fields(jg),
                                          params_from_jax_fields(jp), 0.05)
        assert st.name == "baro_rk4_kernel"
        _, got = st.step(st.init(None), baro_state_from_numpy(
            {"zeta": z}, CPU), None)
        _close(got.zeta, want.zeta, 1e-5, 1e-5)


class TestSimulation:
    def test_initial_zeta_matches_jax(self):
        kw = dict(model="barotropic", grid_width=64, grid_height=48, dx=1.0,
                  dy=1.0, dt=0.05)
        jsim = JSimulation.from_config(JSimConfig(backend="xla", **kw),
                                       "vortex", strength=3.0)
        tsim = Simulation.from_config(SimConfig(device=CPU, **kw), "vortex",
                                      strength=3.0)
        _close(tsim.state.zeta, jsim.state.zeta, 1e-6, 1e-6)
        assert tsim.metrics.grid_points == 64 * 48

    @pytest.mark.parametrize("backend", ["kernel", "plain"])
    def test_matches_port_oracle_200_steps(self, backend):
        cfg = SimConfig(model="barotropic", grid_width=64, grid_height=64,
                        dx=1.0, dy=1.0, dt=0.05, beta=1e-3, viscosity=1e-3,
                        backend=backend, device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        assert sim.stepper.name == {"kernel": "baro_rk4_kernel",
                                    "plain": "rk4"}[backend]
        z0 = sim.state.zeta.numpy().copy()
        sim.step(200)
        ref = t_oracle.BarotropicOracle(dx=1.0, dy=1.0, beta=1e-3,
                                        viscosity=1e-3).run(z0, 0.05, 200)
        got = sim.state.zeta.numpy()
        assert np.isfinite(got).all()
        # normalised 5e-3: the JAX oracle test's policy (complex128 numpy
        # FFT against the model's complex64)
        scale = np.abs(ref).max() + 1e-30
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                                   atol=5e-3)

    def test_rk4_oracle_1000_steps(self):
        """BASELINE bar for the barotropic core
        (tests/test_weather_barotropic.py:128): the kernel backend (K3's
        plain version on the CPU) against the NumPy oracle after 1000
        steps, normalised 5e-3 (the oracle's complex128 FFT against the
        model's complex64)."""
        cfg = SimConfig(model="barotropic", grid_width=64, grid_height=64,
                        dx=1.0, dy=1.0, dt=0.05, beta=1e-3, viscosity=1e-3,
                        backend="kernel", device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        assert sim.stepper.name == "baro_rk4_kernel"
        z0 = sim.state.zeta.numpy().copy()
        sim.step(1000)
        ref = t_oracle.BarotropicOracle(dx=1.0, dy=1.0, beta=1e-3,
                                        viscosity=1e-3).run(z0, 0.05, 1000)
        got = sim.state.zeta.numpy()
        assert np.isfinite(got).all()
        scale = np.abs(ref).max() + 1e-30
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0,
                                   atol=5e-3)

    def test_auto_on_cpu_uses_plain_integrators(self):
        cfg = SimConfig(model="barotropic", grid_width=16, grid_height=16,
                        device=CPU)
        assert Simulation.from_config(cfg, "vortex").stepper.name == "rk4"

    def test_snapshots_hold_zeta_psi_u_v(self):
        cfg = SimConfig(model="barotropic", grid_width=16, grid_height=16,
                        dt=0.05, backend="kernel", device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=1.0)
        sim.run(4, output_interval=2)
        assert [s["step"] for s in sim.snapshots] == [2, 4]
        assert set(sim.snapshots[0]) >= {"zeta", "psi", "u", "v"}
        assert sim.state.device == torch.device(CPU)

    @pytest.mark.parametrize("cfg_kw,exc,match", [
        ({"integration_method": "semi_implicit"}, ValueError, "semi_implicit"),
        ({"backend": "kernel", "boundary_condition": "clamped"}, ValueError,
         "backend='kernel' requires"),
        ({"backend": "kernel", "integration_method": "euler"}, ValueError,
         "backend='kernel' requires"),
    ])
    def test_bad_configs_raise(self, cfg_kw, exc, match):
        cfg = SimConfig(model="barotropic", grid_width=16, grid_height=16,
                        device=CPU, **cfg_kw)
        with pytest.raises(exc, match=match):
            Simulation.from_config(cfg, "vortex")

    def test_default_device_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation.from_config(SimConfig(model="barotropic"), "vortex")


class TestOracleCopy:
    """The port's NumPy oracles are copies of the JAX package's."""

    def test_functions_equal_jax_oracle(self):
        z, p = _field(12, (32, 40)), _field(13, (32, 40))
        for name, args, kw in [
            ("invert_vorticity_np", (z, 1.0, 1.3), {}),
            ("arakawa_jacobian_np", (p, z, 1.0, 1.3), {}),
            ("barotropic_tendency_np", (z,),
             dict(dx=1.0, dy=1.3, beta=1e-3, viscosity=1e-3)),
        ]:
            np.testing.assert_allclose(
                getattr(t_oracle, name)(*args, **kw),
                getattr(j_oracle, name)(*args, **kw), rtol=1e-12, atol=0,
                err_msg=name)
        np.testing.assert_allclose(t_oracle._lap5_k2_np(40, 0.7),
                                   j_oracle._lap5_k2_np(40, 0.7), rtol=1e-12)

    def test_oracle_run_equals_jax_oracle(self):
        z = _field(14, (24, 32)) * np.float32(0.5)
        kw = dict(dx=1.0, dy=1.0, beta=1e-2, viscosity=1e-3)
        np.testing.assert_allclose(
            t_oracle.BarotropicOracle(**kw).run(z, 0.05, 3),
            j_oracle.BarotropicOracle(**kw).run(z, 0.05, 3), rtol=1e-12,
            atol=0)


class TestConvert:
    def test_state_round_trip_from_jax_object(self):
        z = _field(15, (8, 12))
        js = jb.BarotropicState(zeta=jnp.asarray(z))
        ts = baro_state_from_numpy(js, CPU)
        np.testing.assert_array_equal(baro_state_to_numpy(ts)["zeta"], z)
        assert ts.zeta.dtype == torch.float32 and ts.zeta.is_contiguous()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


class TestCLI:
    @pytest.mark.parametrize("backend", ["plain", "kernel"])
    def test_json_run(self, backend):
        rc, out = _cli(["--device", "cpu", "--model", "barotropic", "--width",
                        "24", "--height", "16", "--steps", "4", "--backend",
                        backend, "--json"])
        assert rc == 0
        m = json.loads(out.strip().splitlines()[-1])
        assert m["num_steps"] == 3 and m["grid_points_per_second"] > 0

    def test_output_npz(self, tmp_path):
        path = tmp_path / "baro.npz"
        rc, _ = _cli(["--device", "cpu", "--model", "barotropic", "--width",
                      "16", "--height", "16", "--steps", "3", "--output",
                      str(path)])
        assert rc == 0
        with np.load(path) as z:
            assert {"final_zeta", "final_psi", "final_u", "final_v"} <= set(z)
            assert np.isfinite(z["final_zeta"]).all()

    def test_mountain_requires_primitive(self, capsys):
        assert cli_main(["--device", "cpu", "--model", "barotropic",
                         "--mountain-height", "100"]) == 2
        assert "requires --model primitive" in capsys.readouterr().err
