"""The port's N-body package held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages
(``nbody.convert``); everything runs on the CPU. Tolerances: the direct
accelerations at rtol 1e-5 / atol 1e-6 of the largest (the JAX blocked
test's band, tests/test_nbody.py:48-52); the Gram form against JAX's
direct form, and at N = 600 against JAX's Gram form, at 2e-3 of the
largest (the JAX band of Gram against direct, :41-46: the cancellation
in |p_i|^2 + |p_j|^2 - 2 p_i.p_j amplifies the order of the sums);
energies at rtol 1e-5; each integrator over 20 steps and the simulations
end to end at 1e-5 of each field's largest value; the solar factory bit
for bit. The random and galaxy factories draw with torch (JAX's bits
cannot be matched): they are held by shape, range, seed and statistics. The JAX file's own tests run
again on the port, parametrised where they repeat.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.nbody as jn  # noqa: E402
from njw_tpu.nbody import __main__ as jcli  # noqa: E402

import njw_tpu_torch.nbody as tn  # noqa: E402
from njw_tpu_torch.nbody import __main__ as tcli  # noqa: E402
from njw_tpu_torch.nbody import convert  # noqa: E402

CPU = "cpu"
DIRECT_RTOL, DIRECT_ATOL = 1e-5, 1e-6   # of the largest |a|
GRAM_REL = 2e-3                         # tests/test_nbody.py:41-46
STATE_REL = 1e-5                        # 20 steps, normalised by field


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, seed, box=10.0):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.uniform(-box / 2, box / 2, (n, 3)).astype(np.float32),
                vel=(0.1 * rng.standard_normal((n, 3))).astype(np.float32),
                mass=rng.uniform(0.1, 1.0, n).astype(np.float32),
                G=1.0, softening=1e-6)


def _pair(n, seed, **kw):
    """The same system in both packages."""
    a = _arrays(n, seed, **kw)
    js = jn.NBodySystem(pos=jnp.asarray(a["pos"]), vel=jnp.asarray(a["vel"]),
                        mass=jnp.asarray(a["mass"]), G=a["G"],
                        softening=a["softening"])
    return js, convert.system_from(a, device=CPU)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-30))


def two_body(package):
    """Equal masses on a circular orbit about the centre of mass (the JAX
    test's fixture): v^2 = G m / (4 r) at separation 2 r."""
    v = np.sqrt(1.0 / 4.0)
    pos = np.asarray([[-1.0, 0, 0], [1.0, 0, 0]], np.float32)
    vel = np.asarray([[0, -v, 0], [0, v, 0]], np.float32)
    mass = np.ones(2, np.float32)
    if package == "jax":
        return jn.NBodySystem(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                              mass=jnp.asarray(mass), G=1.0, softening=1e-6)
    return convert.system_from(dict(pos=pos, vel=vel, mass=mass, G=1.0,
                                    softening=1e-6), device=CPU)


class TestForcesAgainstJax:
    @pytest.mark.parametrize("n,chunk", [(600, 1024), (2500, 1024),
                                         (600, 256)])
    def test_direct(self, n, chunk):
        js, ts = _pair(n, seed=n)
        want = np.asarray(jn.accelerations(js, chunk=chunk, method="direct"))
        got = tn.accelerations(ts, chunk=chunk, method="direct").numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=DIRECT_RTOL,
                                   atol=DIRECT_ATOL * scale)

    @pytest.mark.parametrize("n,chunk", [(600, 1024), (2500, 1024)])
    def test_gram(self, n, chunk):
        """Against JAX's direct form at its Gram band; at N = 600 against
        JAX's Gram form too. At N = 2500 (this seed) JAX's own Gram form
        misses its direct form by 9.2e-3 of the largest value, past its
        band, on a close pair's cancellation, while the port's keeps
        within 6e-4."""
        js, ts = _pair(n, seed=n + 1)
        direct = np.asarray(jn.accelerations(js, chunk=chunk,
                                             method="direct"))
        got = tn.accelerations(ts, chunk=chunk, method="mxu").numpy()
        atol = GRAM_REL * np.abs(direct).max()
        np.testing.assert_allclose(got, direct, atol=atol)
        if n <= 1024:
            np.testing.assert_allclose(
                got, np.asarray(jn.accelerations(js, method="mxu")),
                atol=atol)

    def test_auto_takes_the_gram_form_from_4096(self, monkeypatch):
        import njw_tpu_torch.nbody.forces as tf

        _, ts = _pair(64, seed=3)
        seen = []
        for name in ("_acc_rows_direct", "_acc_rows_mxu"):
            real = getattr(tf, name)
            monkeypatch.setattr(tf, name, lambda *a, _r=real, _n=name:
                                seen.append(_n) or _r(*a))
        tn.accelerations(ts)
        monkeypatch.setattr(tf, "_MXU_THRESHOLD", 64)
        tn.accelerations(ts)
        assert seen == ["_acc_rows_direct", "_acc_rows_mxu"]

    def test_potential_energy_and_diagnostics(self):
        js, ts = _pair(300, seed=4)
        want = jn.system_diagnostics(js)
        got = tn.system_diagnostics(ts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(tn.potential_energy(ts)),
                                   float(jn.potential_energy(js)), rtol=1e-5)

    def test_unknown_method_raises(self):
        _, ts = _pair(8, seed=5)
        with pytest.raises(ValueError, match="unknown force method"):
            tn.accelerations(ts, method="tree")
        with pytest.raises(ValueError, match="requires pm_box"):
            tn.accelerations(ts, method="pm")


class TestIntegratorsAgainstJax:
    @pytest.mark.parametrize("method", ["euler", "leapfrog", "verlet",
                                        "rk4"])
    def test_twenty_steps(self, method):
        js, ts = _pair(128, seed=6)
        jsim = jn.NBodySimulation(js, integrator=method, dt=0.001)
        tsim = tn.NBodySimulation(ts, integrator=method, dt=0.001)
        jsim.step(20)
        tsim.step(20)
        assert _rel(tsim.system.pos, jsim.system.pos) < STATE_REL
        assert _rel(tsim.system.vel, jsim.system.vel) < STATE_REL

    def test_unknown_integrator_raises(self):
        _, ts = _pair(8, seed=7)
        with pytest.raises(ValueError, match="unknown integrator"):
            tn.NBodySimulation(ts, integrator="rk9")


class TestSimulationAgainstJax:
    def test_run_by_duration(self):
        js, ts = _pair(64, seed=8)
        jsim = jn.NBodySimulation(js, dt=0.01)
        tsim = tn.NBodySimulation(ts, dt=0.01)
        jsim.run(0.2)
        tsim.run(0.2)
        assert tsim.step_count == jsim.step_count == 20
        assert tsim.time == pytest.approx(jsim.time)
        assert _rel(tsim.system.pos, jsim.system.pos) < STATE_REL
        jd, td = jsim.diagnostics(), tsim.diagnostics()
        assert td["total_energy"] == pytest.approx(jd["total_energy"],
                                                   rel=1e-5)

    def test_run_by_callback(self):
        js, ts = _pair(64, seed=9)
        seen = {"jax": [], "torch": []}
        jn.NBodySimulation(js, dt=0.01).run(
            n_steps=30, callback_interval=7,
            callback=lambda s: seen["jax"].append(
                (s.step_count, np.asarray(s.system.pos).copy())))
        tn.NBodySimulation(ts, dt=0.01).run(
            n_steps=30, callback_interval=7,
            callback=lambda s: seen["torch"].append(
                (s.step_count, s.system.pos.numpy().copy())))
        assert [c for c, _ in seen["torch"]] == [c for c, _ in seen["jax"]] \
            == [7, 14, 21, 28, 30]
        for (_, a), (_, b) in zip(seen["torch"], seen["jax"]):
            assert _rel(a, b) < STATE_REL

    @pytest.mark.parametrize("saver", ["jax", "torch"])
    def test_save_load_across_packages(self, tmp_path, saver):
        js, ts = _pair(32, seed=10)
        jsim = jn.NBodySimulation(js, integrator="verlet", dt=0.02)
        tsim = tn.NBodySimulation(ts, integrator="verlet", dt=0.02)
        jsim.step(10)
        tsim.step(10)
        src = jsim if saver == "jax" else tsim
        path = src.save_state(str(tmp_path / "state"))
        assert path.endswith(".npz")
        if saver == "jax":
            loaded = tn.NBodySimulation.load_state(path, device=CPU)
            pos = loaded.system.pos.numpy()
        else:
            loaded = jn.NBodySimulation.load_state(path)
            pos = np.asarray(loaded.system.pos)
        assert loaded.step_count == 10 and loaded.integrator_name == "verlet"
        assert loaded.time == pytest.approx(src.time)
        assert loaded.dt == pytest.approx(0.02)
        np.testing.assert_array_equal(
            pos, np.asarray(src.system.pos) if saver == "jax"
            else src.system.pos.numpy())
        loaded.step(5)      # a restored simulation continues

    def test_visualization_and_metrics(self):
        _, ts = _pair(64, seed=11)
        sim = tn.NBodySimulation(ts, dt=0.01)
        sim.step(10)
        m = sim.performance_metrics()
        assert m["num_steps"] == 10 and m["interactions_per_second"] > 0
        assert m["ms_per_step"] > 0
        v = sim.visualization_data()
        assert set(v) == {"positions", "velocities", "masses", "time"}
        assert v["positions"].shape == (64, 3)


class TestFactories:
    def test_solar_system_bit_equal(self):
        for kw in ({}, {"scale_factor": 2.5, "seed": 3}):
            want = jn.create_solar_system(**kw)
            got = tn.create_solar_system(device=CPU, **kw)
            for f in ("pos", "vel", "mass"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)))
            assert got.G == pytest.approx(float(want.G))
            assert got.softening == float(want.softening)

    def test_random_system_shape_range_seed_statistics(self):
        a = tn.create_random_system(4000, box_size=6.0, min_mass=0.2,
                                    max_mass=0.7, velocity_scale=0.3,
                                    seed=5, device=CPU)
        b = tn.create_random_system(4000, box_size=6.0, min_mass=0.2,
                                    max_mass=0.7, velocity_scale=0.3,
                                    seed=5, device=CPU)
        c = tn.create_random_system(4000, box_size=6.0, seed=6, device=CPU)
        assert a.pos.shape == (4000, 3) and a.mass.shape == (4000,)
        assert a.pos.dtype == a.vel.dtype == a.mass.dtype == torch.float32
        assert torch.equal(a.pos, b.pos) and torch.equal(a.mass, b.mass)
        assert not torch.equal(a.pos, c.pos)
        assert float(a.pos.abs().max()) <= 3.0
        assert 0.2 <= float(a.mass.min()) and float(a.mass.max()) <= 0.7
        # uniform on [-3, 3): mean 0, variance 3; normal(0, 0.3)
        assert abs(float(a.pos.mean())) < 0.1
        assert float(a.pos.var()) == pytest.approx(3.0, rel=0.05)
        assert float(a.vel.std()) == pytest.approx(0.3, rel=0.05)
        assert float(a.mass.mean()) == pytest.approx(0.45, rel=0.02)
        # the JAX factory: the same shapes and ranges
        j = jn.create_random_system(4000, box_size=6.0, min_mass=0.2,
                                    max_mass=0.7, velocity_scale=0.3, seed=5)
        assert tuple(j.pos.shape) == tuple(a.pos.shape)
        assert float(jnp.abs(j.pos).max()) <= 3.0

    def test_galaxy_model_shape_range_statistics(self):
        s = tn.create_galaxy_model(3000, seed=3, device=CPU)
        j = jn.create_galaxy_model(3000, seed=3)
        assert s.n == 3000 and s.softening == 0.05
        assert float(s.mass[0]) == 1000.0 and float(s.mass[1:].max()) == 1.0
        assert torch.equal(s.pos[0], torch.zeros(3))
        r = torch.linalg.norm(s.pos[1:, :2], dim=1)
        assert float(r.max()) <= 10.0 + 1e-5
        assert float(r.min()) >= 10.0 * math.sqrt(0.05) - 1e-5
        assert float(s.pos[1:, 2].abs().max()) <= 0.5
        # near-circular: |v| within a few 5% sigmas of sqrt(G M / r)
        speed = torch.linalg.norm(s.vel[1:], dim=1)
        ratio = speed / torch.sqrt(1000.0 / r)
        assert float(ratio.mean()) == pytest.approx(1.0, abs=0.01)
        assert float(ratio.std()) == pytest.approx(0.05, rel=0.15)
        # tangential: v . r = 0 in the plane
        radial = (s.vel[1:, :2] * s.pos[1:, :2]).sum(1) / r
        assert float(radial.abs().max()) < 1e-3 * float(speed.max())
        jr = np.linalg.norm(np.asarray(j.pos[1:, :2]), axis=1)
        assert float(r.mean()) == pytest.approx(float(jr.mean()), rel=0.05)


class TestJaxInvariantsOnThePort:
    """tests/test_nbody.py's tests, run on the port."""

    def test_two_body_analytic(self):
        a = tn.accelerations(two_body("torch")).numpy()
        np.testing.assert_allclose(a[0], [0.25, 0, 0], atol=1e-5)
        np.testing.assert_allclose(a[1], [-0.25, 0, 0], atol=1e-5)

    def test_gram_matches_direct(self):
        s = tn.create_random_system(512, seed=1, device=CPU)
        a_d = tn.accelerations(s, method="direct").numpy()
        a_g = tn.accelerations(s, method="mxu").numpy()
        np.testing.assert_allclose(a_g, a_d, atol=GRAM_REL * np.abs(a_d).max())

    def test_blocked_matches_unblocked(self):
        s = tn.create_random_system(600, seed=2, device=CPU)
        a1 = tn.accelerations(s, chunk=4096).numpy()
        a2 = tn.accelerations(s, chunk=256).numpy()
        np.testing.assert_allclose(a2, a1, rtol=1e-5, atol=1e-6)

    def test_potential_energy_two_body(self):
        assert float(tn.potential_energy(two_body("torch"))) == \
            pytest.approx(-0.5, rel=1e-4)

    @pytest.mark.parametrize("method,tol", [
        ("euler", 5e-2), ("leapfrog", 1e-4), ("verlet", 1e-4), ("rk4", 1e-5),
    ])
    def test_energy_conservation_two_body(self, method, tol):
        sim = tn.NBodySimulation(two_body("torch"), integrator=method,
                                 dt=0.01)
        e0 = float(tn.system_diagnostics(sim.system)["total_energy"])
        sim.step(500)
        e1 = float(tn.system_diagnostics(sim.system)["total_energy"])
        assert abs(e1 - e0) / abs(e0) < tol

    def test_momentum_conserved(self):
        sim = tn.NBodySimulation(tn.create_random_system(128, seed=7,
                                                         device=CPU),
                                 integrator="leapfrog", dt=0.005)
        p0 = tn.system_diagnostics(sim.system)["momentum"].numpy()
        sim.step(100)
        p1 = tn.system_diagnostics(sim.system)["momentum"].numpy()
        assert np.abs(p1 - p0).max() < 1e-3

    def test_circular_orbit_radius_preserved(self):
        sim = tn.NBodySimulation(two_body("torch"), integrator="leapfrog",
                                 dt=0.01)
        sim.step(1000)
        assert float(torch.linalg.norm(sim.system.pos[0])) == \
            pytest.approx(1.0, abs=0.02)

    def test_solar_system_has_nine_bodies(self):
        s = tn.create_solar_system(device=CPU)
        assert s.n == 9 and float(s.mass[0]) == 1.0
        r = torch.linalg.norm(s.pos, dim=1).numpy()
        assert np.any(np.abs(r - 1.0) < 1e-3)

    def test_diagnostics_keys(self):
        d = tn.system_diagnostics(tn.create_random_system(64, device=CPU))
        assert set(d) >= {"total_mass", "center_of_mass", "momentum",
                          "angular_momentum", "kinetic_energy",
                          "potential_energy", "total_energy"}


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestCLI:
    def test_matches_the_jax_cli(self, tmp_path, capsys):
        argv = ["--system-type", "solar", "--duration", "0.1", "--dt",
                "0.001"]
        rc_j, want = _cli(jcli.main, argv, capsys)
        rc_t, got = _cli(tcli.main, argv + ["--device", "cpu",
                                            "--output-dir", str(tmp_path),
                                            "--save-visualization"], capsys)
        assert rc_j == rc_t == 0
        assert set(got) == set(want)
        assert got["particles"] == want["particles"] == 9
        assert got["steps"] == want["steps"] == 100
        assert got["energy_final"] == pytest.approx(want["energy_final"],
                                                    rel=1e-5)
        assert (tmp_path / "final_state.npz").exists()
        assert (tmp_path / "visualization.npz").exists()

    def test_file_input_round_trip(self, tmp_path, capsys):
        rc, _ = _cli(tcli.main, ["--num-particles", "32", "--duration",
                                 "0.05", "--device", "cpu", "--output-dir",
                                 str(tmp_path)], capsys)
        assert rc == 0
        rc, out = _cli(tcli.main, ["--system-type", "file", "--input-file",
                                   str(tmp_path / "final_state.npz"),
                                   "--duration", "0.05", "--device", "cpu"],
                       capsys)
        assert rc == 0 and out["particles"] == 32 and out["steps"] == 10
        assert tcli.main(["--system-type", "file", "--device", "cpu"]) == 2

    def test_default_device_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--num-particles", "8", "--duration", "0.01"])


def test_exports_every_name_of_the_jax_package():
    import njw_tpu.md as jmd
    import njw_tpu_torch.md as tmd

    for jpkg, tpkg in ((jn, tn), (jmd, tmd)):
        want = {k for k in vars(jpkg) if not k.startswith("_")
                and not isinstance(getattr(jpkg, k), type(jpkg))}
        missing = sorted(k for k in want if not hasattr(tpkg, k))
        assert missing == [], (tpkg.__name__, missing)
        assert set(tpkg.__all__) >= want


def test_gram_band_at_the_suite_configuration():
    """nbody_suite_4096's system (create_random_system(4096, seed=0), as
    NumPy arrays in both packages): the JAX package's Gram form misses
    its direct form by more than its own 2e-3 band (a reference fault,
    ROADMAP.md section 3: cancellation on the closest pairs), and the
    port's Gram form is no further from a float64 direct sum than 1.5x
    the JAX Gram form's distance, the direct form within 1e-5 of it."""
    ts = tn.create_random_system(4096, seed=0, device=CPU)
    a = convert.system_arrays(ts)
    js = jn.NBodySystem(pos=jnp.asarray(a["pos"]), vel=jnp.asarray(a["vel"]),
                        mass=jnp.asarray(a["mass"]), G=1.0, softening=1e-6)
    p, m = a["pos"].astype(np.float64), a["mass"].astype(np.float64)
    exact = np.concatenate([
        ((m[None, :] * ((d * d).sum(-1) + 1e-12) ** -1.5)[..., None]
         * d).sum(1)
        for d in (p[None, :, :] - p[r:r + 512, None, :]
                  for r in range(0, 4096, 512))])
    scale = np.abs(exact).max()
    jax_gram = np.abs(np.asarray(jn.accelerations(js, method="mxu"))
                      - exact).max() / scale
    port_gram = np.abs(tn.accelerations(ts, method="mxu").numpy()
                       - exact).max() / scale
    port_direct = np.abs(tn.accelerations(ts, method="direct").numpy()
                         - exact).max() / scale
    assert jax_gram > GRAM_REL, jax_gram
    assert port_gram <= 1.5 * jax_gram, (port_gram, jax_gram)
    assert port_direct <= DIRECT_RTOL, port_direct   # float32 rounding
