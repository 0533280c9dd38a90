"""The port's MD package held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages
(``md.convert``); everything runs on the CPU. Tolerances: energies at
rtol 1e-5; autograd forces against ``jax.grad`` forces at 1e-5 of the
largest; ``MDSimulation`` over 20 steps, for each integrator with no
thermostat, Berendsen and Nose-Hoover, at 1e-4 of each field's largest
value (float32 rounding grown over the steps); the lattice, the water
geometry and topology and the PDB reader bit for bit. The Maxwell
velocities and Andersen's collisions draw with torch (JAX's bits cannot
be matched): they are held by their statistics. The JAX file's own
tests (tests/test_md.py) run again on the port, parametrised where they
repeat.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import njw_tpu.md as jm  # noqa: E402
from njw_tpu.md import __main__ as jcli  # noqa: E402
from njw_tpu.md import forces as jforces  # noqa: E402

import njw_tpu_torch.md as tm  # noqa: E402
from njw_tpu_torch.md import __main__ as tcli  # noqa: E402
from njw_tpu_torch.md import convert  # noqa: E402
from njw_tpu_torch.md import forces as tforces  # noqa: E402

CPU = "cpu"
ENERGY_RTOL = 1e-5
FORCE_REL = 1e-5
DYNAMICS_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-30))


def _to_port(state, topo, lj):
    return (convert.state_from(state, device=CPU),
            convert.topology_from(topo, device=CPU),
            convert.lj_from(lj, device=CPU))


def _jitter(state, scale, seed):
    """The JAX state with its positions moved by seeded normal noise."""
    noise = np.random.default_rng(seed).normal(
        scale=scale, size=state.pos.shape).astype(np.float32)
    return state.replace(pos=state.pos + jnp.asarray(noise))


def lj_system():
    st, topo, lj = jm.create_lj_fluid(216, density=0.5, seed=1)
    return _jitter(st, 0.1, 2), topo, lj


def water_system():
    st, topo, lj = jm.create_water_box(27, seed=4)
    return _jitter(st, 0.02, 5), topo, lj


def chain_system():
    """An 8-atom charged chain with bonds, angles and dihedrals."""
    rng = np.random.default_rng(9)
    n = 8
    pos = (np.cumsum(rng.normal(0.0, 0.6, (n, 3)) + [1.0, 0.2, 0.1], axis=0)
           + 5.0).astype(np.float32)
    bonds = np.asarray([[i, i + 1] for i in range(n - 1)], np.int32)
    angles = np.asarray([[i, i + 1, i + 2] for i in range(n - 2)], np.int32)
    dih = np.asarray([[i, i + 1, i + 2, i + 3] for i in range(n - 3)],
                     np.int32)
    topo = jm.Topology(
        bonds=jnp.asarray(bonds), bond_k=jnp.full((n - 1,), 300.0),
        bond_r0=jnp.full((n - 1,), 1.1),
        angles=jnp.asarray(angles), angle_k=jnp.full((n - 2,), 40.0),
        angle_theta0=jnp.full((n - 2,), 1.9),
        dihedrals=jnp.asarray(dih),
        dihedral_k=jnp.asarray(rng.uniform(0.5, 2.0, n - 3), jnp.float32),
        dihedral_n=jnp.asarray([1.0, 2.0, 3.0, 2.0, 1.0], jnp.float32),
        dihedral_phase=jnp.asarray(rng.uniform(0, np.pi, n - 3),
                                   jnp.float32))
    st = jm.MDState(
        pos=jnp.asarray(pos), vel=jnp.zeros((n, 3), jnp.float32),
        mass=jnp.full((n,), 12.0, jnp.float32),
        charge=jnp.asarray(rng.uniform(-0.3, 0.3, n), jnp.float32),
        type_id=jnp.asarray([0, 1] * 4, jnp.int32),
        box=jnp.full((3,), 20.0, jnp.float32))
    lj = jm.LJParams(epsilon=jnp.asarray([0.2, 0.1], jnp.float32),
                     sigma=jnp.asarray([3.0, 2.5], jnp.float32))
    return st, topo, lj


SYSTEMS = {"lj_fluid": (lj_system, 2.5), "water": (water_system, 2.5),
           "chain": (chain_system, 6.0)}


class TestEnergiesAndForcesAgainstJax:
    @pytest.mark.parametrize("name", sorted(SYSTEMS))
    def test_energies(self, name):
        make, cutoff = SYSTEMS[name]
        st, topo, lj = make()
        ts, tt, tl = _to_port(st, topo, lj)
        excl = jforces._bonded_exclusion(st.n, topo) \
            if topo.bonds is not None else None
        want_nb = float(jforces.nonbonded_energy(
            st.pos, st.charge, st.type_id, st.box, lj, cutoff, excl))
        got_nb = float(tforces.nonbonded_energy(
            ts.pos, ts.charge, ts.type_id, ts.box, tl, cutoff,
            None if excl is None else torch.from_numpy(np.array(excl))))
        assert got_nb == pytest.approx(want_nb, rel=ENERGY_RTOL)
        want_b = float(jforces.bonded_energy(st.pos, st.box, topo))
        got_b = float(tforces.bonded_energy(ts.pos, ts.box, tt))
        assert got_b == pytest.approx(want_b, rel=ENERGY_RTOL, abs=1e-6)

    @pytest.mark.parametrize("name", sorted(SYSTEMS))
    def test_autograd_forces_match_jax_grad(self, name):
        make, cutoff = SYSTEMS[name]
        st, topo, lj = make()
        ts, tt, tl = _to_port(st, topo, lj)
        f_j, e_j = jm.make_force_fn(topo, lj, cutoff, st.n,
                                    method="all_pairs")(st)
        f_t, e_t = tm.make_force_fn(tt, tl, cutoff, ts.n,
                                    method="all_pairs", device=CPU)(ts)
        assert _rel(f_t, f_j) < FORCE_REL
        for k in ("potential", "nonbonded", "bonded"):
            assert float(e_t[k]) == pytest.approx(float(e_j[k]),
                                                  rel=ENERGY_RTOL, abs=1e-5)
        assert not f_t.requires_grad and f_t.grad_fn is None

    def test_masked_pairs_keep_gradients_finite(self):
        """Two atoms on one site (r2 = 0, masked to 1 before any division)
        and an excluded bonded pair: finite forces, as jax.grad gives."""
        st, topo, lj = water_system()
        pos = st.pos.at[5].set(st.pos[4])
        st = st.replace(pos=pos)
        ts, tt, tl = _to_port(st, topo, lj)
        f_t, _ = tm.make_force_fn(tt, tl, 2.5, ts.n, device=CPU)(ts)
        assert bool(torch.isfinite(f_t).all())

    def test_forces_and_energy(self):
        st, topo, lj = lj_system()
        ts, tt, tl = _to_port(st, topo, lj)
        f_j, e_j = jm.forces_and_energy(st, topo, lj)
        f_t, e_t = tm.forces_and_energy(ts, tt, tl)
        assert _rel(f_t, f_j) < FORCE_REL

    def test_auto_picks_by_device(self):
        st, topo, lj = jm.create_lj_fluid(2000, density=0.2, seed=3)
        ts, tt, tl = _to_port(st, topo, lj)
        box = ts.box.numpy()
        cpu = tm.make_force_fn(tt, tl, 2.5, ts.n, box_static=box,
                               device=CPU)
        assert cpu.uses_cell_list      # the JAX package's CPU choice: 2000
        small = tm.make_force_fn(tt, tl, 2.5, 1999, box_static=box,
                                 device=CPU)
        assert not small.uses_cell_list
        assert tforces._cell_list_min_n(torch.device("cpu")) == \
            jforces._CELL_LIST_MIN_N_CPU


def _dynamics_pair(integrator, thermostat):
    st, topo, lj = jm.create_lj_fluid(64, density=0.5, T0=0.5, seed=4)
    ts, tt, tl = _to_port(st, topo, lj)
    kw = dict(dt=0.002, integrator=integrator, thermostat=thermostat,
              T0=1.2, tau=0.1)
    return (jm.MDSimulation(st, topo, lj, **kw),
            tm.MDSimulation(ts, tt, tl, **kw))


class TestSimulationAgainstJax:
    @pytest.mark.parametrize("thermostat", [None, "berendsen",
                                            "nose_hoover"])
    @pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog",
                                            "beeman"])
    def test_twenty_steps(self, integrator, thermostat):
        jsim, tsim = _dynamics_pair(integrator, thermostat)
        jsim.step(20)
        tsim.step(20)
        assert _rel(tsim.state.pos, jsim.state.pos) < DYNAMICS_REL
        assert _rel(tsim.state.vel, jsim.state.vel) < DYNAMICS_REL
        assert tsim.temperature() == pytest.approx(jsim.temperature(),
                                                   rel=DYNAMICS_REL)
        je, te = jsim.energies(), tsim.energies()
        assert set(te) == set(je)
        assert te["total"] == pytest.approx(je["total"], rel=DYNAMICS_REL)

    def test_water_with_cells_and_exclusions(self):
        st, topo, lj = jm.create_water_box(80, T0=0.5, seed=4)
        ts, tt, tl = _to_port(st, topo, lj)
        kw = dict(dt=0.0005, cutoff=2.5, thermostat="berendsen", T0=0.5,
                  force_method="cell_list")
        jsim = jm.MDSimulation(st, topo, lj, **kw)
        tsim = tm.MDSimulation(ts, tt, tl, **kw)
        assert tsim._force_fn.uses_cell_list
        jsim.step(10)
        tsim.step(10)
        assert _rel(tsim.state.pos, jsim.state.pos) < DYNAMICS_REL
        assert _rel(tsim.state.vel, jsim.state.vel) < DYNAMICS_REL

    def test_save_state_keys_and_values_match_jax(self, tmp_path):
        jsim, tsim = _dynamics_pair("velocity_verlet", None)
        jsim.run(20, record_trajectory=True, callback_interval=10)
        tsim.run(20, record_trajectory=True, callback_interval=10)
        j = json.load(open(jsim.save_state(str(tmp_path / "j.json"))))
        t = json.load(open(tsim.save_state(str(tmp_path / "t.json"))))
        assert set(t) == set(j)
        for k in ("time", "step_count", "dt", "integrator", "type_id"):
            assert t[k] == j[k] if k != "time" else \
                t[k] == pytest.approx(j[k])
        assert _rel(t["pos"], j["pos"]) < DYNAMICS_REL
        np.testing.assert_array_equal(t["box"], j["box"])
        with np.load(tsim.save_trajectory(str(tmp_path / "t.npz"))) as f:
            assert len(f.files) == 2
            assert f["arr_1"].shape == (64, 3)


class TestAndersenStatistics:
    def test_drives_temperature_and_hits_at_its_rate(self):
        st, topo, lj = tm.create_lj_fluid(125, density=0.6, T0=0.3, seed=5,
                                          device=CPU)
        sim = tm.MDSimulation(st, topo, lj, dt=0.002, thermostat="andersen",
                              T0=1.2, collision_rate=5.0, seed=3)
        sim.step(1500)
        assert 0.7 < sim.temperature() < 2.0
        # the same seed gives the same run; another seed another run
        again = tm.MDSimulation(st, topo, lj, dt=0.002,
                                thermostat="andersen", T0=1.2,
                                collision_rate=5.0, seed=3)
        other = tm.MDSimulation(st, topo, lj, dt=0.002,
                                thermostat="andersen", T0=1.2,
                                collision_rate=5.0, seed=4)
        again.step(1500)
        other.step(10)
        assert torch.equal(again.state.vel, sim.state.vel)

    def test_collision_rate(self):
        """With no forces (epsilon 0) a velocity changes only by a
        collision, each atom's with probability rate * dt a step: after
        100 steps a share 1 - (1 - 0.01)^100 = 0.634 of the atoms."""
        st, topo, lj = tm.create_lj_fluid(1000, epsilon=0.0, seed=7,
                                          device=CPU)
        sim = tm.MDSimulation(st, topo, lj, dt=0.002, thermostat="andersen",
                              T0=1.0, collision_rate=5.0, seed=2)
        sim.step(100)
        share = float((sim.state.vel != st.vel).any(1).float().mean())
        assert share == pytest.approx(1 - 0.99 ** 100, abs=0.06)

    def test_resampled_velocities_are_maxwellian(self):
        """With a collision every step, the velocities are fresh draws at
        T0: per-component variance kB T0 / m."""
        st, topo, lj = tm.create_lj_fluid(1000, density=0.05, T0=0.1,
                                          mass=2.0, seed=6, device=CPU)
        sim = tm.MDSimulation(st, topo, lj, dt=0.002, thermostat="andersen",
                              T0=1.5, collision_rate=1e4, seed=1)
        sim.step(1)
        v = sim.state.vel
        assert float(v.var()) == pytest.approx(1.5 / 2.0, rel=0.08)
        assert abs(float(v.mean())) < 0.05


class TestFactories:
    def test_lj_fluid(self):
        j, jt, jl = jm.create_lj_fluid(200, density=0.7, T0=1.3, seed=2)
        t, tt, tl = tm.create_lj_fluid(200, density=0.7, T0=1.3, seed=2,
                                       device=CPU)
        for f in ("pos", "mass", "charge", "box"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
        np.testing.assert_array_equal(t.type_id.numpy(), np.asarray(j.type_id))
        np.testing.assert_array_equal(tl.epsilon.numpy(),
                                      np.asarray(jl.epsilon))
        assert tt.bonds is None
        # Maxwell velocities: zero net momentum, temperature near T0
        assert float(t.vel.sum(0).abs().max()) < 1e-4
        assert float(tm.temperature(t)) == pytest.approx(1.3, rel=0.15)
        same, _, _ = tm.create_lj_fluid(200, density=0.7, T0=1.3, seed=2,
                                        device=CPU)
        assert torch.equal(same.vel, t.vel)

    def test_water_box(self):
        j, jt, jl = jm.create_water_box(20, T0=0.7, seed=3)
        t, tt, tl = tm.create_water_box(20, T0=0.7, seed=3, device=CPU)
        for f in ("pos", "mass", "charge", "box"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
        want = convert.topology_arrays(tt)
        for k, v in want.items():
            jv = getattr(jt, k)
            if v is None:
                assert jv is None, k
            else:
                np.testing.assert_array_equal(v, np.asarray(jv), err_msg=k)
        for f in ("epsilon", "sigma"):
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)))
        assert float(t.vel.sum(0).abs().max()) < 1e-4

    def test_load_from_pdb(self, tmp_path):
        pdb = tmp_path / "x.pdb"
        pdb.write_text(
            "ATOM      1  O   HOH A   1      10.000  10.000  10.000"
            "  1.00  0.00           O\n"
            "ATOM      2  H1  HOH A   1      10.960  10.000  10.000"
            "  1.00  0.00           H\n"
            "HETATM    3  C   LIG A   2      12.500   9.000  11.250"
            "  1.00  0.00            \n")
        j, _, jl = jm.load_from_pdb(str(pdb))
        t, tt, tl = tm.load_from_pdb(str(pdb), device=CPU)
        arrays = convert.state_arrays(t)
        for f in ("pos", "vel", "mass", "charge", "type_id", "box"):
            np.testing.assert_array_equal(arrays[f], np.asarray(getattr(j, f)))
        np.testing.assert_array_equal(tl.sigma.numpy(), np.asarray(jl.sigma))
        warm, _, _ = tm.load_from_pdb(str(pdb), T0=1.0, device=CPU)
        assert float(warm.vel.abs().max()) > 0

    def test_convert_round_trip(self):
        st, topo, lj = chain_system()
        ts, tt, tl = _to_port(st, topo, lj)
        back = convert.state_arrays(ts)
        assert back["type_id"].dtype == np.int32
        for f, v in back.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(st, f)))
        tb = convert.topology_arrays(tt)
        np.testing.assert_array_equal(tb["dihedrals"],
                                      np.asarray(topo.dihedrals))
        assert convert.lj_arrays(tl)["sigma"].tolist() == [3.0, 2.5]


class TestJaxInvariantsOnThePort:
    """tests/test_md.py on the port."""

    @staticmethod
    def dimer(r):
        return tm.MDState(
            pos=torch.tensor([[0.0, 0, 0], [r, 0, 0]]) + 10.0,
            vel=torch.zeros((2, 3)), mass=torch.ones(2),
            charge=torch.zeros(2), type_id=torch.zeros(2, dtype=torch.long),
            box=torch.full((3,), 50.0))

    @staticmethod
    def lj(eps=1.0):
        return tm.LJParams(epsilon=torch.tensor([eps]),
                           sigma=torch.tensor([1.0]))

    def test_lj_minimum_and_energy(self):
        r_min = 2.0 ** (1 / 6)
        f, e = tm.forces_and_energy(self.dimer(r_min), tm.Topology(),
                                    self.lj())
        assert abs(float(f[0, 0])) < 1e-3
        assert float(e["potential"]) == pytest.approx(-1.0, abs=1e-3)
        f_close, _ = tm.forces_and_energy(self.dimer(0.9), tm.Topology(),
                                          self.lj())
        f_far, _ = tm.forces_and_energy(self.dimer(1.5), tm.Topology(),
                                        self.lj())
        assert float(f_close[0, 0]) < 0 < float(f_far[0, 0])

    def test_minimum_image_convention(self):
        s = tm.MDState(pos=torch.tensor([[0.5, 5, 5], [9.5, 5, 5]]),
                       vel=torch.zeros((2, 3)), mass=torch.ones(2),
                       charge=torch.zeros(2),
                       type_id=torch.zeros(2, dtype=torch.long),
                       box=torch.full((3,), 10.0))
        _, e = tm.forces_and_energy(s, tm.Topology(), self.lj())
        assert abs(float(e["potential"])) < 0.1

    def test_newtons_third_law(self):
        st, topo, lj = tm.create_lj_fluid(64, seed=1, device=CPU)
        f, _ = tm.forces_and_energy(st, topo, lj)
        np.testing.assert_allclose(f.sum(0).numpy(), 0.0, atol=1e-2)

    def test_bond_force_restores(self):
        topo = tm.Topology(bonds=torch.tensor([[0, 1]]),
                           bond_k=torch.tensor([100.0]),
                           bond_r0=torch.tensor([1.0]))
        f, e = tm.forces_and_energy(self.dimer(1.5), topo, self.lj(0.0))
        assert float(e["bonded"]) == pytest.approx(0.5 * 100 * 0.25,
                                                   rel=1e-3)
        assert float(f[0, 0]) > 0

    def test_systems(self):
        state, _, _ = tm.create_lj_fluid(125, density=0.8, device=CPU)
        assert 125 / float(state.box.prod()) == pytest.approx(0.8, rel=1e-3)
        w, topo, _ = tm.create_water_box(8, device=CPU)
        assert w.n == 24 and tuple(topo.bonds.shape) == (16, 2)
        assert tuple(topo.angles.shape) == (8, 3)
        assert abs(float(w.charge.sum())) < 1e-4
        hot, _, _ = tm.create_lj_fluid(512, T0=1.5, seed=3, device=CPU)
        assert float(tm.temperature(hot)) == pytest.approx(1.5, rel=0.15)

    @pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog",
                                            "beeman"])
    def test_energy_conservation_nve(self, integrator):
        state, topo, lj = tm.create_lj_fluid(64, density=0.5, T0=0.5, seed=4,
                                             device=CPU)
        sim = tm.MDSimulation(state, topo, lj, dt=0.002,
                              integrator=integrator)
        e0 = sim.energies()["total"]
        sim.step(200)
        e1 = sim.energies()["total"]
        assert np.isfinite(e1)
        assert abs(e1 - e0) / max(abs(e0), 1e-6) < 0.05

    @pytest.mark.parametrize("thermostat", ["berendsen", "nose_hoover"])
    def test_thermostat_drives_temperature(self, thermostat):
        state, topo, lj = tm.create_lj_fluid(125, density=0.6, T0=0.3,
                                             seed=5, device=CPU)
        sim = tm.MDSimulation(state, topo, lj, dt=0.002,
                              thermostat=thermostat, T0=1.2, tau=0.1,
                              collision_rate=5.0)
        sim.step(1500)
        assert 0.7 < sim.temperature() < 2.0

    def test_water_box_runs_stable(self):
        state, topo, lj = tm.create_water_box(8, T0=0.5, device=CPU)
        sim = tm.MDSimulation(state, topo, lj, dt=0.0005, cutoff=6.0,
                              thermostat="berendsen", T0=0.5)
        sim.step(100)
        assert bool(torch.isfinite(sim.state.pos).all())
        e = sim.energies()
        assert np.isfinite(e["total"]) and e["bonded"] >= 0

    def test_simulation_api(self):
        state, topo, lj = tm.create_lj_fluid(27, seed=6, device=CPU)
        sim = tm.MDSimulation(state, topo, lj, dt=0.002)
        sim.run(30, record_trajectory=True, callback_interval=10)
        assert len(sim.trajectory) == 3
        m = sim.performance_metrics()
        assert m["num_steps"] == 30 and m["atom_steps_per_second"] > 0
        with pytest.raises(ValueError, match="unknown integrator"):
            tm.MDSimulation(state, topo, lj, integrator="rk9")
        with pytest.raises(ValueError, match="unknown thermostat"):
            tm.MDSimulation(state, topo, lj, thermostat="langevin")


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestCLI:
    def test_matches_the_jax_cli(self, tmp_path, capsys):
        argv = ["--num-atoms", "64", "--steps", "20", "--density", "0.5",
                "--temperature", "0.5"]
        rc_j, want = _cli(jcli.main, argv, capsys)
        rc_t, got = _cli(tcli.main, argv + [
            "--device", "cpu", "--output-state", str(tmp_path / "s.json"),
            "--output-trajectory", str(tmp_path / "t.npz")], capsys)
        assert rc_j == rc_t == 0
        assert set(got) == set(want)
        assert got["atoms"] == 64 and got["steps"] == 20
        # the Maxwell draws differ (torch vs jax.random): the same lattice
        # and temperature, so the same energy scale
        assert got["energy_initial"] == pytest.approx(
            want["energy_initial"], rel=0.1)
        assert json.load(open(tmp_path / "s.json"))["step_count"] == 20
        with np.load(tmp_path / "t.npz") as t:
            assert len(t.files) == 20

    def test_water_and_pdb(self, tmp_path, capsys):
        rc, out = _cli(tcli.main, ["--system", "water", "--num-molecules",
                                   "8", "--steps", "5", "--dt", "0.0005",
                                   "--cutoff", "6.0", "--device", "cpu"],
                       capsys)
        assert rc == 0 and out["atoms"] == 24
        assert tcli.main(["--system", "pdb", "--device", "cpu"]) == 2

    def test_default_device_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--num-atoms", "8", "--steps", "1"])


def test_jax_grad_forces_are_the_reference():
    """The JAX force function used above is jax.grad of its potential:
    the port's autograd forces are held to that, not to a difference
    quotient."""
    st, topo, lj = lj_system()
    e = lambda p: jforces.nonbonded_energy(  # noqa: E731
        p, st.charge, st.type_id, st.box, lj, 2.5)
    f_j = -np.asarray(jax.grad(e)(st.pos))
    ts, tt, tl = _to_port(st, topo, lj)
    f_t, _ = tm.make_force_fn(tt, tl, 2.5, ts.n, method="all_pairs",
                              device=CPU)(ts)
    assert _rel(f_t, f_j) < FORCE_REL
