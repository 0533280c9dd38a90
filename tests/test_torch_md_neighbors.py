"""The port's cell list and Ewald sum held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. The cell table, the atoms' cell coordinates,
the largest occupancy and the neighbour candidates are compared entry for
entry (both sort stably), as are ``cell_grid``, ``pick_capacity``,
``excluded_pair_list`` and ``kvectors``. Energies at rtol 1e-5, forces
at 1e-5 of the largest; the Ewald sum at rtol 1e-5 and its forces at
1e-4 of the largest (the reciprocal sum's float32 cos / sin of phases up
to ~40 rad). The JAX file's cell-list and Ewald tests
(tests/test_md.py:148-389) run again on the port at their sizes and
tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.md as jm  # noqa: E402
from njw_tpu.md import ewald as jewald  # noqa: E402
from njw_tpu.md import neighbors as jnb  # noqa: E402

import njw_tpu_torch.md as tm  # noqa: E402
from njw_tpu_torch.md import convert  # noqa: E402
from njw_tpu_torch.md import ewald  # noqa: E402
from njw_tpu_torch.md import neighbors as nb  # noqa: E402
from njw_tpu_torch.md.forces import COULOMB_K  # noqa: E402

CPU = "cpu"
ENERGY_RTOL = 1e-5
FORCE_REL = 1e-5
EWALD_FORCE_REL = 1e-4


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


def _positions(kind):
    """(pos, box) float32: a lattice (many atoms on cell boundaries and
    ties within a cell), random positions with some outside the box, and
    a cluster that overflows its cells."""
    rng = np.random.default_rng(3)
    if kind == "lattice":
        st, _, _ = jm.create_lj_fluid(1000, density=0.4, seed=3)
        return np.array(st.pos), np.array(st.box)
    box = np.asarray([11.0, 9.0, 13.0], np.float32)
    if kind == "random":
        return ((rng.random((1500, 3)) * 1.4 - 0.2) * box).astype(
            np.float32), box
    return (rng.random((400, 3)) * 2.0).astype(np.float32), box


class TestCellTableAgainstJax:
    @pytest.mark.parametrize("kind", ["lattice", "random", "cluster"])
    def test_table_and_candidates_equal(self, kind):
        pos, box = _positions(kind)
        nc = jnb.cell_grid(box, 2.5)
        assert nb.cell_grid(box, 2.5) == nc
        cap = 16 if kind == "cluster" else jnb.pick_capacity(len(pos), box,
                                                             nc)
        jt, jc, jo = jnb.build_cell_table(jnp.asarray(pos), jnp.asarray(box),
                                          nc, cap)
        tt, tc, to = nb.build_cell_table(torch.from_numpy(pos),
                                         torch.from_numpy(box), nc, cap)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert int(to) == int(jo)
        if kind == "cluster":
            assert int(to) > cap        # the overflow is dropped alike
        jcand = jnb.neighbor_candidates(jt, jc, nc)
        tcand = nb.neighbor_candidates(tt, tc, nc)
        np.testing.assert_array_equal(tcand.numpy(), np.asarray(jcand))

    @pytest.mark.parametrize("kind", ["lattice", "random", "cluster"])
    def test_pick_capacity_equal(self, kind):
        pos, box = _positions(kind)
        nc = jnb.cell_grid(box, 2.5)
        for kw in ({}, {"pos_static": pos}, {"headroom": 1.5}):
            assert nb.pick_capacity(len(pos), box, nc, **kw) == \
                jnb.pick_capacity(len(pos), box, nc, **kw)

    def test_cell_list_supported(self):
        for box, cutoff in (([7.4] * 3, 2.5), ([7.6] * 3, 2.5),
                            ([30.0, 5.0, 30.0], 2.5)):
            assert nb.cell_list_supported(box, cutoff) == \
                jnb.cell_list_supported(box, cutoff)

    def test_excluded_pair_list_equal(self):
        _, jtopo, _ = jm.create_water_box(20, seed=1)
        _, ttopo, _ = tm.create_water_box(20, seed=1, device=CPU)
        want = jnb.excluded_pair_list(jtopo)
        got = nb.excluded_pair_list(ttopo)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert nb.excluded_pair_list(tm.Topology()) is None


def _fluid(n, density, seed, jitter=0.1):
    st, topo, lj = jm.create_lj_fluid(n, density=density, seed=seed)
    noise = np.random.default_rng(seed).normal(
        scale=jitter, size=st.pos.shape).astype(np.float32)
    st = st.replace(pos=st.pos + jnp.asarray(noise))
    return st, topo, lj


class TestCellListEnergyAgainstJax:
    def test_energy(self):
        st, _, lj = _fluid(1000, 0.4, seed=2)
        ts, tl = (convert.state_from(st, device=CPU),
                  convert.lj_from(lj, device=CPU))
        box = np.asarray(st.box)
        nc = jnb.cell_grid(box, 2.5)
        cap = jnb.pick_capacity(st.n, box, nc)
        want = float(jnb.nonbonded_energy_cell_list(
            st.pos, st.charge, st.type_id, st.box, lj, 2.5, nc=nc,
            capacity=cap))
        got = float(nb.nonbonded_energy_cell_list(
            ts.pos, ts.charge, ts.type_id, ts.box, tl, 2.5, nc=nc,
            capacity=cap))
        assert got == pytest.approx(want, rel=ENERGY_RTOL)

    @pytest.mark.parametrize("system", ["lj_fluid", "water"])
    def test_forces(self, system):
        if system == "water":
            st, topo, lj = jm.create_water_box(80, seed=4)
        else:
            st, topo, lj = _fluid(2000, 0.3, seed=5)
        ts = convert.state_from(st, device=CPU)
        tt = convert.topology_from(topo, device=CPU)
        tl = convert.lj_from(lj, device=CPU)
        box = np.asarray(st.box)
        f_j, e_j = jm.make_force_fn(topo, lj, 2.5, st.n, method="cell_list",
                                    box_static=box)(st)
        fn = tm.make_force_fn(tt, tl, 2.5, ts.n, method="cell_list",
                              box_static=box, device=CPU)
        assert fn.uses_cell_list
        f_t, e_t = fn(ts)
        assert _rel(f_t, f_j) < FORCE_REL
        for k in ("potential", "nonbonded", "bonded"):
            assert float(e_t[k]) == pytest.approx(float(e_j[k]),
                                                  rel=ENERGY_RTOL, abs=1e-5)

    def test_excluded_pairs_energy(self):
        st, topo, lj = jm.create_water_box(27, seed=2)
        pairs = jnb.excluded_pair_list(topo)
        ts, tl = (convert.state_from(st, device=CPU),
                  convert.lj_from(lj, device=CPU))
        want = float(jnb.excluded_pairs_energy(
            st.pos, st.charge, st.type_id, st.box, lj, 2.5,
            jnp.asarray(pairs)))
        got = float(nb.excluded_pairs_energy(
            ts.pos, ts.charge, ts.type_id, ts.box, tl, 2.5,
            torch.from_numpy(pairs.astype(np.int64))))
        assert got == pytest.approx(want, rel=ENERGY_RTOL)


def nacl(a=2.0):
    """Rock-salt conventional cell: 8 ions, alternating charges, nearest
    neighbour distance a/2."""
    pos, q = [], []
    for i in range(2):
        for j in range(2):
            for k in range(2):
                pos.append([i * a / 2, j * a / 2, k * a / 2])
                q.append(1.0 if (i + j + k) % 2 == 0 else -1.0)
    return (np.asarray(pos, np.float32), np.asarray(q, np.float32),
            np.asarray([a, a, a], np.float32))


def _neutral(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    q = rng.standard_normal(n).astype(np.float32)
    return pos, q - q.mean()


class TestEwaldAgainstJax:
    @pytest.mark.parametrize("box,kmax", [([4.0, 4.0, 4.0], 6),
                                          ([3.0, 4.5, 5.0], 10)])
    def test_kvectors_bit_equal(self, box, kmax):
        np.testing.assert_array_equal(ewald.kvectors(box, kmax),
                                      jewald.kvectors(box, kmax))

    @pytest.mark.parametrize("alpha,r_cut,kmax", [(1.2, 1.99, 6),
                                                  (1.6, 1.99, 12)])
    def test_energy_and_forces(self, alpha, r_cut, kmax):
        pos, q = _neutral(16, 4.0, seed=6)
        box = np.full(3, 4.0, np.float32)
        je, jf = jewald.make_ewald_coulomb(box, alpha=alpha, r_cut=r_cut,
                                           kmax=kmax)
        te, tf = ewald.make_ewald_coulomb(box, alpha=alpha, r_cut=r_cut,
                                          kmax=kmax, device=CPU)
        assert float(te(pos, q)) == pytest.approx(float(je(pos, q)),
                                                  rel=ENERGY_RTOL)
        assert _rel(tf(pos, q), jf(pos, q)) < EWALD_FORCE_REL

    def test_direct_image_sum(self):
        pos, q = _neutral(6, 3.0, seed=8)
        box = np.full(3, 3.0, np.float32)
        want = float(jewald.direct_image_sum(pos, q, box, shells=2))
        got = float(ewald.direct_image_sum(
            torch.from_numpy(pos), torch.from_numpy(q),
            torch.from_numpy(box), shells=2))
        assert got == pytest.approx(want, rel=ENERGY_RTOL)


class TestJaxInvariantsOnThePort:
    """tests/test_md.py's cell-list and Ewald tests on the port."""

    @staticmethod
    def fluid(n, density=0.4, seed=3):
        st, _, lj = tm.create_lj_fluid(n, density=density, T0=1.0,
                                       seed=seed, device=CPU)
        return st, lj

    def test_energy_matches_all_pairs(self):
        s, lj = self.fluid(512)
        box = s.box.numpy()
        nc = nb.cell_grid(box, 2.5)
        cap = nb.pick_capacity(s.n, box, nc)
        e_cells = float(nb.nonbonded_energy_cell_list(
            s.pos, s.charge, s.type_id, s.box, lj, 2.5, nc=nc, capacity=cap))
        e_all = float(tm.forces.nonbonded_energy(
            s.pos, s.charge, s.type_id, s.box, lj, 2.5))
        assert e_cells == pytest.approx(e_all, rel=1e-4)

    @pytest.mark.parametrize("system", ["lj_2k", "water_80"])
    def test_forces_match_all_pairs(self, system):
        if system == "water_80":
            s, topo, lj = tm.create_water_box(80, seed=4, device=CPU)
            rtol, atol, key = 1e-3, 1e-2, "potential"
        else:
            s, lj = self.fluid(2000, density=0.2)
            topo, rtol, atol, key = tm.Topology(), 1e-3, 1e-3, "nonbonded"
        box = s.box.numpy()
        f_c, e_c = tm.make_force_fn(topo, lj, 2.5, s.n, method="cell_list",
                                    box_static=box, device=CPU)(s)
        f_a, e_a = tm.make_force_fn(topo, lj, 2.5, s.n, method="all_pairs",
                                    device=CPU)(s)
        assert float(e_c[key]) == pytest.approx(float(e_a[key]), rel=1e-4)
        np.testing.assert_allclose(f_c.numpy(), f_a.numpy(), rtol=rtol,
                                   atol=atol)

    def test_occupancy_diagnostic(self):
        s, _ = self.fluid(1000)
        box = s.box.numpy()
        nc = nb.cell_grid(box, 2.5)
        cap = nb.pick_capacity(s.n, box, nc)
        _, _, occ = nb.build_cell_table(s.pos, s.box, nc, cap)
        assert int(occ) <= cap

    def test_simulation_auto_selects_cells(self):
        s, _, lj = tm.create_lj_fluid(2500, density=0.3, seed=5, device=CPU)
        sim = tm.MDSimulation(s, lj=lj, dt=0.002)
        assert sim._force_fn.uses_cell_list
        sim.step(3)
        assert bool(torch.isfinite(sim.state.pos).all())

    def test_cell_list_errors(self):
        s, lj = self.fluid(64)
        with pytest.raises(ValueError, match="requires box_static"):
            tm.make_force_fn(tm.Topology(), lj, 2.5, s.n,
                             method="cell_list", device=CPU)
        with pytest.raises(ValueError, match=">= 3 cells"):
            tm.make_force_fn(tm.Topology(), lj, 2.5, s.n,
                             method="cell_list", box_static=[6.0] * 3,
                             device=CPU)

    def test_overflow_poisons_with_nan(self):
        rng = np.random.default_rng(0)
        pos = torch.from_numpy((rng.random((400, 3)) * 0.5)
                               .astype(np.float32))
        lj = tm.LJParams(epsilon=torch.ones(1), sigma=torch.ones(1))
        e = nb.nonbonded_energy_cell_list(
            pos, torch.zeros(400), torch.zeros(400, dtype=torch.long),
            torch.full((3,), 10.0), lj, 2.5, nc=(4, 4, 4), capacity=24)
        assert np.isnan(float(e))

    def test_clustered_capacity_from_positions(self):
        rng = np.random.default_rng(1)
        pos = (rng.random((400, 3)) * 0.5).astype(np.float32)
        box = np.asarray([10.0, 10.0, 10.0])
        nc = nb.cell_grid(box, 2.5)
        cap_blind = nb.pick_capacity(400, box, nc)
        cap_measured = nb.pick_capacity(400, box, nc, pos_static=pos)
        assert cap_measured >= 400 and cap_measured > cap_blind

    def test_excluded_pairs_deduped(self):
        topo = tm.Topology(
            bonds=torch.tensor([[0, 1], [1, 2], [2, 0]]),
            bond_k=torch.ones(3), bond_r0=torch.ones(3),
            angles=torch.tensor([[0, 1, 2]]), angle_k=torch.ones(1),
            angle_theta0=torch.ones(1))
        assert len(nb.excluded_pair_list(topo)) == 3

    def test_madelung_constant(self):
        pos, q, box = nacl(a=2.0)
        energy, _ = ewald.make_ewald_coulomb(box, alpha=3.0, r_cut=0.99,
                                             kmax=16, device=CPU)
        madelung = -2.0 * float(energy(pos, q)) * 1.0 / (COULOMB_K * len(q))
        np.testing.assert_allclose(madelung, 1.747565, rtol=1e-3)

    def test_alpha_independence(self):
        pos, q = _neutral(16, 4.0, seed=6)
        box = np.asarray([4.0, 4.0, 4.0], np.float32)
        e1, _ = ewald.make_ewald_coulomb(box, alpha=1.2, r_cut=1.99,
                                         kmax=10, device=CPU)
        e2, _ = ewald.make_ewald_coulomb(box, alpha=1.6, r_cut=1.99,
                                         kmax=12, device=CPU)
        np.testing.assert_allclose(float(e1(pos, q)), float(e2(pos, q)),
                                   rtol=2e-3)

    def test_forces_sum_to_zero(self):
        pos, q = _neutral(12, 3.0, seed=7)
        box = np.asarray([3.0, 3.0, 3.0], np.float32)
        _, forces = ewald.make_ewald_coulomb(box, alpha=1.5, r_cut=1.49,
                                             kmax=8, device=CPU)
        f = forces(pos, q).numpy()
        assert np.abs(f.sum(axis=0)).max() < 1e-2 * np.abs(f).max()
