"""The port's particle-mesh and P3M gravity held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
everything runs on the CPU. Tolerances: the CIC deposit and gather at
rtol 1e-6 of the largest value (both add the same products in index
order); PM and P3M accelerations and the PM energy at 1e-5 of the
largest (float32 FFTs of the same grid: pocketfft in both packages on
the CPU). The JAX file's PM and P3M tests (tests/test_nbody.py:165-283)
run again on the port at their sizes and tolerances.

P3M's spectral gradient ``-1j k phi_k`` is not Hermitian at the Nyquist
and DC bins. ``test_p3m_with_strong_nyquist_modes`` holds the port to
JAX on a checkerboard mass distribution, whose spectrum is mostly those
modes. On the CPU both packages compute that inverse with pocketfft; the
card-only ``TestParticlesOnCard`` case holds the card to the CPU on the
same input, where cuFFT's C2R without the port's ``_irfftn`` gives
another answer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.nbody as jn  # noqa: E402
from njw_tpu.md.ewald import make_ewald_coulomb as j_ewald  # noqa: E402
from njw_tpu.nbody import pm as jpm  # noqa: E402

import njw_tpu_torch.nbody as tn  # noqa: E402
from njw_tpu_torch.md.ewald import make_ewald_coulomb  # noqa: E402
from njw_tpu_torch.md.forces import COULOMB_K  # noqa: E402
from njw_tpu_torch.nbody import convert  # noqa: E402
from njw_tpu_torch.nbody import pm  # noqa: E402

CPU = "cpu"
CIC_RTOL = 1e-6
MESH_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed, box=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 3)) * box).astype(np.float32),
            (0.5 + rng.random(n)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-30))


def checkerboard(mesh: int, box: float = 1.0):
    """One particle at each cell centre with mass 1 + 0.9 (-1)^(i+j+k),
    and a few random ones: the mass grid is mostly its Nyquist mode."""
    h = box / mesh
    i = np.stack(np.meshgrid(*[np.arange(mesh)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    pos = ((i + 0.5) * h).astype(np.float32)
    mass = (1.0 + 0.9 * (-1.0) ** i.sum(1)).astype(np.float32)
    extra_pos, extra_mass = _cloud(64, seed=13, box=box)
    return (np.concatenate([pos, extra_pos]),
            np.concatenate([mass, extra_mass]))


class TestAgainstJax:
    @pytest.mark.parametrize("mesh", [16, 32])
    def test_cic_deposit(self, mesh):
        pos, mass = _cloud(3000, seed=mesh)
        want = np.asarray(jpm.cic_deposit(jnp.asarray(pos), jnp.asarray(mass),
                                          mesh, 1.0))
        got = pm.cic_deposit(*_t(pos, mass), mesh, 1.0).numpy()
        np.testing.assert_allclose(got, want, rtol=CIC_RTOL,
                                   atol=CIC_RTOL * np.abs(want).max())

    @pytest.mark.parametrize("lead", [(), (3,)])
    def test_cic_gather(self, lead):
        mesh = 16
        pos, _ = _cloud(2000, seed=3)
        field = np.random.default_rng(4).standard_normal(
            lead + (mesh,) * 3).astype(np.float32)
        want = np.asarray(jpm.cic_gather(jnp.asarray(field),
                                         jnp.asarray(pos), mesh, 1.0))
        got = pm.cic_gather(*_t(field, pos), mesh, 1.0).numpy()
        assert got.shape == want.shape == lead + (2000,)
        np.testing.assert_allclose(got, want, rtol=CIC_RTOL,
                                   atol=CIC_RTOL * np.abs(want).max())

    @pytest.mark.parametrize("name", ["pm_accelerations",
                                      "p3m_accelerations"])
    @pytest.mark.parametrize("box", [1.0, 10.0])
    def test_accelerations(self, name, box):
        pos, mass = _cloud(3000, seed=5, box=box)
        pos -= box / 3          # some outside [0, box): wrapped by both
        want = np.asarray(getattr(jpm, name)(pos, mass, mesh=32, box=box,
                                             G=1.5))
        got = getattr(pm, name)(*_t(pos, mass), mesh=32, box=box, G=1.5)
        assert got.shape == (3000, 3) and got.dtype == torch.float32
        assert _rel(got, want) < MESH_REL

    def test_pm_potential_energy(self):
        pos, mass = _cloud(3000, seed=6)
        want = float(jpm.pm_potential_energy(pos, mass, mesh=32))
        got = float(pm.pm_potential_energy(*_t(pos, mass), mesh=32))
        assert got == pytest.approx(want, rel=MESH_REL)

    def test_p3m_with_strong_nyquist_modes(self):
        pos, mass = checkerboard(16)
        rho = pm.cic_deposit(*_t(pos, mass), 16, 1.0)
        spec = torch.fft.rfftn(rho).abs()
        assert float(spec[8, 8, 8]) > 0.5 * float(spec.max())  # Nyquist
        want = np.asarray(jpm.p3m_accelerations(pos, mass, mesh=16))
        got = pm.p3m_accelerations(*_t(pos, mass), mesh=16)
        assert _rel(got, want) < MESH_REL

    def test_irfftn_is_pocketfft_on_any_input(self):
        """The contract the card relies on: _irfftn is the inverse of
        rfftn, and on a spectrum that is not Hermitian it gives what
        pocketfft's irfftn gives (NumPy's, which JAX's CPU transform
        shares): a complex inverse over the first two axes, then a C2R
        that drops the imaginary parts of the last axis's bins 0 and
        mesh/2."""
        mesh = 8
        rng = np.random.default_rng(7)
        field = torch.from_numpy(rng.standard_normal((mesh,) * 3)
                                 .astype(np.float32))
        torch.testing.assert_close(pm._irfftn(torch.fft.rfftn(field), mesh),
                                   field, rtol=1e-5, atol=1e-5)
        shape = (3, mesh, mesh, mesh // 2 + 1)
        spec = (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)
        want = np.fft.irfftn(spec, s=(mesh,) * 3, axes=(-3, -2, -1))
        got = pm._irfftn(torch.from_numpy(spec), mesh).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("method", ["pm", "p3m"])
    def test_simulation(self, method):
        pos, mass = _cloud(2000, seed=8, box=10.0)
        vel = np.zeros_like(pos)
        js = jn.NBodySystem(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            mass=jnp.asarray(mass), G=1.0, softening=1e-3)
        ts = convert.system_from(dict(pos=pos, vel=vel, mass=mass, G=1.0,
                                      softening=1e-3), device=CPU)
        kw = dict(integrator="leapfrog", dt=1e-3, force_method=method,
                  pm_box=10.0, pm_mesh=32)
        jsim, tsim = jn.NBodySimulation(js, **kw), tn.NBodySimulation(ts, **kw)
        jsim.step(3)
        tsim.step(3)
        assert _rel(tsim.system.pos, jsim.system.pos) < MESH_REL
        assert _rel(tsim.system.vel, jsim.system.vel) < MESH_REL


class TestJaxInvariantsOnThePort:
    """tests/test_nbody.py:165-283 on the port."""

    def test_two_body_matches_newton(self):
        pos = np.array([[0.40, 0.5, 0.5], [0.55, 0.5, 0.5]], np.float32)
        acc = pm.pm_accelerations(*_t(pos, np.ones(2, np.float32)),
                                  mesh=96, box=1.0).numpy()
        newton = 1.0 / 0.15 ** 2
        assert acc[0, 0] > 0 > acc[1, 0]
        np.testing.assert_allclose(abs(acc[0, 0]), newton, rtol=0.08)
        np.testing.assert_allclose(acc[0], -acc[1], atol=newton * 0.02)

    def test_momentum_conservation(self):
        pos, mass = _cloud(5000, seed=3)
        acc = pm.pm_accelerations(*_t(pos, mass), mesh=32).numpy()
        net = (mass[:, None] * acc).sum(axis=0)
        scale = np.abs(mass[:, None] * acc).sum()
        assert np.abs(net).max() < 1e-4 * scale

    def test_mesh_consistency(self):
        pos = np.array([[0.35, 0.5, 0.5], [0.65, 0.5, 0.5]], np.float32)
        m = np.ones(2, np.float32)
        a64 = float(pm.pm_accelerations(*_t(pos, m), mesh=64)[0, 0])
        a128 = float(pm.pm_accelerations(*_t(pos, m), mesh=128)[0, 0])
        assert abs(a64 - a128) < 0.01 * abs(a128)
        newton = 1.0 / 0.3 ** 2
        assert 0.7 * newton < abs(a128) < newton

    @pytest.mark.parametrize("method,n,mesh,steps", [
        ("accelerations", 200_000, 64, 0), ("simulation", 100_000, 32, 3)])
    def test_large_n_runs(self, method, n, mesh, steps):
        rng = np.random.default_rng(4 if steps == 0 else 5)
        pos = rng.random((n, 3)).astype(np.float32)
        if method == "accelerations":
            acc = pm.pm_accelerations(*_t(pos, np.ones(n, np.float32)),
                                      mesh=mesh)
            assert acc.shape == (n, 3) and bool(torch.isfinite(acc).all())
            return
        s = tn.NBodySystem(pos=torch.from_numpy(pos),
                           vel=torch.zeros((n, 3)),
                           mass=torch.full((n,), 1.0 / n), G=1.0,
                           softening=1e-3)
        sim = tn.NBodySimulation(s, integrator="leapfrog", dt=1e-3,
                                 force_method="pm", pm_box=1.0, pm_mesh=mesh)
        sim.step(steps)
        assert bool(torch.isfinite(sim.system.pos).all())

    def test_p3m_matches_exact_ewald(self):
        rng = np.random.default_rng(12)
        pos = rng.random((40, 3)).astype(np.float32)
        mass = (0.5 + rng.random(40)).astype(np.float32)
        got = pm.p3m_accelerations(*_t(pos, mass), mesh=64, box=1.0).numpy()
        _, coul = make_ewald_coulomb(np.ones(3), alpha=6.0, r_cut=0.49,
                                     kmax=14, device=CPU)
        want = (-1.0 / COULOMB_K) * coul(pos, mass).numpy() / mass[:, None]
        np.testing.assert_allclose(got, want,
                                   atol=0.03 * np.abs(want).max())
        # and the port's Ewald forces against JAX's on the same input
        _, j_coul = j_ewald(np.ones(3), alpha=6.0, r_cut=0.49, kmax=14)
        assert _rel(coul(pos, mass), j_coul(pos, mass)) < 1e-4

    def test_short_range_restored_vs_pm(self):
        r = 0.02
        pos = np.array([[0.5 - r / 2, 0.5, 0.5], [0.5 + r / 2, 0.5, 0.5]],
                       np.float32)
        m = np.ones(2, np.float32)
        newton = 1.0 / r ** 2
        a_pm = abs(float(pm.pm_accelerations(*_t(pos, m), mesh=64)[0, 0]))
        a_p3m = abs(float(pm.p3m_accelerations(*_t(pos, m), mesh=64)[0, 0]))
        assert a_pm < 0.7 * newton
        assert abs(a_p3m - newton) < 0.05 * newton

    def test_p3m_overflowing_cell_poisons_with_nan(self):
        """Every particle in one cell, past the capacity that the mean
        occupancy sizes: the short range is NaN, not wrong."""
        pos = np.full((400, 3), 0.5, np.float32) + np.random.default_rng(
            1).random((400, 3)).astype(np.float32) * 1e-3
        acc = pm.p3m_accelerations(*_t(pos, np.ones(400, np.float32)),
                                   mesh=32)
        assert bool(torch.isnan(acc).all())
