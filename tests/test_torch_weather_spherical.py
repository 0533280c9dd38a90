"""The port's spectral cores (njw_tpu_torch.weather.spherical) held against
the JAX package's, and the JAX package's own spectral-core tests
(tests/test_weather_spherical.py:131-316) run on the port.

The JAX states are packed (2, ...) float pairs at its Simulation's
boundaries; they cross as ``unpack_state`` of the port. Tendencies are
compared normalised by the largest |value| of JAX's (atol 1e-5, the
transform bound); 20-step runs at 1e-4 (the fold trajectory test's
bound), normalised by field group (``_close_state``).
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops.sht import SphericalHarmonicTransform as JSHT  # noqa: E402
from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402
from njw_tpu.weather import spherical as jsp  # noqa: E402

from njw_tpu_torch.ops.sht import SphericalHarmonicTransform  # noqa: E402
from njw_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_simulation, save_simulation,
)
from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402
from njw_tpu_torch.weather import make_stepper  # noqa: E402
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402
from njw_tpu_torch.weather.spherical import (  # noqa: E402
    EARTH_OMEGA, SphericalBarotropicState, SphericalSWEState,
    bve_tendencies, pack_state, rossby_haurwitz_bve, rossby_haurwitz_swe,
    semi_implicit_spherical_swe, swe_tendencies, unpack_state,
    williamson2_state,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE: dict = {}


def _pair(nlat=32, fold=False):
    key = (nlat, fold)
    if key not in _CACHE:
        _CACHE[key] = (JSHT(nlat, fold_parity=fold),
                       SphericalHarmonicTransform(nlat, fold_parity=fold,
                                                  device=CPU))
    return _CACHE[key]


@pytest.fixture(scope="module")
def sht():
    return _pair(32)[1]


def _close(got, want, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _close_state(got, want, atol):
    """Each field normalised by its group's scale: the winds' zeta and div
    share one (the largest |value| of either, as the planar semi-implicit
    tests let u and v share one), phi has its own. A balanced state's div
    is orders below its zeta and carries the winds' rounding."""
    wind = max(np.abs(np.asarray(getattr(want, f))).max()
               for f in ("zeta", "div") if hasattr(want, f))
    for f, v in got.items():
        w = np.asarray(getattr(want, f))
        scale = (np.abs(w).max() if f == "phi" else wind) + 1e-30
        np.testing.assert_allclose(np.asarray(v) / scale, w / scale,
                                   rtol=0, atol=atol, err_msg=f)


def _to_port(js):
    """A JAX complex state as the port's state of the same class."""
    cls = (SphericalBarotropicState
           if isinstance(js, jsp.SphericalBarotropicState)
           else SphericalSWEState)
    return cls(**{f: torch.from_numpy(np.array(getattr(js, f)))
                  for f in cls.FIELDS})


def _run(stepper, s, dt, n):
    carry = stepper.init(s)
    for _ in range(n):
        carry, s = stepper.step(carry, s, float(np.float32(dt)))
    return s


def _jrun(stepper, s, dt, n):
    carry = stepper.init(s)
    step = jax.jit(stepper.step)
    for _ in range(n):
        carry, s = step(carry, s, jnp.float32(dt))
    return s


def _random_swe(j, seed=0):
    """A random state of TC2's magnitudes (zeta ~ 1e-5, div ~ 1e-6, phi
    3e4 + 1e3). A balanced state (TC2, TC6) makes the div and phi
    tendencies small differences of large terms, where float32 rounding
    of either package's sums shows at 1e-4 of the difference; the runs
    below hold the balanced states."""
    rng = np.random.default_rng(seed)

    def field(scale, mean=0.0):
        g = mean + scale * rng.standard_normal((j.nlat, j.nlon))
        return j.analysis(jnp.asarray(g.astype(np.float32)))

    return jsp.SphericalSWEState(zeta=field(1e-5), div=field(1e-6),
                                 phi=field(1e3, 3e4))


@pytest.mark.parametrize("nlat,fold", [(32, False), (32, True),
                                       (64, False), (64, True)])
class TestTendenciesAgainstJax:
    @pytest.mark.parametrize("nu4", [0.0, 1e15])
    def test_swe(self, nlat, fold, nu4):
        j, t = _pair(nlat, fold)
        js = _random_swe(j)
        jt = jsp.swe_tendencies(js, j, EARTH_OMEGA, nu4)
        tt = swe_tendencies(_to_port(js), t, EARTH_OMEGA, nu4)
        for f in ("zeta", "div", "phi"):
            _close(getattr(tt, f), getattr(jt, f))

    def test_bve(self, nlat, fold):
        j, t = _pair(nlat, fold)
        rng = np.random.default_rng(1)
        zg = 1e-5 * rng.standard_normal((nlat, 2 * nlat)).astype(np.float32)
        js = jsp.SphericalBarotropicState(zeta=j.analysis(jnp.asarray(zg)))
        jt = jsp.bve_tendencies(js, j, EARTH_OMEGA, 1e15)
        tt = bve_tendencies(_to_port(js), t, EARTH_OMEGA, 1e15)
        _close(tt.zeta, jt.zeta)


class TestAgainstJax:
    def test_initial_conditions(self):
        j, t = _pair(32)
        for jf, tf in ((jsp.williamson2_state(j, EARTH_OMEGA),
                        williamson2_state(t, EARTH_OMEGA)),
                       (jsp.rossby_haurwitz_swe(j, EARTH_OMEGA),
                        rossby_haurwitz_swe(t, EARTH_OMEGA))):
            for f in ("zeta", "div", "phi"):
                _close(getattr(tf, f), getattr(jf, f), atol=1e-6)
        np.testing.assert_array_equal(
            rossby_haurwitz_bve(t).zeta.numpy(),
            np.asarray(jsp.rossby_haurwitz_bve(j).zeta))

    @pytest.mark.parametrize("order", [1, 2])
    def test_semi_implicit(self, order):
        j, t = _pair(32)
        js = jsp.rossby_haurwitz_swe(j, EARTH_OMEGA)
        phi_ref = float(np.real(np.asarray(js.phi)[0, 0]))
        jsi = jsp.semi_implicit_spherical_swe(j, EARTH_OMEGA,
                                              phi_ref=phi_ref, nu4=1e15,
                                              order=order)
        tsi = semi_implicit_spherical_swe(t, EARTH_OMEGA, phi_ref=phi_ref,
                                          nu4=1e15, order=order)
        ja = _jrun(jsi, js, 1200.0, 20)
        ta = _run(tsi, _to_port(js), 1200.0, 20)
        _close_state(ta, ja, 1e-4)

    @pytest.mark.parametrize("model,ic,dt", [
        ("barotropic", "rossby_haurwitz", 900.0),
        ("shallow_water", "williamson2", 300.0),
        ("shallow_water", "rossby_haurwitz", 300.0)])
    def test_simulation_run(self, model, ic, dt):
        """20 RK4 steps through both packages' Simulation.from_config."""
        kw = dict(model=model, grid_type="spherical_harmonic",
                  grid_width=64, grid_height=32, dt=dt)
        jsim = JSimulation.from_config(JSimConfig(**kw), ic, nu4=1e15)
        sim = Simulation.from_config(SimConfig(device=CPU, **kw), ic,
                                     nu4=1e15)
        jsim.step(20)
        sim.step(20)
        _close_state(sim.state, jsp.unpack_state(jsim.state), 1e-4)
        jo, to = jsim.output_fn(jsim.state), sim.output_fn(sim.state)
        assert set(jo) == set(to)
        # grid fields by group: the winds share one scale, and vorticity
        # and divergence another (TC2's divergence is rounding alone)
        for group in (("u", "v"), ("zeta", "divergence"), ("h",), ("psi",)):
            names = [k for k in group if k in jo]
            if not names:
                continue
            scale = max(np.abs(np.asarray(jo[k])).max() for k in names)
            for k in names:
                np.testing.assert_allclose(to[k].numpy() / scale,
                                           np.asarray(jo[k]) / scale,
                                           rtol=0, atol=1e-4, err_msg=k)

    def test_pack_state(self):
        j, t = _pair(32)
        js = jsp.williamson2_state(j, EARTH_OMEGA)
        p = pack_state(_to_port(js))
        jp = jsp.pack_state(js)
        for f in ("zeta", "div", "phi"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(jp, f)))
        back = unpack_state(p)
        assert torch.equal(back.phi, _to_port(js).phi)

    def test_checkpoint_crosses_packages(self, tmp_path):
        """A JAX spectral checkpoint (packed leaves) loads into the port's
        complex state, and the port's loads into JAX's packed state."""
        from njw_tpu.utils import checkpoint as jck

        kw = dict(model="shallow_water", grid_type="spherical_harmonic",
                  grid_width=64, grid_height=32, dt=300.0)
        jsim = JSimulation.from_config(JSimConfig(**kw), "williamson2")
        jsim.step(2)
        sim = Simulation.from_config(SimConfig(device=CPU, **kw),
                                     "williamson2")
        restore_simulation(jck.save_simulation(str(tmp_path / "j"), jsim),
                           sim)
        want = jsp.unpack_state(jsim.state)
        for f, v in sim.state.items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(getattr(want, f)))
        state, _ = jck.load_checkpoint(
            save_simulation(str(tmp_path / "t"), sim), like=jsim.state)
        for f in ("zeta", "div", "phi"):
            np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                          np.asarray(getattr(jsim.state, f)))


class TestParityFold:
    def test_swe_trajectory_matches_unfolded(self, sht):
        folded = _pair(32, True)[1]
        s0 = rossby_haurwitz_swe(sht, EARTH_OMEGA)
        outs = []
        for t in (sht, folded):
            st = make_stepper("rk4", lambda s, t=t: swe_tendencies(
                s, t, EARTH_OMEGA, nu4=1e15))
            outs.append(_run(st, s0, 600.0, 20))
        for f in ("zeta", "div", "phi"):
            _close(getattr(outs[1], f), getattr(outs[0], f), atol=1e-4)


class TestBVE:
    def test_rossby_haurwitz_exact_rotation(self, sht):
        m, n = 4, 5
        s0 = rossby_haurwitz_bve(sht, m=m, n=n, amplitude=8e-5)
        st = make_stepper("rk4", lambda s: bve_tendencies(s, sht,
                                                          EARTH_OMEGA))
        dt, nsteps = 900.0, 96  # one day
        s1 = _run(st, s0, dt, nsteps)
        om_r = 2.0 * EARTH_OMEGA / (n * (n + 1))
        exact = s0.zeta * np.exp(1j * m * om_r * dt * nsteps)
        got, want = sht.synthesis(s1.zeta), sht.synthesis(exact)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4

    def test_mean_vorticity_and_enstrophy_conserved(self, sht):
        # the JAX test's own draw (jax.random.key(0)), as numpy
        zg = torch.from_numpy(np.array(1e-5 * jax.random.normal(
            jax.random.key(0), (sht.nlat, sht.nlon)), np.float32))
        s0 = SphericalBarotropicState(zeta=sht.analysis(zg))
        st = make_stepper("rk4", lambda s: bve_tendencies(s, sht,
                                                          EARTH_OMEGA))
        s1 = _run(st, s0, 900.0, 32)
        scale = float(sht.synthesis(s0.zeta).abs().max())
        assert abs(complex(s1.zeta[0, 0])) < 1e-2 * scale
        ens0 = float(sht.global_mean(sht.synthesis(s0.zeta) ** 2))
        ens1 = float(sht.global_mean(sht.synthesis(s1.zeta) ** 2))
        assert abs(ens1 - ens0) < 2e-2 * ens0


class TestSphericalSWE:
    def test_williamson2_steady(self, sht):
        s0 = williamson2_state(sht, EARTH_OMEGA)
        st = make_stepper("rk4", lambda s: swe_tendencies(s, sht,
                                                          EARTH_OMEGA))
        s1 = _run(st, s0, 300.0, 96)  # 8 hours
        p0, p1 = sht.synthesis(s0.phi), sht.synthesis(s1.phi)
        assert float(torch.linalg.norm(p1 - p0) / torch.linalg.norm(p0)) \
            < 1e-5
        assert float(sht.synthesis(s1.div).abs().max()) < 1e-8

    def test_rossby_haurwitz_tc6_stable_and_conserves_mass(self, sht):
        s0 = rossby_haurwitz_swe(sht, EARTH_OMEGA)
        st = make_stepper("rk4", lambda s: swe_tendencies(
            s, sht, EARTH_OMEGA, nu4=1e16))
        s1 = _run(st, s0, 180.0, 60)  # 3 hours
        assert torch.isfinite(sht.synthesis(s1.phi)).all()
        rel = abs(complex(s1.phi[0, 0] - s0.phi[0, 0])) \
            / abs(complex(s0.phi[0, 0]))
        assert rel < 1e-5


class TestSemiImplicit:
    def test_stable_beyond_explicit_cfl(self):
        t = _pair(64)[1]
        s0 = williamson2_state(t, EARTH_OMEGA)
        phi_ref = float(s0.phi[0, 0].real)
        si = semi_implicit_spherical_swe(t, EARTH_OMEGA, phi_ref=phi_ref)
        s_si = _run(si, s0, 3600.0, 24)  # one model day
        p0, p1 = t.synthesis(s0.phi), t.synthesis(s_si.phi)
        assert torch.isfinite(p1).all()
        assert float(torch.linalg.norm(p1 - p0) / torch.linalg.norm(p0)) \
            < 1e-4
        rk4 = make_stepper("rk4", lambda s: swe_tendencies(s, t,
                                                           EARTH_OMEGA))
        h_ex = t.synthesis(_run(rk4, s0, 3600.0, 48).phi)
        assert not bool(torch.isfinite(h_ex).all()) \
            or float((h_ex - p0).abs().max()) > 1e3

    def test_small_dt_consistency_with_rk4(self, sht):
        s0 = rossby_haurwitz_swe(sht, EARTH_OMEGA)
        si = semi_implicit_spherical_swe(sht, EARTH_OMEGA,
                                         phi_ref=float(s0.phi[0, 0].real))
        rk4 = make_stepper("rk4", lambda s: swe_tendencies(s, sht,
                                                           EARTH_OMEGA))
        pa = sht.synthesis(_run(si, s0, 60.0, 30).phi)
        pb = sht.synthesis(_run(rk4, s0, 60.0, 30).phi)
        assert float((pa - pb).abs().max()) < 2e-4 * float(pb.abs().max())


class TestSimulationIntegration:
    def test_from_config_bve(self):
        cfg = SimConfig(model="barotropic", grid_type="spherical_harmonic",
                        grid_width=64, grid_height=32, dt=900.0, device=CPU)
        sim = Simulation.from_config(cfg, "rossby_haurwitz")
        sim.step(4)
        out = sim.output_fn(sim.state)
        assert set(out) == {"zeta", "psi", "u", "v"}
        assert out["u"].shape == (32, 64) and torch.isfinite(out["u"]).all()

    @pytest.mark.parametrize("grid_type,method", [
        ("spherical_harmonic", "rk4"), ("spectral", "semi_implicit")])
    def test_from_config_swe(self, grid_type, method):
        cfg = SimConfig(model="shallow_water", grid_type=grid_type,
                        grid_width=64, grid_height=32, dt=300.0,
                        integration_method=method, si_order=2, device=CPU)
        sim = Simulation.from_config(cfg, "williamson2")
        assert sim.stepper.name == method
        sim.step(4)
        out = sim.output_fn(sim.state)
        assert {"h", "u", "v", "zeta", "divergence"} <= set(out)
        assert torch.isfinite(out["h"]).all()

    @pytest.mark.parametrize("kw,match", [
        (dict(grid_width=64, grid_height=64), "2\\*grid_height"),
        (dict(boundary_condition="clamped"), "no boundaries"),
        (dict(backend="kernel"), "cartesian grid"),
        (dict(integration_method="semi_implicit"), "BVE has none")])
    def test_refusals(self, kw, match):
        base = dict(model="barotropic", grid_type="spherical_harmonic",
                    grid_width=64, grid_height=32, device=CPU)
        with pytest.raises(ValueError, match=match):
            Simulation.from_config(SimConfig(**{**base, **kw}),
                                   "rossby_haurwitz")

    def test_cli_spherical(self, tmp_path):
        out = tmp_path / "sph.npz"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--device", "cpu", "--model", "shallow_water",
                           "--grid-type", "spherical_harmonic", "--width",
                           "64", "--height", "32", "--dt", "300", "--steps",
                           "8", "--json", "--output", str(out)])
        assert rc == 0
        with np.load(out) as data:
            assert np.isfinite(data["final_h"]).all()

    def test_cli_vortex_maps_to_rossby_haurwitz(self):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--device", "cpu", "--model", "barotropic",
                           "--grid-type", "spherical_harmonic", "--width",
                           "64", "--height", "32", "--dt", "900", "--steps",
                           "3", "--json"])
        assert rc == 0
        assert json.loads(buf.getvalue().strip().splitlines()[-1])[
            "num_steps"] == 2
