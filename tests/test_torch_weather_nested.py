"""The port's two-way nesting (njw_tpu_torch.weather.nested) held against
the JAX package's, and the JAX package's own nesting tests
(tests/test_weather_nested.py) run on the port.

The transfer operators agree with JAX's to float32 rounding (atol 1e-6);
the nested stepper's run (20 coarse steps at 64^2 with a central patch)
agrees within rtol / atol 1e-5, the JAX planar tests' multi-step bound.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.weather import nested as jn  # noqa: E402
from njw_tpu.weather.grid import GridSpec as JGrid  # noqa: E402
from njw_tpu.weather.model import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather.model import Simulation as JSimulation  # noqa: E402

from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, WeatherState,
    make_stepper, make_tendency_fn,
)
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402
from njw_tpu_torch.weather.nested import (  # noqa: E402
    NestedGrid, NestedState, make_nested_sim, make_nested_swe_stepper,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(n, dx=1.0):
    return GridSpec(nx=n, ny=n, dx=dx, dy=dx)


def _gaussian(n, positions, h0=10.0, amp=0.3, sigma=4.0, center=24.0):
    yf, xf = np.meshgrid(positions, positions, indexing="ij")
    r2 = (yf - center) ** 2 + (xf - center) ** 2
    h = (h0 + amp * np.exp(-r2 / (2.0 * sigma ** 2))).astype(np.float32)
    z = torch.zeros(n, n)
    return WeatherState(u=z, v=z, h=torch.from_numpy(h))


def _run(stepper, s, n, dt):
    carry = stepper.init(s)
    for _ in range(n):
        carry, s = stepper.step(carry, s, float(np.float32(dt)))
    return s


def _random(ny, nx, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ny, nx))).astype(np.float32)


class TestAgainstJax:
    @pytest.mark.parametrize("ratio,patch", [(2, (8, 24, 6, 22)),
                                             (3, (4, 12, 5, 15))])
    def test_transfer_operators(self, ratio, patch):
        f = _random(32, 32, 1)
        g = _grid(32)
        tn = NestedGrid(g, patch, ratio)
        jnest = jn.NestedGrid(JGrid(nx=32, ny=32), patch, ratio)
        ft = torch.from_numpy(f)
        for name in ("prolong_frame", "prolong"):
            np.testing.assert_allclose(
                getattr(tn, name)(ft).numpy(),
                np.asarray(getattr(jnest, name)(jnp.asarray(f))), atol=1e-6)
        fine = _random(tn.nyf, tn.nxf, 2)
        np.testing.assert_allclose(
            tn.restrict(torch.from_numpy(fine)).numpy(),
            np.asarray(jnest.restrict(jnp.asarray(fine))), atol=1e-6)
        np.testing.assert_allclose(
            tn.feedback(ft, torch.from_numpy(fine)).numpy(),
            np.asarray(jnest.feedback(jnp.asarray(f), jnp.asarray(fine))),
            atol=1e-6)

    @pytest.mark.parametrize("method", ["rk4", "adams_bashforth"])
    def test_nested_run_matches_jax(self, method):
        """20 coarse steps at 64^2, a central patch, vortex strength 1."""
        kw = dict(grid_width=64, grid_height=64, dt=0.02, coriolis_f=1e-4,
                  integration_method=method)
        patch = (16, 48, 16, 48)
        jsim = jn.make_nested_sim(JSimulation, JSimConfig(**kw), "vortex",
                                  patch=patch, ratio=2, strength=1.0)
        sim = make_nested_sim(Simulation, SimConfig(device=CPU, **kw),
                              "vortex", patch=patch, ratio=2, strength=1.0)
        # the same initial state
        np.testing.assert_array_equal(sim.state.coarse.h.numpy(),
                                      np.asarray(jsim.state.coarse.h))
        jsim.step(20)
        sim.step(20)
        for part in ("coarse", "fine"):
            for k in ("u", "v", "h"):
                np.testing.assert_allclose(
                    getattr(getattr(sim.state, part), k).numpy(),
                    np.asarray(getattr(getattr(jsim.state, part), k)),
                    rtol=1e-5, atol=1e-5)


def test_prolong_restrict_linear_exact():
    nest = NestedGrid(_grid(32), patch=(8, 24, 6, 22), ratio=2)
    y, x = np.meshgrid(np.arange(32.0), np.arange(32.0), indexing="ij")
    f = torch.tensor(1.5 + 0.25 * x - 0.125 * y, dtype=torch.float32)
    fine = nest.prolong(f)
    assert fine.shape == (32, 32)
    yy = 8.0 + (np.arange(32) + 0.5) / 2.0 - 0.5
    xx = 6.0 + (np.arange(32) + 0.5) / 2.0 - 0.5
    yf, xf = np.meshgrid(yy, xx, indexing="ij")
    np.testing.assert_allclose(fine.numpy(), 1.5 + 0.25 * xf - 0.125 * yf,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(nest.restrict(fine).numpy(),
                               f[8:24, 6:22].numpy(), rtol=0, atol=1e-5)


def test_prolong_frame_ghost_ring():
    nest = NestedGrid(_grid(32), patch=(8, 24, 8, 24), ratio=2)
    y, x = np.meshgrid(np.arange(32.0), np.arange(32.0), indexing="ij")
    f = torch.tensor(x + 2.0 * y, dtype=torch.float32)
    frame = nest.prolong_frame(f)
    assert frame.shape == (34, 34)
    np.testing.assert_allclose(frame[1:-1, 1:-1].numpy(),
                               nest.prolong(f).numpy(), atol=1e-6)
    yy = 8.0 + (np.arange(-1, 33) + 0.5) / 2.0 - 0.5
    yf, xf = np.meshgrid(yy, yy.copy(), indexing="ij")
    np.testing.assert_allclose(frame.numpy(), xf + 2.0 * yf, atol=1e-5)


@pytest.mark.parametrize("patch", [(0, 16, 8, 24), (8, 31, 8, 24)])
def test_patch_validation(patch):
    with pytest.raises(ValueError):
        NestedGrid(_grid(32), patch=patch)


def test_uniform_state_is_steady():
    g = _grid(32)
    params = PhysicsParams(gravity=9.81, coriolis_f=1e-4)
    nest = NestedGrid(g, patch=(8, 24, 8, 24), ratio=2)
    stepper = make_nested_swe_stepper(g, params, nest, dt=0.02)
    z = torch.zeros(32, 32)
    h = torch.full((32, 32), 10.0)
    s = NestedState(coarse=WeatherState(u=z, v=z, h=h),
                    fine=WeatherState(u=nest.prolong(z), v=nest.prolong(z),
                                      h=nest.prolong(h)))
    s = _run(stepper, s, 3, 0.02)
    np.testing.assert_allclose(s.coarse.h.numpy(), 10.0, atol=1e-5)
    np.testing.assert_allclose(s.fine.h.numpy(), 10.0, atol=1e-5)
    np.testing.assert_allclose(s.fine.u.numpy(), 0.0, atol=1e-6)


def test_nested_beats_coarse_against_fine_truth():
    n, r, dt, steps = 48, 2, 0.02, 25
    g = _grid(n)
    params = PhysicsParams(gravity=9.81)
    patch = (12, 36, 12, 36)
    nest = NestedGrid(g, patch, ratio=r)
    coarse0 = _gaussian(n, np.arange(float(n)))
    gf = _grid(n * r, dx=1.0 / r)
    truth0 = _gaussian(n * r, (np.arange(n * r) + 0.5) / r - 0.5)
    plain = make_stepper("rk4", make_tendency_fn("shallow_water", g, params))
    fine_ref = make_stepper("rk4", make_tendency_fn("shallow_water", gf,
                                                    params))
    nested = make_nested_swe_stepper(g, params, nest, dt=dt)
    coarse_end = _run(plain, coarse0, steps, dt)
    truth_end = _run(fine_ref, truth0, steps * r, dt / r)
    fine0 = WeatherState(u=nest.prolong(coarse0.u),
                         v=nest.prolong(coarse0.v), h=nest.prolong(coarse0.h))
    nested_end = _run(nested, NestedState(coarse=coarse0, fine=fine0),
                      steps, dt)
    y0, y1, x0, x1 = patch
    t = truth_end.h.numpy().reshape(n, r, n, r).mean(axis=(1, 3))[y0:y1,
                                                                 x0:x1]
    err_coarse = np.abs(coarse_end.h.numpy()[y0:y1, x0:x1] - t)
    err_nested = np.abs(nested_end.coarse.h.numpy()[y0:y1, x0:x1] - t)
    assert np.isfinite(err_nested).all()
    assert err_nested.max() < 0.6 * err_coarse.max()


def test_nested_simulation():
    cfg = SimConfig(grid_width=48, grid_height=48, dt=0.02, max_steps=10,
                    output_interval=5, device=CPU)
    sim = make_nested_sim(Simulation, cfg, "vortex", patch=(12, 36, 12, 36),
                          ratio=2, strength=2.0)
    assert sim.stepper.name == "nested_rk4"
    sim.run(10, output_interval=5)
    assert sim.step_count == 10
    snap = sim.snapshots[-1]
    assert snap["h"].shape == (48, 48) and snap["fine_h"].shape == (48, 48)
    assert np.isfinite(snap["fine_h"]).all()
    assert sim.metrics.grid_points == 48 * 48


def test_nested_ab2_carry_threads_through_substeps():
    """Nested AB2 differs from nested Euler on the fine grid (a fine carry
    started anew each substep would make AB2 Euler there), and its fine
    carry is the last fine tendency, not the first."""
    g = _grid(32)
    params = PhysicsParams(gravity=9.81, coriolis_f=1e-4)
    nest = NestedGrid(g, patch=(8, 24, 8, 24), ratio=2)
    pos_f = 8.0 + (np.arange(32) + 0.5) / 2.0 - 0.5

    def run(method):
        stepper = make_nested_swe_stepper(g, params, nest, dt=0.05,
                                          method=method)
        s = NestedState(coarse=_gaussian(32, np.arange(32.0), center=16.0),
                        fine=_gaussian(32, pos_f, center=16.0))
        return _run(stepper, s, 6, 0.05)

    ab2, eul = run("adams_bashforth"), run("euler")
    assert float((ab2.fine.h - eul.fine.h).abs().max()) > 1e-6
    assert torch.isfinite(ab2.fine.h).all()


@pytest.mark.parametrize("ratio", ["2", "4"])
def test_cli_nest_patch(ratio):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--device", "cpu", "--width", "32", "--height", "32",
                       "--steps", "3", "--dt", "0.01", "--nest-patch",
                       "8,24,8,24", "--nest-ratio", ratio, "--json"])
    assert rc == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])[
        "num_steps"] == 2


def test_cli_nest_patch_needs_cartesian_swe(capsys):
    assert cli_main(["--device", "cpu", "--model", "barotropic",
                     "--nest-patch", "8,24,8,24"]) == 2
    assert "--nest-patch requires" in capsys.readouterr().err
