"""The port's plain sharded steppers (njw_tpu_torch.parallel.halo:
sharded_swe_step, sharded_pe_step, sharded_barotropic_step) held against
the JAX package's and against the port's whole-domain runs.

JAX runs as its own tests run it: 8 virtual CPU devices
(tests/conftest.py). The inputs are the JAX package's own initial states,
carried across as numpy (njw_tpu_torch.weather.convert); the port runs on
LocalMesh(device='cpu') and, in the gloo case, on ProcessMesh in four CPU
processes. Tolerances are the JAX tests' (tests/test_parallel_halo.py:
SWE rtol/atol 1e-5 at :58-129, PE 2e-5 at :220-245 and ps 1e-5 / u 1e-4
with reflective walls at :131-157, barotropic rtol 5e-4 / atol 5e-5 at
:478-533). Where the port is held against its own whole-domain plain run
it must be equal bit for bit: the same operations in the same order.
"""
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from njw_tpu.parallel import halo as jhalo  # noqa: E402
from njw_tpu.weather import GridSpec as JGrid  # noqa: E402
from njw_tpu.weather import PhysicsParams as JParams  # noqa: E402
from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402
from njw_tpu.weather import WeatherState as JWeatherState  # noqa: E402
from njw_tpu.weather import make_initial_state as jmake_initial_state  # noqa: E402,E501
from njw_tpu.weather import primitive as jp  # noqa: E402

from njw_tpu_torch.parallel import (  # noqa: E402
    LocalMesh, PlainShardedStepper, sharded_barotropic_step,
    sharded_barotropic_step_2d, sharded_pe_step, sharded_swe_step,
)
from njw_tpu_torch.parallel.halo import _Shards  # noqa: E402
from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402
from njw_tpu_torch.weather.convert import (  # noqa: E402
    grid_from_jax_fields, params_from_jax_fields, shards_from_numpy,
    shards_to_numpy,
)
from njw_tpu_torch.weather.dynamics import coriolis_field  # noqa: E402
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams  # noqa: E402
from njw_tpu_torch.weather.primitive import pe_initial_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
SWE = ("u", "v", "h")
PE = ("u", "v", "T", "q", "ps")
SWE_TOL = dict(rtol=1e-5, atol=1e-5)
PE_TOL = dict(rtol=2e-5, atol=2e-5)
BARO_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(py, px):
    return Mesh(np.array(jax.devices()[:py * px]).reshape(py, px), ("y", "x"))


def _close(got: dict, want, names, **tol):
    for name in names:
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port(ctor, jgrid, jparams, shape, s0, **kw):
    """The port's run of ``ctor`` on a LocalMesh from the JAX state s0."""
    mesh = LocalMesh(*shape, device=CPU)
    step = ctor(grid_from_jax_fields(jgrid), params_from_jax_fields(jparams),
                mesh, **kw)
    return shards_to_numpy(step(shards_from_numpy(s0, mesh)), mesh)


def _jax_swe_state(grid, ic="vortex", **kw):
    s = jmake_initial_state(ic, grid, **kw)
    return JWeatherState(u=s.u, v=s.v, h=s.h)


# ----------------------------------------------------------------- SWE

class TestSWEAgainstJax:
    @pytest.mark.parametrize("shape,overlap,beta", [
        ((2, 2), True, 0.0), ((4, 1), True, 0.5), ((2, 4), False, 0.5)])
    def test_periodic_matches_jax_sharded(self, shape, overlap, beta):
        """tests/test_parallel_halo.py:58-84, :183-211: 20 RK4 steps."""
        grid = JGrid(nx=32, ny=32)
        params = JParams(coriolis_f=1e-4, beta=beta)
        s0 = _jax_swe_state(grid, strength=2.0)
        want = jhalo.sharded_swe_step(
            grid, params, _jmesh(*shape), dt=0.01, n_steps=20,
            overlap=overlap)(jhalo.sharded_state(s0, _jmesh(*shape)))
        got = _port(sharded_swe_step, grid, params, shape, s0, dt=0.01,
                    n_steps=20, overlap=overlap)
        _close(got, want, SWE, **SWE_TOL)

    @pytest.mark.parametrize("overlap", [True, False])
    def test_clamped_rk2_matches_jax(self, overlap):
        """tests/test_parallel_halo.py:86-105: breaking wave, RK2."""
        grid = JGrid(nx=32, ny=32, bc="clamped")
        params = JParams()
        s0 = _jax_swe_state(grid, "breaking_wave")
        want = jhalo.sharded_swe_step(
            grid, params, _jmesh(2, 2), dt=0.005, method="rk2", n_steps=10,
            overlap=overlap)(jhalo.sharded_state(s0, _jmesh(2, 2)))
        got = _port(sharded_swe_step, grid, params, (2, 2), s0, dt=0.005,
                    method="rk2", n_steps=10, overlap=overlap)
        _close(got, want, SWE, **SWE_TOL)

    def test_reflective_matches_jax_whole_domain(self):
        """tests/test_parallel_halo.py:107-129: random state with nonzero
        wall winds, so the ghost flip matters."""
        from njw_tpu.weather.dynamics import make_tendency_fn
        from njw_tpu.weather.integrators import make_stepper

        grid = JGrid(nx=32, ny=32, bc="reflective")
        params = JParams(coriolis_f=1e-4)
        s = jmake_initial_state("random", grid, seed=5)
        s0 = JWeatherState(u=s.u + 0.5, v=s.v - 0.3, h=s.h)
        st = make_stepper("rk4", make_tendency_fn("shallow_water", grid,
                                                  params))
        want = s0
        for _ in range(10):
            _, want = st.step((), want, jnp.float32(0.005))
        got = _port(sharded_swe_step, grid, params, (2, 2), s0, dt=0.005,
                    n_steps=10)
        _close(got, want, SWE, **SWE_TOL)


def _whole(cfg: SimConfig, ic: str, steps: int, **ic_kw):
    """(initial state, state after ``steps``) of the port's whole-domain
    plain run."""
    sim = Simulation.from_config(cfg, ic, **ic_kw)
    s0 = sim.state
    sim.step(steps)
    return s0, sim.state


class TestSWEAgainstWholeDomain:
    """The sharded run equals the whole-domain plain run bit for bit, on
    every mesh, BC and integrator (the beta-plane and viscosity on)."""

    @pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 4), (1, 1)])
    @pytest.mark.parametrize("bc", ["periodic", "clamped", "outflow",
                                    "reflective"])
    def test_every_bc_and_mesh(self, shape, bc):
        cfg = SimConfig(grid_width=24, grid_height=16, dt=0.01,
                        coriolis_f=1e-4, beta=0.5, viscosity=0.01,
                        boundary_condition=bc, backend="plain", device=CPU)
        s0, want = _whole(cfg, "vortex", 4, strength=2.0)
        mesh = LocalMesh(*shape, device=CPU)
        step = sharded_swe_step(cfg.grid_spec(), cfg.physics(), mesh,
                                dt=0.01, n_steps=4)
        got = mesh.gather_state(step(mesh.shard_state(s0)))
        _equal(got.to_numpy(), want.to_numpy())

    @pytest.mark.parametrize("method", ["euler", "rk2", "rk4",
                                        "adams_bashforth"])
    def test_every_integrator(self, method):
        cfg = SimConfig(grid_width=16, grid_height=16, dt=0.01,
                        coriolis_f=1e-4, integration_method=method,
                        boundary_condition="reflective", backend="plain",
                        device=CPU)
        s0, want = _whole(cfg, "vortex", 5, strength=2.0)
        mesh = LocalMesh(2, 2, device=CPU)
        step = sharded_swe_step(cfg.grid_spec(), cfg.physics(), mesh,
                                dt=0.01, method=method, n_steps=5)
        assert step.stages == {"euler": 1, "rk2": 2, "rk4": 4,
                               "adams_bashforth": 1}[method]
        got = mesh.gather_state(step(mesh.shard_state(s0)))
        _equal(got.to_numpy(), want.to_numpy())

    @pytest.mark.parametrize("bc", ["periodic", "clamped", "reflective"])
    @pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
    def test_overlap_equals_padded_path(self, bc, shape):
        """tests/test_parallel_halo.py:159-177: the interior/edge form is
        the padded form's arithmetic, point for point."""
        grid = GridSpec(nx=32, ny=32, bc=bc)
        params = PhysicsParams(coriolis_f=1e-4, beta=0.1, viscosity=0.01)
        cfg = SimConfig(grid_width=32, grid_height=32, device=CPU)
        s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
        mesh = LocalMesh(*shape, device=CPU)
        a, b = (shards_to_numpy(sharded_swe_step(
            grid, params, mesh, dt=0.01, n_steps=5, overlap=ov)(
            mesh.shard_state(s0)), mesh) for ov in (True, False))
        _equal(a, b)

    def test_small_shards_fall_back_to_padded(self):
        """Shards under 4 rows have no interior to overlap (:184)."""
        cfg = SimConfig(grid_width=16, grid_height=12, dt=0.01,
                        coriolis_f=1e-4, backend="plain", device=CPU)
        s0, want = _whole(cfg, "vortex", 3, strength=2.0)
        mesh = LocalMesh(4, 1, device=CPU)
        got = sharded_swe_step(cfg.grid_spec(), cfg.physics(), mesh,
                               dt=0.01, n_steps=3)(mesh.shard_state(s0))
        _equal(shards_to_numpy(got, mesh), want.to_numpy())

    def test_determinism_across_step_partitions(self):
        """tests/test_parallel_halo.py:213-227: 20 steps in one call equal
        two calls of 10."""
        grid = GridSpec(nx=32, ny=32)
        params = PhysicsParams()
        cfg = SimConfig(grid_width=32, grid_height=32, device=CPU)
        s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
        mesh = LocalMesh(2, 2, device=CPU)
        step20 = sharded_swe_step(grid, params, mesh, dt=0.01, n_steps=20)
        step10 = sharded_swe_step(grid, params, mesh, dt=0.01, n_steps=10)
        a = step20(mesh.shard_state(s0))
        b = step10(step10(mesh.shard_state(s0)))
        _equal(shards_to_numpy(a, mesh), shards_to_numpy(b, mesh))

    def test_beta_plane_rows_and_effect(self):
        """Each shard's f is its rows of the whole domain's
        coriolis_field; and beta changes the result (the failure mode of
        tests/test_parallel_halo.py:205-211)."""
        grid = GridSpec(nx=16, ny=32)
        params = PhysicsParams(coriolis_f=1e-4, beta=0.5)
        f = coriolis_field(grid, params, CPU)
        mesh = LocalMesh(4, 1, device=CPU)
        seen = []

        def fake_tendency(u, v, h, shift, grid_, p, interior=None):
            seen.append(p.coriolis_f)
            crop = interior
            return crop(u) * 0, crop(v) * 0, crop(h) * 0

        cfg = SimConfig(grid_width=16, grid_height=32, device=CPU)
        s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
        import njw_tpu_torch.parallel.halo as H
        orig = H.swe_tendencies_from_shifts
        H.swe_tendencies_from_shifts = fake_tendency
        try:
            sharded_swe_step(grid, params, mesh, dt=0.01, overlap=False,
                             method="euler")(mesh.shard_state(s0))
        finally:
            H.swe_tendencies_from_shifts = orig
        assert len(seen) == 4
        for iy, fs in enumerate(seen):
            assert torch.equal(fs, f[iy * 8:(iy + 1) * 8])
        with_beta, without = (shards_to_numpy(sharded_swe_step(
            grid, p, mesh, dt=0.01, n_steps=20)(mesh.shard_state(s0)), mesh)
            for p in (params, PhysicsParams(coriolis_f=1e-4)))
        assert np.abs(with_beta["u"] - without["u"]).max() > 1e-4


# ------------------------------------------------------------------ PE

class TestPE:
    def test_matches_jax_sharded(self):
        """tests/test_parallel_halo.py:230-255 (48 x 32 x 4, (2, 2), 10
        steps): the JAX sharded PE step."""
        grid = JGrid(nx=48, ny=32, levels=4, dx=1e5, dy=1e5)
        params = JParams(coriolis_f=1e-4)
        s0 = jp.pe_initial_state(grid, u_jet=15.0, perturb=0.5)
        want = jhalo.sharded_pe_step(grid, params, _jmesh(2, 2), dt=30.0,
                                     n_steps=10)(
            jhalo.sharded_state(s0, _jmesh(2, 2)))
        got = _port(sharded_pe_step, grid, params, (2, 2), s0, dt=30.0,
                    n_steps=10)
        _close(got, want, PE, **PE_TOL)

    def test_reflective_matches_jax_whole_domain(self):
        """tests/test_parallel_halo.py:131-157: reflective walls, the JAX
        whole-domain PE run (ps 1e-5, u 1e-4)."""
        from njw_tpu.weather.integrators import make_stepper

        grid = JGrid(nx=32, ny=32, levels=3, dx=1e5, dy=1e5, bc="reflective")
        params = JParams(coriolis_f=1e-4)
        s0 = jp.pe_initial_state(grid, u_jet=10.0, perturb=0.5)
        st = make_stepper("rk4", lambda s: jp.pe_tendencies(s, grid, params))
        want = s0
        for _ in range(10):
            _, want = st.step((), want, jnp.float32(30.0))
        got = _port(sharded_pe_step, grid, params, (2, 2), s0, dt=30.0,
                    n_steps=10)
        _close(got, want, ("ps",), rtol=1e-5, atol=1e-5)
        _close(got, want, ("u",), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("shape,bc,overlap", [
        ((2, 2), "periodic", True), ((4, 1), "reflective", True),
        ((2, 2), "clamped", False), ((1, 2), "periodic", True)])
    def test_matches_whole_domain(self, shape, bc, overlap):
        """Viscosity on: the port's whole-domain plain PE run, at the JAX
        sharded PE tolerance."""
        cfg = SimConfig(model="primitive", grid_width=24, grid_height=16,
                        num_levels=3, dx=1e5, dy=1e5, dt=30.0,
                        coriolis_f=1e-4, viscosity=1e3,
                        boundary_condition=bc, backend="plain", device=CPU)
        s0, want = _whole(cfg, "baroclinic", 4, u_jet=10.0, perturb=0.5)
        mesh = LocalMesh(*shape, device=CPU)
        step = sharded_pe_step(cfg.grid_spec(), cfg.physics(), mesh,
                               dt=30.0, n_steps=4, overlap=overlap)
        got = mesh.gather_state(step(mesh.shard_state(s0)))
        _close(got.to_numpy(), want, PE, **PE_TOL)


# ---------------------------------------------------------- barotropic

def _baro_jax(shape, params, steps=10):
    """(z0, the JAX sharded barotropic run): 64^2, vortex 3.0, dt 0.05
    (tests/test_parallel_halo.py:478-533)."""
    cfg = JSimConfig(model="barotropic", grid_width=64, grid_height=64,
                     dt=0.05, integration_method="rk4", beta=params.beta,
                     viscosity=params.viscosity)
    z0 = JSimulation.from_config(cfg, "vortex", strength=3.0).state
    grid = JGrid(nx=64, ny=64, dx=1.0, dy=1.0)
    py, px = shape
    if px == 1:
        mesh, spec = Mesh(np.array(jax.devices()[:py]), ("y",)), \
            P("y", None)
    else:
        mesh, spec = _jmesh(py, px), P("y", "x")
    step = jhalo.sharded_barotropic_step(grid, params, mesh, dt=0.05,
                                         method="rk4", n_steps=steps)
    zs = jax.tree.map(lambda a: jax.device_put(a, NamedSharding(mesh, spec)),
                      z0)
    return z0, step(zs), grid


class TestBarotropic:
    @pytest.mark.parametrize("shape,beta,nu", [
        ((4, 1), 1e-3, 0.0), ((4, 1), 1e-3, 1e-3), ((2, 4), 1e-3, 1e-3),
        ((2, 2), 1e-3, 1e-3)])
    def test_matches_jax_sharded(self, shape, beta, nu):
        params = JParams(beta=beta, viscosity=nu)
        z0, want, grid = _baro_jax(shape, params)
        got = _port(sharded_barotropic_step, grid, params, shape, z0,
                    dt=0.05, n_steps=10)
        _close(got, want, ("zeta",), **BARO_TOL)

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2), (2, 4), (8, 1),
                                       (1, 1)])
    def test_matches_whole_domain(self, shape):
        cfg = SimConfig(model="barotropic", grid_width=64, grid_height=64,
                        dt=0.05, beta=1e-3, viscosity=1e-3, backend="plain",
                        device=CPU)
        s0, want = _whole(cfg, "vortex", 10, strength=3.0)
        mesh = LocalMesh(*shape, device=CPU)
        step = sharded_barotropic_step(cfg.grid_spec(), cfg.physics(), mesh,
                                       dt=0.05, n_steps=10)
        assert step.name == ("sharded_barotropic_step_2d" if shape[1] > 1
                             else "sharded_barotropic_step")
        got = mesh.gather_state(step(mesh.shard_state(s0)))
        _close(got.to_numpy(), want, ("zeta",), **BARO_TOL)


# ------------------------------------------------------------ refusals

class TestRefusals:
    def test_barotropic_needs_periodic(self):
        mesh = LocalMesh(2, 1, device=CPU)
        for ctor in (sharded_barotropic_step, sharded_barotropic_step_2d):
            with pytest.raises(NotImplementedError, match="periodic"):
                ctor(GridSpec(nx=16, ny=16, bc="clamped"), PhysicsParams(),
                     mesh, dt=0.1)

    def test_barotropic_1d_divisibility(self):
        """halo.py:446-450: both axes divide by the shard count."""
        with pytest.raises(ValueError, match="BOTH axes"):
            sharded_barotropic_step(GridSpec(nx=18, ny=16), PhysicsParams(),
                                    LocalMesh(4, 1, device=CPU), dt=0.1)

    @pytest.mark.parametrize("ny,nx,match", [
        (17, 16, "must tile"), (12, 16, "BOTH axes"), (16, 12, "BOTH axes")])
    def test_barotropic_2d_divisibility(self, ny, nx, match):
        """halo.py:542-548 on a (2, 4) mesh: the grid tiles the mesh, ny
        and nx divide by 8 and the local rows by px."""
        with pytest.raises(ValueError, match=match):
            sharded_barotropic_step(GridSpec(nx=nx, ny=ny), PhysicsParams(),
                                    LocalMesh(2, 4, device=CPU), dt=0.1)

    @pytest.mark.parametrize("ctor", [sharded_swe_step, sharded_pe_step])
    def test_grid_not_divisible_and_unknown_method(self, ctor):
        grid = GridSpec(nx=16, ny=18, levels=2)
        with pytest.raises(ValueError, match="not divisible by mesh 4x1"):
            ctor(grid, PhysicsParams(), LocalMesh(4, 1, device=CPU), dt=0.1)
        with pytest.raises(ValueError, match="unknown method"):
            ctor(GridSpec(nx=16, ny=16, levels=2), PhysicsParams(),
                 LocalMesh(2, 1, device=CPU), dt=0.1,
                 method="semi_implicit")

    def test_shards_of_another_state_are_refused(self):
        mesh = LocalMesh(2, 1, device=CPU)
        step = sharded_swe_step(GridSpec(nx=16, ny=16), PhysicsParams(),
                                mesh, dt=0.1)
        assert isinstance(step, PlainShardedStepper)
        bad = mesh.shard_state(pe_initial_state(
            GridSpec(nx=16, ny=16, levels=2), device=CPU))
        with pytest.raises(TypeError, match="WeatherStates"):
            step(bad)

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded_swe_step(GridSpec(nx=16, ny=16), PhysicsParams(),
                             LocalMesh(2, 1), dt=0.1)

    def test_shard_list_maps_each_shard(self):
        mesh = LocalMesh(2, 1, device=CPU)
        s = _Shards(mesh.shard_state(pe_initial_state(
            GridSpec(nx=8, ny=8, levels=2), device=CPU)))
        two = s.map(lambda a, b: a + b, s)
        assert isinstance(two, _Shards) and len(two) == 2
        assert torch.equal(two[1].ps, 2 * s[1].ps)


# ---------------------------------------------------- ProcessMesh over gloo

# the runs, defined once for the gloo workers and for this process
_RUNS = textwrap.dedent('''
    from njw_tpu_torch.parallel import (
        sharded_barotropic_step, sharded_swe_step)
    from njw_tpu_torch.weather import SimConfig, Simulation

    RUNS = (("swe", (2, 2)), ("baro1d", (4, 1)), ("baro2d", (2, 2)))

    def run(name, mesh):
        if name == "swe":
            cfg = SimConfig(grid_width=32, grid_height=24, dt=0.01,
                            coriolis_f=1e-4, beta=0.5, device="cpu",
                            boundary_condition="reflective")
            s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
            step = sharded_swe_step(cfg.grid_spec(), cfg.physics(), mesh,
                                    dt=0.01, n_steps=4, overlap=True)
        else:
            cfg = SimConfig(model="barotropic", grid_width=32,
                            grid_height=32, dt=0.05, beta=1e-3,
                            viscosity=1e-3, device="cpu")
            s0 = Simulation.from_config(cfg, "vortex", strength=3.0).state
            step = sharded_barotropic_step(cfg.grid_spec(), cfg.physics(),
                                           mesh, dt=0.05, n_steps=3)
        return mesh.gather_state(step(mesh.shard_state(s0))).to_numpy()
''')

_WORKER = _RUNS + textwrap.dedent('''
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from njw_tpu_torch.parallel import ProcessMesh
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    for name, shape in RUNS:
        got = run(name, ProcessMesh(*shape, device="cpu"))
        res.update({name + "_" + k: v for k, v in got.items()})
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()
''')


def test_process_mesh_over_gloo_equals_local_mesh(tmp_path):
    """Four CPU processes over gloo run SWE with overlap on (2, 2)
    (reflective walls, the beta-plane: the non-blocking exchange) and the
    barotropic core on (4, 1) and (2, 2) (the all-to-alls along 'y', 'x'
    and ('y', 'x')); the gathered results equal the LocalMesh ones bit for
    bit. Each process has 120 s."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "gathered.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(out)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(out)
    ns: dict = {}
    exec(_RUNS, ns)
    for name, shape in ns["RUNS"]:
        want = ns["run"](name, LocalMesh(*shape, device=CPU))
        for k, v in want.items():
            np.testing.assert_array_equal(got[name + "_" + k], v)


# a ProcessMesh on a process group of 4 ranks of a world of 6; the six
# processes share one deadline (a run takes ~15 s on an idle host: the
# rest is room for a host loaded by the other test workers, where six
# processes must all start before any can join the world)
_SUB_MEMBERS = (1, 2, 4, 5)
_SUB_DEADLINE_S = 300
_SUB_RUNS = textwrap.dedent('''
    import torch

    A2A = (("y", 0, 1), ("x", 1, 0), (("y", "x"), 0, 2))

    def block(coord, n):
        g = torch.Generator().manual_seed(7 + 10 * coord[0] + coord[1])
        return torch.randn(n, n, 3, generator=g)

    def run(mesh):
        """{name: [array of each local shard]}"""
        from njw_tpu_torch.parallel import sharded_barotropic_step_2d
        from njw_tpu_torch.weather import SimConfig, Simulation

        res = {}
        for axis, split, concat in A2A:
            n = mesh.axis_size(axis)
            got = mesh.all_to_all([block(c, n) for c in mesh.coords], axis,
                                  split, concat)
            res["a2a_" + "".join(axis)] = [g.numpy() for g in got]
        cfg = SimConfig(model="barotropic", grid_width=32, grid_height=32,
                        dt=0.05, beta=1e-3, viscosity=1e-3, device="cpu")
        s0 = Simulation.from_config(cfg, "vortex", strength=3.0).state
        step = sharded_barotropic_step_2d(cfg.grid_spec(), cfg.physics(),
                                          mesh, dt=0.05, n_steps=3)
        whole = mesh.gather_state(step(mesh.shard_state(s0)))
        res["baro2d_zeta"] = [whole.zeta.numpy()] * len(mesh.coords)
        return res
''')

_SUB_WORKER = _SUB_RUNS + textwrap.dedent('''
    import datetime, faulthandler, sys
    import numpy as np, torch.distributed as dist
    # a rank still running near the test's deadline prints where it is
    faulthandler.dump_traceback_later(_SUB_DEADLINE_S - 30, exit=True)
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    members = [int(r) for r in sys.argv[4].split(",")]
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=6,
        timeout=datetime.timedelta(seconds=_SUB_DEADLINE_S - 60))
    if rank in members:
        from njw_tpu_torch.parallel import ProcessMesh
        group = dist.new_group(members, use_local_synchronization=True)
        mesh = ProcessMesh(2, 2, group=group, device="cpu")
        got = run(mesh)
        # a second mesh on the same ranks makes its own rings' groups
        again = run(ProcessMesh(2, 2, group=group, device="cpu"))
        assert all((again[k][0] == got[k][0]).all() for k in got)
        np.savez(out + f"_{mesh.rank}.npz",
                 **{k: v[0] for k, v in got.items()})
    dist.destroy_process_group()
''')


def test_process_mesh_on_a_sub_group_equals_local_mesh(tmp_path):
    """A (2, 2) ProcessMesh on a process group of 4 of a gloo world of 6
    (global ranks 1, 2, 4, 5): all_to_all along 'y', 'x' and ('y', 'x')
    and sharded_barotropic_step_2d equal LocalMesh(2, 2) bit for bit, and
    so does a second mesh on the same ranks. The two ranks outside the
    group only join the world and leave it: a ring group whose making
    needed them would hang the members until the deadline ran out. A rank
    still running 30 s before the deadline prints its stack and exits."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "shard"
    members = ",".join(str(r) for r in _SUB_MEMBERS)
    worker = f"_SUB_DEADLINE_S = {_SUB_DEADLINE_S}\n" + _SUB_WORKER
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(tmp_path / "store"),
         str(out), members], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(6)]
    deadline = time.monotonic() + _SUB_DEADLINE_S
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ns: dict = {}
    exec(_SUB_RUNS, ns)
    want = ns["run"](LocalMesh(2, 2, device=CPU))
    for r in range(4):
        got = np.load(f"{out}_{r}.npz")
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v[r])
