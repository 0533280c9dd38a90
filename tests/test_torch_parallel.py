"""The port's sharded weather paths (njw_tpu_torch.parallel) held against
the JAX package.

Inputs are made with numpy from a seed, or are the JAX package's own
initial states, carried across as numpy (njw_tpu_torch.weather.convert).
JAX runs as its own tests run it: 8 virtual CPU devices (tests/conftest.py)
and Pallas in interpret mode; the port runs on CPU tensors, where every
kernel wrapper runs its plain version. Tolerances are the JAX tests'
(tests/test_parallel_halo.py, tests/test_ops_stencil.py,
tests/test_weather_primitive.py).
"""
import os
import subprocess
import sys
import textwrap
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from njw_tpu.ops import pe_stencil as jps  # noqa: E402
from njw_tpu.ops import stencil as jst  # noqa: E402
from njw_tpu.parallel import halo as jhalo  # noqa: E402
from njw_tpu.weather import GridSpec as JGrid  # noqa: E402
from njw_tpu.weather import PhysicsParams as JParams  # noqa: E402
from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402
from njw_tpu.weather import primitive as jp  # noqa: E402

from njw_tpu_torch.ops import pe_stencil  # noqa: E402
from njw_tpu_torch.ops.pe_stencil import (  # noqa: E402
    make_pe_kernel_rk4_stepper, pe_rk4_carry, pe_rk4_carry2d, pe_rk4_local,
    pe_rk4_local2d, pe_stage_local, pe_stage_local2d,
)
from njw_tpu_torch.ops.stencil import (  # noqa: E402
    swe_rk4_step_carry, swe_rk4_step_local, swe_rk4_step_local2d,
)
from njw_tpu_torch.parallel import (  # noqa: E402
    LocalMesh, halo_pad_2d, interior_crop, make_padded_shift_fn,
    sharded_pe_step_kernel, sharded_pe_step_kernel_fused,
    sharded_pe_step_kernel_fused_2d, sharded_swe_step_kernel,
)
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation,
)
from njw_tpu_torch.weather.convert import (  # noqa: E402
    grid_from_jax_fields, params_from_jax_fields, pe_state_from_numpy,
    shards_from_numpy, shards_to_numpy,
)
from njw_tpu_torch.weather.primitive import PEState, pe_initial_state  # noqa: E402,E501

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
PE_FIELDS = ("u", "v", "T", "q", "ps")
PE_TOL = dict(rtol=1e-3, atol=5e-4)      # tests/test_parallel_halo.py:274


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
        np.testing.assert_allclose(got[name], np.asarray(
            want[name] if isinstance(want, dict) else getattr(want, name)),
            err_msg=name, **tol)


# ------------------------------------------------------------------ meshes

class TestMesh:
    def test_shard_and_gather_round_trip(self):
        mesh = LocalMesh(2, 3, device=CPU)
        rng = np.random.default_rng(0)
        s = PEState(*(torch.from_numpy(rng.random(sh, dtype=np.float32))
                      for sh in [(2, 8, 9)] * 4 + [(8, 9)]))
        shards = mesh.shard_state(s)
        assert len(shards) == 6 and shards[4].u.shape == (2, 4, 3)
        assert torch.equal(shards[4].ps, s.ps[4:8, 3:6])
        assert all(t.is_contiguous() for sh in shards for _, t in sh.items())
        back = mesh.gather_state(shards)
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(back.items(), s.items()))

    def test_grid_not_divisible_is_refused(self):
        with pytest.raises(ValueError, match="not divisible by mesh 3x2"):
            LocalMesh(3, 2, device=CPU).block_shape(32, 64)

    @pytest.mark.parametrize("axis,shift", [("y", 1), ("y", -1), ("x", 1),
                                            ("x", -2)])
    def test_ring_shift_is_ppermute(self, axis, shift):
        """Shard i receives the payload of shard i - shift (src i -> dst
        i + shift), as _ring_shift's ppermute ring."""
        mesh = LocalMesh(3, 4, device=CPU)
        got = mesh.ring_shift([(c,) for c in mesh.coords], axis, shift)
        for c, (src,) in zip(mesh.coords, got):
            assert mesh.shifted(src, axis, shift) == c

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalMesh(2, 2)


class TestHaloPad:
    @pytest.mark.parametrize("bc,sx,sy,halo", [
        ("periodic", 1.0, 1.0, 1), ("clamped", 1.0, 1.0, 2),
        ("reflective", -1.0, 1.0, 1), ("reflective", 1.0, -1.0, 2)])
    def test_matches_jax_under_shard_map(self, bc, sx, sy, halo):
        rng = np.random.default_rng(1)
        f = rng.standard_normal((2, 16, 24)).astype(np.float32)
        padded = jax.jit(jax.shard_map(
            lambda fl: jhalo.halo_pad_2d(fl, halo, bc=bc, wall_sign_x=sx,
                                         wall_sign_y=sy),
            mesh=_jmesh(2, 2), in_specs=P(None, "y", "x"),
            out_specs=P(None, "y", "x"), check_vma=False))(jnp.asarray(f))
        want = np.asarray(padded)
        mesh = LocalMesh(2, 2, device=CPU)
        shards = [s.u for s in mesh.shard_state(PEState(
            *(torch.from_numpy(f),) * 4, ps=torch.from_numpy(f[0])))]
        got = halo_pad_2d(mesh, shards, halo, bc=bc, wall_sign_x=sx,
                          wall_sign_y=sy)
        by, bx = 8 + 2 * halo, 12 + 2 * halo
        for (iy, ix), g in zip(mesh.coords, got):
            np.testing.assert_array_equal(
                g.numpy(), want[:, iy * by:(iy + 1) * by,
                                ix * bx:(ix + 1) * bx])

    def test_shift_fn_and_crop(self):
        fp = torch.arange(6 * 7, dtype=torch.float32).view(6, 7)
        shift, crop = make_padded_shift_fn(1, 4, 5), interior_crop(1, 4, 5)
        assert torch.equal(crop(fp), fp[1:5, 1:6])
        assert torch.equal(shift(fp, 1, -1), fp[0:4, 2:7])


# ------------------------------------------- padded launches against JAX's

LY, LX, L3 = 16, 128, 3
SWE_KW = dict(dt=0.01, gravity=9.81, coriolis_f=1e-4, dx=1.3, dy=0.7)
PE_KW = dict(coriolis_f=1e-4, dx=1e5, dy=1.2e5)


def _swe_block(rows, cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (rows, cols)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (rows, cols)).astype(np.float32),
            (10.0 + rng.uniform(-0.5, 0.5, (rows, cols))).astype(np.float32))


def _pe_block(rows, cols, seed):
    rng = np.random.default_rng(seed)

    def f(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return {"u": f(-10, 10, L3, rows, cols), "v": f(-10, 10, L3, rows, cols),
            "T": f(250, 300, L3, rows, cols), "q": f(0, 0.01, L3, rows, cols),
            "ps": f(990, 1020, rows, cols)}


def _t(a):
    return torch.from_numpy(np.array(a))


class TestPaddedLaunchesMatchJax:
    """Each padded launch's plain version against its JAX launcher in
    interpret mode, on one padded block (the JAX layout: 8-row slabs and
    128-lane slabs, so hy = 8, hx = 128 here), interiors only."""

    @pytest.mark.parametrize("form", ["local", "carry", "local2d"])
    def test_k1(self, form):
        cols = LX + 256 if form == "local2d" else LX
        blk = _swe_block(LY + 16, cols, 3)
        jin = [jnp.asarray(a) for a in blk]
        tin = [_t(a) for a in blk]
        if form == "local":
            want = jst.swe_rk4_step_pallas_local(*jin, ly=LY, nx=LX, by=8,
                                                 interpret=True, **SWE_KW)
            got = swe_rk4_step_local(*tin, hy=8, **SWE_KW)
        elif form == "carry":
            want = [a[8:8 + LY] for a in jst.swe_rk4_step_pallas_carry(
                *jin, ly=LY, nx=LX, by=8, interpret=True, **SWE_KW)]
            got = [a[8:8 + LY] for a in swe_rk4_step_carry(*tin, hy=8,
                                                             **SWE_KW)]
        else:
            want = jst.swe_rk4_step_pallas_local2d(*jin, ly=LY, lx=LX, by=8,
                                                   interpret=True, **SWE_KW)
            got = swe_rk4_step_local2d(*tin, hy=8, hx=128, **SWE_KW)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("form", ["local", "local2d"])
    def test_k5(self, form):
        cols = LX + 256 if form == "local2d" else LX
        cur, base = _pe_block(LY + 16, cols, 4), _pe_block(LY, LX, 5)
        jbase = jp.PEState(**{k: jnp.asarray(v) for k, v in base.items()})
        jin = [jnp.asarray(cur[k]) for k in PE_FIELDS]
        tcur, tbase = pe_state_from_numpy(cur, CPU), pe_state_from_numpy(
            base, CPU)
        if form == "local":
            want = jps.pe_stage_pallas_local(
                *jin, jbase, ly=LY, nx=LX, L=L3, c_dt=60.0, by=8,
                interpret=True, **PE_KW)
            got = pe_stage_local(tcur, tbase, hy=8, c_dt=60.0, **PE_KW)
        else:
            want = jps.pe_stage_pallas_local2d(
                *jin, jbase, ly=LY, lx=LX, L=L3, c_dt=60.0, by=8,
                interpret=True, **PE_KW)
            got = pe_stage_local2d(tcur, tbase, hy=8, hx=128, c_dt=60.0,
                                   **PE_KW)
        _close(got.to_numpy(), want, PE_FIELDS, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("form", ["local", "carry", "local2d", "carry2d"])
    def test_k4(self, form):
        two_d = form.endswith("2d")
        cols = LX + 256 if two_d else LX
        s = _pe_block(LY + 16, cols, 6)
        jin = [jnp.asarray(s[k]) for k in PE_FIELDS]
        ts = pe_state_from_numpy(s, CPU)
        kw = dict(ly=LY, L=L3, dt=60.0, by=8, interpret=True, **PE_KW)
        width = dict(lx=LX) if two_d else dict(nx=LX)
        halo = dict(hy=8, hx=128) if two_d else dict(hy=8)
        jfn = {"local": jps.pe_rk4_pallas_local,
               "carry": jps.pe_rk4_pallas_carry,
               "local2d": jps.pe_rk4_pallas_local2d,
               "carry2d": jps.pe_rk4_pallas_carry2d}[form]
        tfn = {"local": pe_rk4_local, "carry": pe_rk4_carry,
               "local2d": pe_rk4_local2d, "carry2d": pe_rk4_carry2d}[form]
        want = jfn(*jin, **kw, **width)
        got = tfn(ts, dt=60.0, **halo, **PE_KW)
        if form.startswith("carry"):   # padded results: interiors only
            cut = (slice(8, 8 + LY), slice(128, 128 + LX) if two_d
                   else slice(None))
            want = dict(zip(PE_FIELDS, (np.asarray(a)[(..., *cut)]
                                        for a in want)))
            got = pe_stencil.interior(got, (8, 128 if two_d else 0))
        _close(got.to_numpy(), want, PE_FIELDS, rtol=1e-5, atol=1e-4)


# --------------------------------------------- the slice against JAX runs

@lru_cache(maxsize=None)
def _jax_swe(nx, ny, steps):
    """The JAX whole-domain XLA run: (initial state, state after steps)."""
    sim = JSimulation.from_config(JSimConfig(
        grid_width=nx, grid_height=ny, dt=0.01, coriolis_f=1e-4,
        backend="xla"), "vortex", strength=2.0)
    s0 = {k: np.asarray(getattr(sim.state, k)) for k in ("u", "v", "h")}
    sim.step(steps)
    return s0, {k: np.asarray(getattr(sim.state, k)) for k in ("u", "v", "h")}


@lru_cache(maxsize=None)
def _jax_pe(nx, ny, L, steps):
    sim = JSimulation.from_config(JSimConfig(
        model="primitive", grid_width=nx, grid_height=ny, num_levels=L,
        dx=1e5, dy=1e5, dt=30.0, coriolis_f=1e-4, backend="xla"),
        "baroclinic", u_jet=15.0, perturb=0.5)
    s0 = {k: np.asarray(getattr(sim.state, k)) for k in PE_FIELDS}
    sim.step(steps)
    return s0, {k: np.asarray(getattr(sim.state, k)) for k in PE_FIELDS}


def _run_port(ctor, shape, s0: dict, nx, ny, L=1, dt=0.01, steps=10,
              viscosity=0.0, **kw):
    mesh = LocalMesh(*shape, device=CPU)
    grid = GridSpec(nx=nx, ny=ny, levels=L, dx=1e5 if L > 1 else 1.0,
                    dy=1e5 if L > 1 else 1.0)
    step = ctor(grid, PhysicsParams(coriolis_f=1e-4, viscosity=viscosity),
                mesh, dt=dt, n_steps=steps, **kw)
    return shards_to_numpy(step(shards_from_numpy(s0, mesh)), mesh), step


SWE_H_TOL, SWE_U_TOL = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-4)


class TestShardedSteppersMatchJax:
    def test_swe_matches_jax_sharded_stepper(self):
        """(2, 2) mesh against sharded_swe_step_pallas under shard_map
        (tests/test_parallel_halo.py:398-424)."""
        jg, jprm = JGrid(nx=256, ny=32), JParams(coriolis_f=1e-4)
        s0, _ = _jax_swe(256, 32, 10)
        jstate = jhalo.WeatherState(**{k: jnp.asarray(v)
                                       for k, v in s0.items()})
        jm = _jmesh(2, 2)
        want = jhalo.sharded_swe_step_pallas(
            jg, jprm, jm, dt=0.01, n_steps=10, interpret=True)(
            jhalo.sharded_state(jstate, jm))
        mesh = LocalMesh(2, 2, device=CPU)
        step = sharded_swe_step_kernel(
            grid_from_jax_fields(jg), params_from_jax_fields(jprm), mesh,
            dt=0.01, n_steps=10)
        got = shards_to_numpy(step(shards_from_numpy(jstate, mesh)), mesh)
        _close(got, want, ("h",), **SWE_H_TOL)
        _close(got, want, ("u", "v"), **SWE_U_TOL)

    def test_pe_fused_matches_jax_sharded_stepper(self):
        """(4,) mesh against sharded_pe_step_pallas_fused
        (tests/test_parallel_halo.py:279-305)."""
        jg = JGrid(nx=128, ny=32, levels=4, dx=1e5, dy=1e5)
        jprm = JParams(coriolis_f=1e-4)
        s0 = jp.pe_initial_state(jg, u_jet=15.0, perturb=0.5)
        jm = Mesh(np.array(jax.devices()[:4]), ("y",))
        want = jhalo.sharded_pe_step_pallas_fused(
            jg, jprm, jm, dt=30.0, n_steps=10, interpret=True)(
            jhalo.sharded_state(s0, jm))
        mesh = LocalMesh(4, 1, device=CPU)
        step = sharded_pe_step_kernel_fused(
            grid_from_jax_fields(jg), params_from_jax_fields(jprm), mesh,
            dt=30.0, n_steps=10)
        assert step.name == "pe_rk4_carry"
        got = shards_to_numpy(step(shards_from_numpy(s0, mesh)), mesh)
        _close(got, want, PE_FIELDS, **PE_TOL)


class TestShardedSteppersMatchWholeDomain:
    """Every other stepper and mesh shape against the JAX whole-domain XLA
    Simulation, as the JAX tests do."""

    @pytest.mark.parametrize("shape,nx,ny,name", [
        ((4, 1), 128, 64, "swe_rk4_carry"), ((2, 4), 512, 32,
                                             "swe_rk4_local2d"),
        ((2, 2), 256, 32, "swe_rk4_local2d")])
    def test_swe(self, shape, nx, ny, name):
        s0, want = _jax_swe(nx, ny, 10)
        got, step = _run_port(sharded_swe_step_kernel, shape, s0, nx, ny)
        assert step.name == name
        _close(got, want, ("h",), **SWE_H_TOL)
        _close(got, want, ("u", "v"), **SWE_U_TOL)

    @pytest.mark.parametrize("ctor,shape,nx,ny,L,steps,name", [
        (sharded_pe_step_kernel, (4, 1), 128, 32, 4, 10, "pe_stage_local"),
        (sharded_pe_step_kernel, (2, 2), 256, 32, 3, 5, "pe_stage_local2d"),
        (sharded_pe_step_kernel_fused, (2, 2), 256, 32, 3, 10,
         "pe_rk4_local2d"),
        (sharded_pe_step_kernel_fused, (1, 2), 256, 16, 3, 10,
         "pe_rk4_local2d"),
    ])
    def test_pe(self, ctor, shape, nx, ny, L, steps, name):
        s0, want = _jax_pe(nx, ny, L, steps)
        got, step = _run_port(ctor, shape, s0, nx, ny, L, 30.0, steps)
        assert step.name == name
        _close(got, want, PE_FIELDS, **PE_TOL)

    def test_pe_carry_form_matches_concat_form(self):
        """(tests/test_parallel_halo.py:340-361)"""
        s0, _ = _jax_pe(256, 32, 3, 6)
        runs = [_run_port(sharded_pe_step_kernel_fused_2d, (2, 2), s0, 256,
                          32, 3, 30.0, 6, carry=carry) for carry in (True,
                                                                     False)]
        assert [r[1].name for r in runs] == ["pe_rk4_carry2d",
                                             "pe_rk4_local2d"]
        _close(runs[0][0], runs[1][0], PE_FIELDS, rtol=1e-4, atol=1e-5)

    def test_pe_fused_falls_back_to_the_stage_path(self, monkeypatch):
        """Where the whole-step kernel does not fit, the fused 2-D form
        takes the stage path and still matches (test_parallel_halo.py:
        363-394)."""
        monkeypatch.setattr(pe_stencil, "pe_rk4_kernel_fits",
                            lambda levels: False)
        s0, want = _jax_pe(256, 32, 3, 6)
        got, step = _run_port(sharded_pe_step_kernel_fused, (2, 2), s0, 256,
                              32, 3, 30.0, 6)
        assert step.name == "pe_stage_local2d"
        _close(got, want, PE_FIELDS, **PE_TOL)

    def test_reference_fault_sharded_swe_kernel_drops_viscosity(self):
        """The JAX kernel-backed sharded SWE stepper ignores the viscosity
        (its result is the inviscid one) and so misses the whole-domain run
        by far more than its tests' tolerance; the port applies it and
        matches (ROADMAP section 3)."""
        nu, steps = 0.05, 5
        jsim = JSimulation.from_config(JSimConfig(
            grid_width=128, grid_height=32, dt=0.01, coriolis_f=1e-4,
            viscosity=nu, backend="xla"), "vortex", strength=2.0)
        s0 = {k: np.asarray(getattr(jsim.state, k)) for k in ("u", "v", "h")}
        jstate = jhalo.WeatherState(**{k: jnp.asarray(v)
                                       for k, v in s0.items()})
        jg = JGrid(nx=128, ny=32)
        jm = Mesh(np.array(jax.devices()[:4]), ("y",))
        jax_sharded = {
            v: jhalo.sharded_swe_step_pallas(
                jg, JParams(coriolis_f=1e-4, viscosity=v), jm, dt=0.01,
                n_steps=steps, interpret=True)(jhalo.sharded_state(jstate,
                                                                   jm))
            for v in (0.0, nu)}
        jsim.step(steps)
        want = {k: np.asarray(getattr(jsim.state, k)) for k in ("u", "v", "h")}
        np.testing.assert_array_equal(np.asarray(jax_sharded[nu].u),
                                      np.asarray(jax_sharded[0.0].u))
        assert np.abs(np.asarray(jax_sharded[nu].u) - want["u"]).max() > 1e-3
        got, _ = _run_port(sharded_swe_step_kernel, (4, 1), s0, 128, 32,
                           steps=steps, viscosity=nu)
        _close(got, want, ("h",), **SWE_H_TOL)
        _close(got, want, ("u", "v"), **SWE_U_TOL)

    @pytest.mark.parametrize("bc,params", [
        ("clamped", {}), ("periodic", {"beta": 0.1})])
    def test_kernel_rules_refuse(self, bc, params):
        grid = GridSpec(nx=32, ny=32, bc=bc)
        with pytest.raises(NotImplementedError):
            sharded_swe_step_kernel(grid, PhysicsParams(**params),
                                    LocalMesh(2, 2, device=CPU), dt=0.01)

    def test_shard_smaller_than_halo_is_refused(self):
        with pytest.raises(ValueError, match="halo of 4"):
            sharded_swe_step_kernel(GridSpec(nx=32, ny=12), PhysicsParams(),
                                    LocalMesh(4, 1, device=CPU), dt=0.01)


class TestShapesJaxCannotTake:
    """Shards that are no multiple of (8, 128) (the TPU's tile rule, which
    the port drops), against the port's own whole-domain stepper."""

    def test_swe_60x36_on_3x2(self):
        cfg = SimConfig(grid_width=60, grid_height=36, dt=0.01,
                        coriolis_f=1e-4, viscosity=0.01, device=CPU,
                        backend="kernel")
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        s0 = sim.state.to_numpy()
        mesh = LocalMesh(3, 2, device=CPU)
        step = sharded_swe_step_kernel(cfg.grid_spec(), cfg.physics(), mesh,
                                       dt=0.01, n_steps=5)
        got = shards_to_numpy(step(step(shards_from_numpy(s0, mesh))), mesh)
        sim.step(10)
        _close(got, sim.state.to_numpy(), ("u", "v", "h"), rtol=1e-6,
               atol=1e-7)

    @pytest.mark.parametrize("ctor,kw", [
        (sharded_pe_step_kernel_fused, {}),
        (sharded_pe_step_kernel_fused_2d, {"carry": True}),
        (sharded_pe_step_kernel, {})])
    def test_pe_40x24x3_on_2x2(self, ctor, kw):
        grid = GridSpec(nx=40, ny=24, levels=3, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s0 = pe_initial_state(grid, device="cpu", u_jet=15.0, perturb=0.5)
        mesh = LocalMesh(2, 2, device=CPU)
        step = ctor(grid, params, mesh, dt=30.0, n_steps=3, **kw)
        got = shards_to_numpy(step(step(mesh.shard_state(s0))), mesh)
        ref = make_pe_kernel_rk4_stepper(
            grid, params, 30.0, whole_step=ctor is not sharded_pe_step_kernel)
        s = s0.map(torch.clone)
        carry = ref.init(s)
        for _ in range(6):
            carry, s = ref.step(carry, s, None)
        _close(got, s.to_numpy(), PE_FIELDS, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- ProcessMesh over gloo

# the runs, defined once for the gloo workers and for this process
_RUNS = textwrap.dedent('''
    from njw_tpu_torch.parallel import (
        sharded_pe_step_kernel_fused, sharded_swe_step_kernel)
    from njw_tpu_torch.weather import (
        GridSpec, PhysicsParams, SimConfig, Simulation)
    from njw_tpu_torch.weather.primitive import pe_initial_state

    RUNS = (("swe", (4, 1)), ("pe", (2, 2)))

    def run(name, mesh):
        if name == "swe":
            cfg = SimConfig(grid_width=64, grid_height=32, dt=0.01,
                            coriolis_f=1e-4, device="cpu")
            s0 = Simulation.from_config(cfg, "vortex", strength=2.0).state
            step = sharded_swe_step_kernel(cfg.grid_spec(), cfg.physics(),
                                           mesh, dt=0.01, n_steps=5)
        else:
            grid = GridSpec(nx=64, ny=32, levels=3, dx=1e5, dy=1e5)
            s0 = pe_initial_state(grid, device="cpu", u_jet=15.0, perturb=0.5)
            step = sharded_pe_step_kernel_fused(
                grid, PhysicsParams(coriolis_f=1e-4), mesh, dt=30.0,
                n_steps=5)
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
    """Four CPU processes over gloo run SWE 1-D (4, 1) and PE fused 2-D
    (2, 2) for 5 steps; the gathered results equal the LocalMesh ones bit
    for bit (the same plain operations in the same order). Each process
    has 120 s."""
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
