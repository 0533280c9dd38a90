"""The port's fused RK4 step (njw_tpu_torch.ops.stencil) against the JAX
package's Pallas kernel (interpret mode on the CPU) and the plain RK4
integrator. The CUDA kernel itself runs only on a GPU: its tests are in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops.stencil import swe_rk4_step_pallas  # noqa: E402
from njw_tpu.weather import GridSpec as JGrid  # noqa: E402

from njw_tpu_torch.ops import _build, stencil  # noqa: E402
from njw_tpu_torch.ops.stencil import (  # noqa: E402
    MAX_THREADS, SMEM_PER_BLOCK, SweLayout, kernel_supported,
    make_kernel_rk4_stepper, rk4_constants, swe_layout, swe_rk4_step,
    swe_rk4_step_cuda, swe_rk4_step_plain,
)
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, make_stepper,
    make_tendency_fn,
)
from njw_tpu_torch.weather.convert import (  # noqa: E402
    grid_from_jax_fields, state_from_numpy,
)

CPU = "cpu"


def _fields(ny, nx, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            (10.0 + rng.uniform(-amp, amp, (ny, nx))).astype(np.float32))


def _torch(fields, device=CPU):
    return tuple(torch.from_numpy(f.copy()).to(device) for f in fields)


class TestPlainVersionAgainstPallas:
    @pytest.mark.parametrize("nu", [0.0, 0.02])
    def test_matches_pallas_interpret(self, nu):
        """The JAX kernel's own tolerance (tests/test_ops_stencil.py)."""
        jg = JGrid(nx=128, ny=64)
        f = _fields(64, 128, seed=1)
        kw = dict(dt=0.01, gravity=9.81, coriolis_f=1e-4, viscosity=nu)
        ref = swe_rk4_step_pallas(*(jnp.asarray(a) for a in f), grid=jg,
                                  by=16, interpret=True, **kw)
        out = swe_rk4_step_plain(*_torch(f), grid=grid_from_jax_fields(jg),
                                 **kw)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


class TestPlainVersionAgainstIntegrator:
    @pytest.mark.parametrize("ny,nx,nu", [
        (64, 64, 0.0), (37, 29, 0.0), (3, 5, 0.0), (20, 33, 0.05)])
    def test_accumulator_form_equals_k_sum_rk4(self, ny, nx, nu):
        """State-form RK4 == the integrator's k-sum RK4 to rounding, on
        ragged and tiny periodic grids too."""
        grid = GridSpec(nx=nx, ny=ny, dx=1.25, dy=0.8)
        params = PhysicsParams(coriolis_f=1e-3, viscosity=nu)
        f = _fields(ny, nx, seed=ny)
        dt = 0.01
        out = swe_rk4_step_plain(*_torch(f), grid=grid, dt=dt,
                                 coriolis_f=1e-3, viscosity=nu)
        st = make_stepper("rk4", make_tendency_fn("shallow_water", grid,
                                                  params))
        _, ref = st.step((), state_from_numpy(dict(zip("uvh", f)), CPU),
                         float(np.float32(dt)))
        for a, b in zip(out, (ref.u, ref.v, ref.h)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version(self):
        grid = GridSpec(nx=16, ny=12)
        f = _torch(_fields(12, 16))
        before = swe_rk4_step_cuda.launches
        out = tuple(torch.empty_like(t) for t in f)
        res = swe_rk4_step(*f, grid=grid, dt=0.01, coriolis_f=1e-4, out=out)
        assert all(r is o for r, o in zip(res, out))
        ref = swe_rk4_step_plain(*f, grid=grid, dt=0.01, coriolis_f=1e-4)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert swe_rk4_step_cuda.launches == before  # no kernel launch

    def test_cuda_wrapper_refuses_cpu_tensors(self, monkeypatch):
        """No fallback: the CUDA wrapper raises before it builds anything."""
        def no_build(name):
            raise AssertionError("the kernel must not be built for CPU input")

        monkeypatch.setattr(_build, "load", no_build)
        f = _torch(_fields(8, 8))
        before = swe_rk4_step_cuda.launches
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swe_rk4_step_cuda(*f, grid=GridSpec(nx=8, ny=8), dt=0.01)
        assert swe_rk4_step_cuda.launches == before

    @pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "alias",
                                     "bc", "out_shared"])
    def test_checks_refuse_bad_input(self, bad):
        grid = GridSpec(nx=8, ny=6)
        u, v, h = _torch(_fields(6, 8))
        out = None
        if bad == "dtype":
            u = u.double()
        elif bad == "shape":
            grid = GridSpec(nx=6, ny=8)
        elif bad == "contiguous":
            u = torch.zeros(8, 6).t()
        elif bad == "alias":
            out = (u, torch.empty_like(v), torch.empty_like(h))
        elif bad == "bc":
            grid = GridSpec(nx=8, ny=6, bc="clamped")
        elif bad == "out_shared":
            o = torch.empty_like(u)
            out = (o, o, torch.empty_like(h))
        with pytest.raises((TypeError, ValueError)):
            swe_rk4_step(u, v, h, grid=grid, dt=0.01, out=out)

    def test_stepper_ping_pongs_two_buffers(self):
        grid = GridSpec(nx=16, ny=16)
        st = make_kernel_rk4_stepper(grid, PhysicsParams(coriolis_f=1e-4), 0.01)
        s = state_from_numpy(dict(zip("uvh", _fields(16, 16))), CPU)
        carry = st.init(s)
        ptrs = []
        for _ in range(4):
            carry, s = st.step(carry, s, 0.01)
            ptrs.append(s.h.data_ptr())
        assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] != ptrs[0]
        assert st.name == "rk4_kernel"

    def test_constants_rounded_to_float32_once(self):
        k = stencil.rk4_constants(GridSpec(dx=3.0, dy=7.0), 0.001, 9.81,
                                  1e-4, 0.02)
        assert k["sixth"] == float(np.float32(0.001 / 6.0))
        assert k["cx"] == float(np.float32(0.5 / 3.0))
        assert k["iy2"] == float(np.float32(0.02 / 49.0))


class TestBoundLaunch:
    """A stepper's bound launch (``stencil.BoundLaunch``) with a stub entry
    on CPU tensors: its operand checks, its counters and its errors."""

    @staticmethod
    def _bound(grid, calls=None, err=0):
        k = rk4_constants(grid, 0.01, 9.81, 1e-4, 0.0)

        def entry(*args):
            if calls is not None:
                calls.append(args)
            return err

        return stencil.BoundLaunch(grid, k, entry=entry, stream=lambda i: 0)

    @staticmethod
    def _counts():
        return (swe_rk4_step_cuda.bound_launches,
                swe_rk4_step_cuda.operand_checks, swe_rk4_step_cuda.launches)

    def test_counters_exist_and_start_at_zero(self):
        import subprocess
        import sys
        code = ("from njw_tpu_torch.ops.stencil import swe_rk4_step_cuda as s;"
                "print(s.bound_launches, s.operand_checks, s.launches)")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout.split()
        assert out == ["0", "0", "0"]

    def test_checks_once_per_operand_set_over_100_steps(self):
        grid = GridSpec(nx=16, ny=12)
        a = _torch(_fields(12, 16))
        b = tuple(torch.empty_like(t) for t in a)
        calls = []
        bound = self._bound(grid, calls)
        before = self._counts()
        src, dst = a, b
        for _ in range(100):
            assert bound(*src, dst) is dst
            src, dst = dst, src
        # two operand sets: (a -> b) and (b -> a); every step launched once
        assert self._counts() == (before[0] + 100, before[1] + 2,
                                  before[2] + 100)
        assert len(calls) == 100
        ptrs = lambda x, y: tuple(t.data_ptr() for t in x + y)  # noqa: E731
        assert calls[0] == (*ptrs(a, b), 0) and calls[1] == (*ptrs(b, a), 0)
        assert set(calls) == {calls[0], calls[1]}

    @pytest.mark.parametrize("change", ["data_ptr", "shape", "dtype",
                                        "stride"])
    def test_checks_again_when_an_operand_changes(self, monkeypatch, change):
        grid = GridSpec(nx=12, ny=12)
        u, v, h = _torch(_fields(12, 12))
        out = tuple(torch.empty_like(t) for t in (u, v, h))
        seen = []
        real = stencil._check
        monkeypatch.setattr(stencil, "_check",
                            lambda *a: (seen.append(a), real(*a)))
        bound = self._bound(grid)
        bound(u, v, h, out)
        bound(u, v, h, out)
        assert len(seen) == 1
        if change == "data_ptr":          # new buffers, checked and taken
            u = u.clone()
            bound(u, v, h, out)
        else:
            u0, u = u, {"shape": lambda t: t.view(6, 24),
                        "dtype": lambda t: t.view(torch.int32),
                        "stride": lambda t: t.t()}[change](u)
            assert u.data_ptr() == u0.data_ptr()   # only `change` differs
            with pytest.raises((TypeError, ValueError)):
                bound(u, v, h, out)
        assert len(seen) == 2

    @pytest.mark.parametrize("bad", ["dtype", "alias", "out_shared",
                                     "contiguous"])
    def test_raises_the_checks_errors(self, bad):
        """A state put in from outside is refused as swe_rk4_step refuses
        it, with the same error."""
        grid = GridSpec(nx=8, ny=8)
        u, v, h = _torch(_fields(8, 8))
        out = tuple(torch.empty_like(t) for t in (u, v, h))
        if bad == "dtype":
            u = u.double()
        elif bad == "alias":
            out = (u, out[1], out[2])
        elif bad == "out_shared":
            out = (out[0], out[0], out[2])
        elif bad == "contiguous":
            u = torch.zeros(8, 8).t()
        with pytest.raises((TypeError, ValueError)) as want:
            swe_rk4_step(u, v, h, grid=grid, dt=0.01, coriolis_f=1e-4,
                         out=out)
        before = self._counts()
        with pytest.raises(want.type, match=str(want.value)):
            self._bound(grid)(u, v, h, out)
        assert self._counts()[0] == before[0]   # nothing launched

    def test_raises_on_a_launch_error(self, monkeypatch):
        monkeypatch.setattr(_build, "bind",
                            lambda *a: (None, lambda e: b"invalid argument"))
        grid = GridSpec(nx=8, ny=8)
        f = _torch(_fields(8, 8))
        bound = self._bound(grid, err=1)
        before = self._counts()
        with pytest.raises(RuntimeError, match="invalid argument"):
            bound(*f, tuple(torch.empty_like(t) for t in f))
        assert self._counts()[0] == before[0]

    def test_keeps_a_bounded_number_of_operand_sets(self):
        grid = GridSpec(nx=8, ny=8)
        f = _torch(_fields(8, 8))
        bound = self._bound(grid)
        for _ in range(3 * bound.MAX_OPERAND_SETS):
            bound(*f, tuple(torch.empty_like(t) for t in f))
        assert len(bound._checked) <= bound.MAX_OPERAND_SETS

    @pytest.mark.parametrize("k_extra,counter", [
        ({}, "launches"), ({"bf16": True}, "bf16_launches"),
        ({"fused": 2}, "multistep")])
    def test_counts_each_form_on_its_counter(self, k_extra, counter):
        grid = GridSpec(nx=8, ny=8)
        k = dict(rk4_constants(grid, 0.01, 9.81, 0.0, 0.0,
                               bf16=bool(k_extra.get("bf16"))), **k_extra)
        bound = stencil.BoundLaunch(grid, k, entry=lambda *a: 0,
                                    stream=lambda i: 0)

        def count():
            if counter == "multistep":
                return stencil.swe_rk4_multistep_cuda.launches
            return getattr(swe_rk4_step_cuda, counter)

        before = count()
        f = _torch(_fields(8, 8))
        bound(*f, tuple(torch.empty_like(t) for t in f))
        assert count() == before + 1


class TestEligibility:
    @pytest.mark.parametrize("grid_kw,params_kw,model,method,ok", [
        ({}, {}, "shallow_water", "rk4", True),
        ({"nx": 200, "ny": 37}, {"viscosity": 0.1}, "shallow_water", "rk4",
         True),  # no tile-multiple rule: the kernel masks ragged tiles
        ({}, {"beta": 0.1}, "shallow_water", "rk4", False),
        ({"bc": "clamped"}, {}, "shallow_water", "rk4", False),
        ({"grid_type": "staggered"}, {}, "shallow_water", "rk4", False),
        ({}, {}, "shallow_water", "rk2", False),
        ({}, {}, "general", "rk4", False),
    ])
    def test_kernel_supported(self, grid_kw, params_kw, model, method, ok):
        grid = GridSpec(**grid_kw)
        assert kernel_supported(grid, PhysicsParams(**params_kw), model,
                                method) is ok

    def test_kernel_backend_on_cpu_uses_the_plain_version(self):
        cfg = SimConfig(grid_width=24, grid_height=24, backend="kernel",
                        device=CPU)
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        assert sim.stepper.name == "rk4_kernel"
        sim.step(3)
        assert torch.isfinite(sim.state.h).all()


class TestBuild:
    def test_sources_and_hashed_library_names(self):
        assert "swe_rk4" in _build.sources()
        path = _build.library_path("swe_rk4")
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libswe_rk4-") and path.suffix == ".so"
        assert "--use_fast_math" not in _build.NVCC_FLAGS
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build, "Path", _NoCudaPath)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc_path()

    def test_source_note_names_the_tpu_kernel_and_bound(self):
        src = (_build.CSRC / "swe_rk4.cu").read_text()
        assert "njw_tpu/ops/stencil.py:60" in src and "swe_rk4_kernel" in src
        assert "24 B/point" in src
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
        assert "cudaGetLastError" in src
        # the design the note states: a band of rows a warp and columns a
        # lane in registers, x-neighbours by shuffles, only band edges
        # through shared memory, the region streamed in with cp.async on a
        # persistent grid, one layout a form, mirrored by the wrapper's rule
        for word in ("registers", "6/C shuffles and 12/(R C) shared",
                     "__shfl_up_sync", "cp.async.cg", "persistent",
                     "stencil.swe_layout"):
            assert word in src, word
        for name, n_steps in (("Step1", 1), ("Step2", 2)):
            lay = swe_layout(n_steps)
            assert (f"using {name} = Layout<{lay.tx}, {lay.ty}, {lay.rows}, "
                    f"{lay.cols}, {lay.blocks}>;") in src
        assert src.count("using Step") == 2   # no layout but the rule's


class TestLayoutRule:
    """The block layout of each form of csrc/swe_rk4.cu, the rule the
    launch takes (the card tests hold the numbers to the built kernel's)."""

    @pytest.fixture(autouse=True)
    def _fresh_rule(self):
        swe_layout.cache_clear()
        yield
        swe_layout.cache_clear()

    @pytest.mark.parametrize("n_steps,bf16,want,region,threads,smem", [
        (1, False, (56, 56, 4, 2, 1), (64, 64), 512, 147456),
        (1, True, (56, 56, 4, 2, 1), (64, 64), 512, 147456),
        (2, False, (48, 48, 4, 2, 1), (64, 64), 512, 147456),
    ])
    def test_rule_tile_threads_and_shared_bytes(self, n_steps, bf16, want,
                                                region, threads, smem):
        lay = swe_layout(n_steps, bf16)
        assert lay == SweLayout(*want)
        assert lay.region(n_steps) == region
        assert lay.threads(n_steps) == threads
        # two (u, v, h) float32 region buffers, s now and s next, and the
        # first and last rows of each of the 16 bands for two parities
        assert lay.smem_bytes(n_steps) == smem == 4 * 3 * (
            2 * region[0] * region[1] + 4 * 16 * region[1])

    @pytest.mark.parametrize("n_steps,bf16", [(1, False), (1, True),
                                              (2, False)])
    def test_rule_fits_a_block(self, n_steps, bf16):
        lay = swe_layout(n_steps, bf16)
        py, px = lay.region(n_steps)
        assert px == 32 * lay.cols and py % lay.rows == 0 and lay.tx % 4 == 0
        assert lay.threads(n_steps) <= MAX_THREADS
        assert lay.threads(n_steps) % 32 == 0
        assert lay.smem_bytes(n_steps) <= SMEM_PER_BLOCK
        # one block an SM by registers, not by shared memory: the 64K
        # registers of an SM over the block's threads allow 128 a thread
        assert 2 * lay.smem_bytes(n_steps) > SMEM_PER_BLOCK
        assert 65536 // lay.threads(n_steps) >= 128

    @pytest.mark.parametrize("n_steps", [0, 3])
    def test_refuses_steps_it_has_no_layout_for(self, n_steps):
        with pytest.raises(ValueError, match="n_steps must be 1 or 2"):
            swe_layout(n_steps)

    @pytest.mark.parametrize("n_steps,layout,match", [
        (1, (120, 120, 32, 4, 1), "shared memory"),
        (1, (56, 120, 2, 2, 1), "threads"),
        (1, (54, 24, 4, 2, 1), "does not tile"),
        (1, (56, 24, 5, 2, 1), "does not tile"),
        (2, (56, 56, 8, 2, 1), "does not tile"),    # a 72-column region
        (2, (112, 48, 8, 4, 1), "shared memory"),
    ])
    def test_launch_refuses_a_layout_that_does_not_fit(
            self, monkeypatch, n_steps, layout, match):
        """No fallback: a rule whose layout does not fit is refused by the
        launch before anything is built or launched, whatever device the
        tensors are on."""
        def no_build(*args):
            raise AssertionError("nothing may be built for a bad layout")

        monkeypatch.setattr(_build, "bind", no_build)
        monkeypatch.setitem(stencil._RULE, n_steps, SweLayout(*layout))
        f = _torch(_fields(8, 8))
        k = rk4_constants(GridSpec(nx=8, ny=8), 0.01, 9.81, 0.0, 0.0)
        if n_steps == 2:
            k["fused"] = 2
        before = (swe_rk4_step_cuda.launches,
                  stencil.swe_rk4_multistep_cuda.launches)
        with pytest.raises(ValueError, match=match):
            stencil._launch(f, tuple(torch.empty_like(t) for t in f),
                            (0, 0), k)
        assert (swe_rk4_step_cuda.launches,
                stencil.swe_rk4_multistep_cuda.launches) == before

    def test_every_form_takes_its_steps_rule(self):
        """The bf16 tendency and the padded forms take K1's layout (the
        source instantiates Step1 for them)."""
        assert swe_layout(1, bf16=True) is swe_layout(1)
        assert swe_layout(2) != swe_layout(1)


class _NoCudaPath(type(_build.CSRC)):
    def exists(self):
        return False
