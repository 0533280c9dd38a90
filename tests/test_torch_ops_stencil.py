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

from njw_tpu_torch.ops import _bound, _build, pe_stencil, stencil  # noqa: E402
from njw_tpu_torch.parallel import LocalMesh, halo  # noqa: E402
from njw_tpu_torch.weather import primitive as tp  # noqa: E402
from njw_tpu_torch.weather.grid import WeatherState  # noqa: E402
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


class _SweLib:
    """Stands in for the built swe_rk4 library: records each prepared
    launch's field pointers and stream, and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.prepared, self.calls = err, 0, []
        for name in ("swe_rk4_prepared_bytes", "swe_rk4_prepare",
                     "swe_rk4_launch_prepared", "swe_rk4_error_string"):
            setattr(self, name, _Entry(getattr(self, name)))

    def swe_rk4_prepared_bytes(self):
        return 8

    def swe_rk4_prepare(self, *args):
        self.prepared += 1
        return 0

    def swe_rk4_launch_prepared(self, prepared, *ptrs_and_stream):
        self.calls.append(ptrs_and_stream)
        return self.err

    def swe_rk4_error_string(self, err):
        return b"invalid argument"


def _swe_kernel_path(monkeypatch, err=0) -> _SweLib:
    """The SWE stepper's kernel path on CPU tensors: the library, the
    device and the stream replaced by stand-ins (nothing is built)."""
    lib = _SweLib(err)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(stencil, "device_kind", lambda t, name: "cuda")
    monkeypatch.setattr(_bound, "launch_on", lambda index, entry: entry(0))
    return lib


class _Entry:
    """A stand-in C entry: takes ``argtypes`` and ``restype`` as ctypes'
    functions do."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def _pe_fields(seed=0):
    return tp.pe_initial_state(GridSpec(nx=12, ny=10, levels=3, dx=1e5,
                                        dy=1e5), device=CPU, u_jet=8.0,
                               perturb=0.5, seed=seed)


class _Form:
    """A kernel stepper under the rule (``ops/_bound.py``) on CPU tensors,
    driven as ``Simulation`` drives it: ``run(state) -> state`` keeps the
    carry. ``check``: the module and name of the wrapper's check it
    calls; ``per_state``: the checks it makes for a state it adopts (one
    per launch it binds, or per call of a sharded stepper)."""

    def __init__(self, name):
        self.name = name
        if name == "swe":
            self.check, self.per_state = (stencil, "_check"), 2
            self.st = make_kernel_rk4_stepper(
                GridSpec(nx=16, ny=12), PhysicsParams(coriolis_f=1e-4), 0.01)
        elif name == "pe_stage":
            self.check, self.per_state = (pe_stencil, "_check"), 8
            self.st = pe_stencil.make_pe_kernel_rk4_stepper(
                GridSpec(nx=12, ny=10, levels=3, dx=1e5, dy=1e5),
                PhysicsParams(coriolis_f=1e-4), 30.0)
        else:
            self.check, self.per_state = (halo, "_check_shards"), 1
            self.mesh = LocalMesh(2, 1, device=CPU)
            self.st = halo.sharded_swe_step_kernel(
                GridSpec(nx=12, ny=16), PhysicsParams(coriolis_f=1e-4),
                self.mesh, dt=0.01)
        self.carry = None

    def state(self, seed=0):
        if self.name == "pe_stage":
            return _pe_fields(seed)
        ny, nx = (12, 16) if self.name == "swe" else (16, 12)
        s = state_from_numpy(dict(zip("uvh", _fields(ny, nx, seed))), CPU)
        return s if self.name == "swe" else self.mesh.shard_state(s)

    def run(self, s):
        if self.name == "sharded_swe":
            return self.st.advance(s)
        if self.carry is None:
            self.carry = self.st.init(s)
        self.carry, s = self.st.step(self.carry, s, None)
        return s

    @staticmethod
    def changed(s, change):
        """``s`` from outside: new buffers, with one field's view changed
        in shape, dtype or strides unless ``change`` is "data_ptr"."""
        if isinstance(s, list):       # the shards: change the first
            return [_Form.changed(s[0], change)] + [
                x.map(torch.clone) for x in s[1:]]
        fresh = s.map(torch.clone)
        if change == "data_ptr":
            return fresh
        name, t = next(fresh.items())
        return fresh.replace(**{name: {
            "shape": lambda: t.reshape(t.shape[:-2] + (-1, 2 * t.shape[-1])),
            "dtype": lambda: t.view(torch.int32),
            "stride": lambda: t.transpose(-1, -2).contiguous()
            .transpose(-1, -2)}[change]()})


FORMS = ("swe", "pe_stage", "sharded_swe")


def _counting(monkeypatch, form: _Form) -> list:
    module, name = form.check
    seen, real = [], getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: (seen.append(a), real(*a, **k))[1])
    return seen


class TestBoundLaunch:
    """The rule of every kernel stepper (``ops/_bound.py``) on CPU
    tensors: SWE's stepper on its kernel path (the library, device and
    stream replaced by stand-ins), the PE stage stepper and a sharded SWE
    form on their plain paths: its checks, its bindings, its counters and
    its errors."""

    def test_counters_exist_and_start_at_zero(self):
        import subprocess
        import sys
        code = ("from njw_tpu_torch.ops.stencil import swe_rk4_step_cuda as s,"
                " swe_rk4_multistep_cuda as m;"
                "print(s.launches, s.bf16_launches, m.launches)")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout.split()
        assert out == ["0", "0", "0"]

    @pytest.mark.parametrize("name", FORMS)
    def test_checks_once_per_operand_set_over_100_steps(self, monkeypatch,
                                                        name):
        """A state from outside is checked once, each launch the step
        repeats bound once; the stepper's own buffers are never checked
        again, and the steps equal the public wrapper's."""
        form = _Form(name)
        lib = _swe_kernel_path(monkeypatch) if name == "swe" else None
        seen = _counting(monkeypatch, form)
        s0 = form.state()
        before = swe_rk4_step_cuda.launches
        s = s0
        for _ in range(100):
            s = form.run(s)
        assert len(seen) == form.per_state
        if lib is not None:     # every step launched once, two pointer sets
            assert swe_rk4_step_cuda.launches == before + 100
            assert lib.prepared == 2 and len(lib.calls) == 100
            assert len(set(lib.calls)) == 2 and lib.calls[0] != lib.calls[1]
            assert lib.calls[0] == lib.calls[2] and lib.calls[0][-1] == 0
            return
        ref = _Form(name)
        r = form.state()
        for _ in range(100):
            r = ref.run(form.changed(r, "data_ptr"))   # checked every step
        for a, b in zip(s if isinstance(s, list) else [s],
                        r if isinstance(r, list) else [r]):
            for (n, x), (_, y) in zip(a.items(), b.items()):
                assert torch.equal(x, y), n

    @pytest.mark.parametrize("name", FORMS)
    @pytest.mark.parametrize("change", ["data_ptr", "shape", "dtype",
                                        "stride"])
    def test_checks_again_when_an_operand_changes(self, monkeypatch, change,
                                                  name):
        """A state put in from outside is checked again: new buffers are
        adopted, a field of another shape, dtype or strides is refused
        (a sharded stepper copies the state into its blocks, so strides
        are no concern of its)."""
        form = _Form(name)
        if name == "swe":
            _swe_kernel_path(monkeypatch)
        s = form.run(form.run(form.state()))
        seen = _counting(monkeypatch, form)
        s = form.run(s)
        assert seen == []
        bad = form.changed(s, change)
        if change == "data_ptr" or (change == "stride"
                                    and name == "sharded_swe"):
            form.run(bad)
            assert len(seen) == form.per_state
        else:
            with pytest.raises((TypeError, ValueError)):
                form.run(bad)
            assert len(seen) >= 1

    @pytest.mark.parametrize("bad", ["dtype", "alias", "out_shared",
                                     "contiguous"])
    def test_raises_the_checks_errors(self, monkeypatch, bad):
        """A state put in from outside is refused as swe_rk4_step refuses
        it, with the same error, and nothing is launched."""
        grid = GridSpec(nx=8, ny=8)
        st = make_kernel_rk4_stepper(grid, PhysicsParams(coriolis_f=1e-4),
                                     0.01)
        lib = _swe_kernel_path(monkeypatch)
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
        before = swe_rk4_step_cuda.launches
        with pytest.raises(want.type, match=str(want.value)):
            st.step(WeatherState(*out), WeatherState(u, v, h), 0.01)
        assert swe_rk4_step_cuda.launches == before and lib.calls == []

    def test_raises_on_a_launch_error(self, monkeypatch):
        st = make_kernel_rk4_stepper(GridSpec(nx=8, ny=8),
                                     PhysicsParams(coriolis_f=1e-4), 0.01)
        _swe_kernel_path(monkeypatch, err=1)
        s = state_from_numpy(dict(zip("uvh", _fields(8, 8))), CPU)
        before = swe_rk4_step_cuda.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            st.step(st.init(s), s, 0.01)
        assert swe_rk4_step_cuda.launches == before

    @pytest.mark.parametrize("name", FORMS)
    def test_keeps_a_bounded_number_of_operand_sets(self, monkeypatch, name):
        """A replaced state drops its arrangement's bindings: of 24 states
        put in from outside, the stepper keeps none but its own buffers
        alive."""
        import gc
        import weakref

        form = _Form(name)
        if name == "swe":
            _swe_kernel_path(monkeypatch)
        refs = []
        s = form.run(form.state())
        for i in range(24):
            new = form.changed(s, "data_ptr")
            refs.append(weakref.ref(next((new[0] if isinstance(new, list)
                                          else new).items())[1]))
            s = form.run(form.run(new))
        del new, s
        gc.collect()
        assert sum(r() is not None for r in refs) <= 2

    @pytest.mark.parametrize("name", FORMS)
    def test_a_released_stepper_frees_its_buffers(self, monkeypatch, name):
        """A stepper holds no reference cycle: released, its buffers go at
        once, with the garbage collector off (a sharded stepper's padded
        blocks are several states' worth of a card's memory)."""
        import gc
        import weakref

        form = _Form(name)
        if name == "swe":
            _swe_kernel_path(monkeypatch)
        s = form.run(form.run(form.state()))
        ref = weakref.ref(next((s[0] if isinstance(s, list) else s)
                               .items())[1])
        gc.disable()
        try:
            del form, s
            assert ref() is None
        finally:
            gc.enable()

    @pytest.mark.parametrize("variant,counter", [
        ("slices", "launches"), ("bf16", "bf16_launches"),
        ("x2", "multistep")])
    def test_counts_each_form_on_its_counter(self, monkeypatch, variant,
                                             counter):
        grid, params = GridSpec(nx=8, ny=8), PhysicsParams()
        st = stencil.make_kernel_multistep_stepper(grid, params, 0.01) \
            if variant == "x2" else make_kernel_rk4_stepper(
                grid, params, 0.01, variant=variant)
        _swe_kernel_path(monkeypatch)

        def count():
            if counter == "multistep":
                return stencil.swe_rk4_multistep_cuda.launches
            return getattr(swe_rk4_step_cuda, counter)

        before = count()
        s = state_from_numpy(dict(zip("uvh", _fields(8, 8))), CPU)
        st.step(st.init(s), s, 0.01)
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

        monkeypatch.setattr(_build, "load", no_build)
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
