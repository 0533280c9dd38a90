"""The fused SWE step's variants and the multistep kernel in the port
(njw_tpu_torch.ops.stencil) against the JAX package's Pallas kernels in
interpret mode on the CPU.

The bf16 tendency is held to the JAX test's band
(tests/test_ops_stencil.py:86-95: within 2e-2 of max|h| of the float32
RK4 step, and different from it), not to JAX's bits: XLA's CPU backend may
keep float32 intermediates inside a bf16 fusion, where the port (and its
kernel) round every bf16 operation. The float32 variants and the
multistep kernel are held at the JAX kernel tests' rtol 1e-5 / atol 1e-6.
The CUDA kernels themselves run only on a GPU (tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops.stencil import (  # noqa: E402
    swe_rk4_multistep_pallas, swe_rk4_step_pallas,
)
from njw_tpu.weather import (  # noqa: E402
    GridSpec as JGrid, PhysicsParams as JParams, WeatherState as JState,
    make_initial_state as j_ic, make_tendency_fn as j_tendency_fn,
)
from njw_tpu.weather.integrators import make_stepper as j_make_stepper  # noqa: E402,E501

from njw_tpu_torch.ops import stencil  # noqa: E402
from njw_tpu_torch.ops.stencil import (  # noqa: E402
    make_kernel_multistep_stepper, make_kernel_rk4_stepper,
    swe_rk4_multistep, swe_rk4_multistep_cuda, swe_rk4_multistep_plain,
    swe_rk4_step, swe_rk4_step_cuda, swe_rk4_step_padded,
    swe_rk4_step_plain,
)
from njw_tpu_torch.weather import GridSpec, PhysicsParams  # noqa: E402
from njw_tpu_torch.weather.convert import state_from_numpy  # noqa: E402
from njw_tpu_torch.weather.main_paths import VARIANT_PATHS  # noqa: E402

CPU = "cpu"
# tests/test_ops_stencil.py's GRID, initial state, dt and f
JG = JGrid(nx=128, ny=64)
GRID = GridSpec(nx=128, ny=64)
DT, F = 0.01, 1e-4
BAND = 2e-2                       # of max|h|: tests/test_ops_stencil.py:93
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vortex():
    """The JAX tests' vortex (strength 2.0) as JAX arrays and as the
    port's CPU tensors."""
    s = j_ic("vortex", JG, strength=2.0)
    j = (s.u, s.v, s.h)
    return j, tuple(torch.from_numpy(np.asarray(a).copy()) for a in j)


def _xla_rk4(j, nu):
    """The JAX package's float32 RK4 step (XLA integrator)."""
    st = j_make_stepper("rk4", j_tendency_fn(
        "shallow_water", JG, JParams(coriolis_f=F, viscosity=nu)))
    _, out = st.step((), JState(u=j[0], v=j[1], h=j[2]), jnp.float32(DT))
    return tuple(np.asarray(a) for a in (out.u, out.v, out.h))


def _max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(a, b))


class TestBf16Variant:
    @pytest.mark.parametrize("nu", [0.0, 0.02], ids=["inviscid", "viscous"])
    @pytest.mark.parametrize("variant", ["bf16", "bf16s"])
    def test_within_the_jax_band(self, vortex, variant, nu):
        """Port and JAX both within 2e-2 max|h| of the float32 step and of
        each other, and the port's step differs from float32 (measured:
        7.3e-5 / 1.0e-4 of max|h| from float32 inviscid / viscous, 1.0e-4
        from JAX's bf16 step)."""
        j, t = vortex
        ref = _xla_rk4(j, nu)
        scale = float(np.abs(ref[2]).max())
        want = swe_rk4_step_pallas(*j, grid=JG, dt=DT, coriolis_f=F, by=16,
                                   interpret=True, variant=variant,
                                   viscosity=nu)
        got = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                                 variant=variant, viscosity=nu)
        got = tuple(a.numpy() for a in got)
        assert _max_diff(want, ref) / scale < BAND
        assert _max_diff(got, ref) / scale < BAND
        assert _max_diff(got, want) / scale < BAND
        assert float(np.abs(got[2] - ref[2]).max()) > 0

    def test_bf16s_is_bf16(self, vortex):
        """The two names differ only in the TPU kernel's shift lowering."""
        _, t = vortex
        a = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                               variant="bf16")
        b = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                               variant="bf16s")
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def test_rounds_every_bf16_operation(self):
        """A difference that float32 resolves and bf16 does not: two
        neighbours 1 + 2^-9 apart round to the same bf16 value, so the
        bf16 tendency sees no gradient where float32 does."""
        grid = GridSpec(nx=8, ny=4)
        h = torch.full((4, 8), 1.0)
        h[:, 1] = 1.0 + 2.0 ** -9
        u = torch.zeros(4, 8)
        a = swe_rk4_step_plain(u, u, h, grid=grid, dt=1e-3, variant="bf16")
        b = swe_rk4_step_plain(u, u, h, grid=grid, dt=1e-3)
        assert float(a[0].abs().max()) == 0.0
        assert float(b[0].abs().max()) > 0.0

    @pytest.mark.parametrize("dx", [0.3, 1.0 / 3.0,
                                    0.5 / (1 + 2**-8 + 2**-30)],
                             ids=["0.3", "third", "f32_tie"])
    def test_constants_round_like_jax(self, dx):
        """bcx = bf16(0.5 / dx) as jnp.bfloat16 makes it. At a tie in
        float32 (f32_tie: 0.5 / dx = 1 + 2^-8 + 2^-30) rounding the double
        straight to bf16 would give 1 + 2^-7; JAX (ml_dtypes) and torch
        both round through float32 to 1.0, and the port follows them."""
        k = stencil.rk4_constants(GridSpec(dx=dx, dy=dx), DT, 9.81, F, 0.0,
                                  bf16=True)
        cx = 0.5 / dx
        assert k["bcx"] == k["bcy"] == float(jnp.bfloat16(cx))
        straight = _bf16_straight(cx)
        if dx == 0.3 or dx == 1.0 / 3.0:
            assert k["bcx"] == straight
        else:
            assert (k["bcx"], straight) == (1.0, 1.0 + 2.0 ** -7)

    def test_kernel_flag_and_float32_constants_unchanged(self):
        a = stencil.rk4_constants(GRID, DT, 9.81, F, 0.02)
        b = stencil.rk4_constants(GRID, DT, 9.81, F, 0.02, bf16=True)
        assert "bf16" not in a and b["bf16"] is True
        assert {key: b[key] for key in a} == a


def _bf16_straight(x: float) -> float:
    """The double x rounded to bf16 in one step, to nearest even."""
    m, e = math.frexp(x)
    return math.ldexp(round(m * 256.0), e - 8)


class TestFloat32VariantNames:
    @pytest.mark.parametrize("variant", ["base", "slices", "folded"])
    def test_equal_the_float32_step_and_match_jax(self, vortex, variant):
        j, t = vortex
        got = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                                 variant=variant)
        default = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F)
        assert all(torch.equal(a, b) for a, b in zip(got, default))
        want = swe_rk4_step_pallas(*j, grid=JG, dt=DT, coriolis_f=F, by=16,
                                   interpret=True, variant=variant)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("call", ["step", "plain", "stepper"])
    def test_unknown_variant_raises(self, vortex, call):
        _, t = vortex
        kw = dict(grid=GRID, dt=DT, variant="fp8")
        with pytest.raises(ValueError, match="unknown variant"):
            if call == "step":
                swe_rk4_step(*t, **kw)
            elif call == "plain":
                swe_rk4_step_plain(*t, **kw)
            else:
                make_kernel_rk4_stepper(GRID, PhysicsParams(), DT,
                                        variant="fp8")

    def test_padded_launches_take_no_variant(self):
        """As in the JAX package, the sharded launchers are float32 only."""
        blk = torch.zeros(16, 8)
        with pytest.raises(TypeError, match="variant"):
            swe_rk4_step_padded(blk, blk, blk, halo=(4, 0), dt=DT,
                                variant="bf16")


class TestMultistep:
    @pytest.mark.parametrize("n_fused", [1, 2])
    def test_plain_matches_pallas_and_equals_single_steps(self, vortex,
                                                          n_fused):
        j, t = vortex
        want = swe_rk4_multistep_pallas(*j, grid=JG, dt=DT, coriolis_f=F,
                                        by=16, n_fused=n_fused,
                                        interpret=True)
        got = swe_rk4_multistep_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                                      n_fused=n_fused)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
        ref = t
        for _ in range(n_fused):
            ref = swe_rk4_step_plain(*ref, grid=GRID, dt=DT, coriolis_f=F)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))

    @pytest.mark.parametrize("n_fused", [0, 3])
    def test_n_fused_outside_1_2_raises(self, vortex, n_fused):
        j, t = vortex
        with pytest.raises(ValueError, match="n_fused must be 1 or 2"):
            swe_rk4_multistep(*t, grid=GRID, dt=DT, n_fused=n_fused)
        with pytest.raises(ValueError, match="n_fused must be 1 or 2"):
            swe_rk4_multistep_pallas(*j, grid=JG, dt=DT, n_fused=n_fused,
                                     interpret=True)

    def test_ragged_and_tiny_grids(self):
        """No tile-multiple conditions (the JAX kernel needs nx % 128 == 0
        and ny % by == 0): the plain version on a 5 x 7 and a 37 x 29 grid
        equals two one-step plain versions."""
        for ny, nx in ((5, 7), (37, 29)):
            rng = np.random.default_rng(ny)
            f = tuple(torch.from_numpy(
                (c + rng.uniform(-0.3, 0.3, (ny, nx))).astype(np.float32))
                for c in (0.0, 0.0, 10.0))
            grid = GridSpec(nx=nx, ny=ny, dx=1.3)
            got = swe_rk4_multistep(*f, grid=grid, dt=DT, coriolis_f=F)
            ref = swe_rk4_step_plain(*f, grid=grid, dt=DT, coriolis_f=F)
            ref = swe_rk4_step_plain(*ref, grid=grid, dt=DT, coriolis_f=F)
            assert all(torch.equal(a, b) for a, b in zip(got, ref))

    def test_cpu_tensors_launch_nothing(self, vortex):
        _, t = vortex
        before = (swe_rk4_multistep_cuda.launches,
                  swe_rk4_step_cuda.launches,
                  swe_rk4_step_cuda.bf16_launches)
        out = tuple(torch.empty_like(x) for x in t)
        res = swe_rk4_multistep(*t, grid=GRID, dt=DT, out=out)
        assert all(r is o for r, o in zip(res, out))
        swe_rk4_step(*t, grid=GRID, dt=DT, variant="bf16")
        assert (swe_rk4_multistep_cuda.launches, swe_rk4_step_cuda.launches,
                swe_rk4_step_cuda.bf16_launches) == before

    @pytest.mark.parametrize("variant", ["slices", "bf16"])
    def test_cuda_wrappers_refuse_cpu_tensors(self, vortex, variant):
        _, t = vortex
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swe_rk4_multistep_cuda(*t, grid=GRID, dt=DT)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            swe_rk4_step_cuda(*t, grid=GRID, dt=DT, variant=variant)


class TestSteppers:
    def test_bf16_stepper(self, vortex):
        _, t = vortex
        st = make_kernel_rk4_stepper(GRID, PhysicsParams(coriolis_f=F), DT,
                                     variant="bf16")
        assert st.name == "rk4_kernel_bf16"
        s = state_from_numpy(dict(zip("uvh", (x.numpy() for x in t))), CPU)
        _, got = st.step(st.init(s), s, DT)
        want = swe_rk4_step_plain(*t, grid=GRID, dt=DT, coriolis_f=F,
                                  variant="bf16")
        assert all(torch.equal(a, b) for a, b in
                   zip((got.u, got.v, got.h), want))

    def test_multistep_stepper_ping_pongs(self, vortex):
        _, t = vortex
        st = make_kernel_multistep_stepper(GRID, PhysicsParams(coriolis_f=F),
                                           DT)
        assert st.name == "rk4_kernel_x2" and st.stages == 8
        s = state_from_numpy(dict(zip("uvh", (x.numpy() for x in t))), CPU)
        carry = st.init(s)
        ptrs = []
        for _ in range(3):
            carry, s = st.step(carry, s, DT)
            ptrs.append(s.h.data_ptr())
        assert ptrs[0] == ptrs[2] != ptrs[1]
        ref = t
        for _ in range(6):
            ref = swe_rk4_step_plain(*ref, grid=GRID, dt=DT, coriolis_f=F)
        assert all(torch.equal(a, b) for a, b in zip((s.u, s.v, s.h), ref))

    def test_multistep_stepper_refuses_viscosity(self):
        with pytest.raises(ValueError, match="viscosity"):
            make_kernel_multistep_stepper(GRID, PhysicsParams(viscosity=0.1),
                                          DT)


class TestVariantPaths:
    """VARIANT_PATHS at a small size on the CPU (the kernels' plain
    versions): the full-width runs are chip_smoke.py's."""

    SMALL = dict(device=CPU, grid_width=48, grid_height=32)

    def test_table(self):
        assert set(VARIANT_PATHS) == {"swe_bf16", "swe_multistep", "swe_si",
                                      "pe_si"}
        assert VARIANT_PATHS["swe_multistep"].main.steps == 500
        assert VARIANT_PATHS["swe_multistep"].steps_per_call == 2
        assert VARIANT_PATHS["swe_bf16"].main.steps == 1000
        si = VARIANT_PATHS["pe_si"].main.config
        assert (si["dt"], si["si_order"], si["num_levels"]) == (450.0, 2, 20)

    def test_swe_paths_against_the_float32_run(self):
        from njw_tpu_torch.weather.main_paths import MAIN_PATHS

        f32 = MAIN_PATHS["swe"].simulation(backend="kernel", **self.SMALL)
        bf = VARIANT_PATHS["swe_bf16"].simulation(**self.SMALL)
        multi = VARIANT_PATHS["swe_multistep"].simulation(**self.SMALL)
        assert (bf.stepper.name, multi.stepper.name) == ("rk4_kernel_bf16",
                                                         "rk4_kernel_x2")
        f32.step(20)
        bf.step(20)
        multi.step(10)
        assert multi.time == pytest.approx(f32.time)
        for name in ("u", "v", "h"):
            a = getattr(f32.state, name)
            assert torch.equal(getattr(multi.state, name), a), name
        scale = float(f32.state.h.abs().max())
        assert 0 < float((bf.state.h - f32.state.h).abs().max()) \
            < BAND * scale

    @pytest.mark.parametrize("name", ["swe_si", "pe_si"])
    def test_si_paths_step(self, name):
        overrides = dict(self.SMALL)
        if name == "pe_si":
            overrides["num_levels"] = 4
        sim = VARIANT_PATHS[name].simulation(**overrides)
        assert sim.stepper.name == "semi_implicit"
        sim.step(3)
        assert all(bool(torch.isfinite(t).all()) for _, t in
                   sim.state.items())
