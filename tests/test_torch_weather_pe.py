"""The PyTorch port's primitive-equations core held against the JAX package.

Inputs are made with the JAX package (deterministic initial states) or
with numpy from a fixed seed, and carried to both packages
(``njw_tpu_torch.weather.convert``); everything runs on the CPU, where the
port's kernel wrappers run the kernels' plain versions and the JAX stage
and whole-step kernels run in Pallas interpret mode. The tolerances are the JAX package's
own tests' (tests/test_weather_primitive.py).
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from njw_tpu.ops.pe_stencil import (  # noqa: E402
    make_pe_pallas_rk4_stepper, pe_rk4_step_pallas, pe_stage_pallas,
)
from njw_tpu.weather import GridSpec as JGrid  # noqa: E402
from njw_tpu.weather import PhysicsParams as JParams  # noqa: E402
from njw_tpu.weather import oracle as j_oracle  # noqa: E402
from njw_tpu.weather import primitive as jp  # noqa: E402

from njw_tpu_torch.ops.pe_stencil import (  # noqa: E402
    RK4_CLUSTERS, RK4_LEVELS_PER_BLOCK, RK4_TILE_MAX, SMEM_PER_BLOCK,
    Rk4Layout, _rk4_layout_arg, _rk4_padded_args, make_pe_kernel_rk4_stepper,
    pe_kernel_supported, pe_rk4_kernel_fits, pe_rk4_padded_plain,
    pe_rk4_step, pe_rk4_step_cuda, pe_rk4_step_plain, pe_stage,
    pe_stage_cuda, pe_stage_plain, rk4_layout, rk4_smem_bytes,
)
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation, make_tendency_fn,
)
from njw_tpu_torch.weather import oracle as t_oracle  # noqa: E402
from njw_tpu_torch.weather import primitive as tp  # noqa: E402
from njw_tpu_torch.weather.convert import (  # noqa: E402
    grid_from_jax_fields, params_from_jax_fields, pe_state_from_numpy,
    pe_state_to_numpy, tensor_from_numpy,
)
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402

CPU = "cpu"
FIELDS = ("u", "v", "T", "q", "ps")
JPARAMS = JParams(coriolis_f=1e-4)
THIRD = 1.0 / 3.0
RK4_COEFFS = (-THIRD, THIRD, 2.0 * THIRD, THIRD)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps the
    torch thread pool from fighting the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mountain(ny, nx, height_gp=1500.0):
    """The JAX terrain tests' Gaussian surface geopotential."""
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float32)
    cy, cx = (ny - 1) / 2, (nx - 1) / 2
    return (height_gp * np.exp(-(((y - cy) / 6) ** 2
                                 + ((x - cx) / 6) ** 2))).astype(np.float32)


def _jax_state(jg, phi_s=None, **kw):
    """A JAX initial state (random ps perturbation from JAX's own key)
    with winds at the walls, as numpy, and the same state in torch."""
    s = jp.pe_initial_state(jg, phi_s=None if phi_s is None
                            else jnp.asarray(phi_s), **kw)
    v = s.v + 3.0 * jnp.sin(
        jnp.arange(jg.nx, dtype=jnp.float32) / 5.0)[None, None, :]
    s = jp.PEState(u=s.u, v=v, T=s.T, q=s.q, ps=s.ps)
    return s, pe_state_from_numpy(s, CPU)


def _assert_fields(got, want, rtol, atol, q_atol=None, names=FIELDS):
    for name in names:
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(), np.asarray(getattr(want,
                                                                    name)),
            rtol=rtol, atol=q_atol if name == "q" and q_atol else atol,
            err_msg=name)


class TestBasics:
    @pytest.mark.parametrize("L", [2, 5, 20])
    def test_sigma_levels_match_jax(self, L):
        for a, b in zip(tp.sigma_levels(L, device=CPU), jp.sigma_levels(L)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)

    @pytest.mark.parametrize("terrain", [False, True], ids=["flat", "terrain"])
    def test_hydrostatic_geopotential_matches_jax(self, terrain):
        L, ny, nx = 6, 8, 12
        rng = np.random.default_rng(0)
        T = (250.0 + 40.0 * rng.random((L, ny, nx))).astype(np.float32)
        phi_s = _mountain(ny, nx) if terrain else None
        got = tp.hydrostatic_geopotential(
            tensor_from_numpy(T, CPU), L,
            None if phi_s is None else tensor_from_numpy(phi_s, CPU))
        want = jp.hydrostatic_geopotential(
            jnp.asarray(T), L, None if phi_s is None else jnp.asarray(phi_s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def test_constants_match_jax(self):
        assert (tp.R_DRY, tp.CP_DRY, tp.KAPPA) == (jp.R_DRY, jp.CP_DRY,
                                                   jp.KAPPA)

    @pytest.mark.parametrize("kw", [
        {}, {"u_jet": 5.0}, {"u_jet": 0.0, "lapse": 0.0, "deltaT_y": 0.0},
        {"terrain": True}], ids=["default", "jet5", "resting", "terrain"])
    def test_initial_state_matches_jax(self, kw):
        kw = dict(kw)
        jg = JGrid(nx=40, ny=24, levels=5, dx=1e5, dy=1e5)
        phi_s = _mountain(24, 40) if kw.pop("terrain", False) else None
        got = tp.pe_initial_state(
            grid_from_jax_fields(jg), device=CPU,
            phi_s=None if phi_s is None else tensor_from_numpy(phi_s, CPU),
            **kw)
        want = jp.pe_initial_state(
            jg, phi_s=None if phi_s is None else jnp.asarray(phi_s), **kw)
        _assert_fields(got, want, 1e-6, 1e-6)

    @pytest.mark.parametrize("fn", ["sigma_levels", "pe_initial_state"])
    def test_default_device_is_cuda(self, fn):
        """The default device is the card: without one it raises, and
        does not fall back to the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            if fn == "sigma_levels":
                tp.sigma_levels(4)
            else:
                tp.pe_initial_state(GridSpec(nx=8, ny=8, levels=2))

    def test_perturbed_initial_state_shape_and_seed(self):
        grid = GridSpec(nx=24, ny=16, levels=3)
        a = tp.pe_initial_state(grid, device=CPU, perturb=0.5, seed=3)
        b = tp.pe_initial_state(grid, device=CPU, perturb=0.5, seed=3)
        c = tp.pe_initial_state(grid, device=CPU, perturb=0.5, seed=4)
        flat = tp.pe_initial_state(grid, device=CPU)
        assert a.u.shape == (3, 16, 24) and a.ps.shape == (16, 24)
        assert all(t.dtype == torch.float32 for _, t in a.items())
        assert torch.equal(a.ps, b.ps) and not torch.equal(a.ps, c.ps)
        assert torch.equal(a.u, flat.u)  # only ps is perturbed
        assert 0.0 < float((a.ps - flat.ps).abs().max()) < 5.0


class TestTendencies:
    @pytest.mark.parametrize("bc", ["periodic", "clamped", "outflow",
                                    "reflective"])
    def test_match_jax(self, bc):
        jg = JGrid(nx=48, ny=32, levels=5, dx=1e5, dy=1e5, bc=bc)
        js, ts = _jax_state(jg, u_jet=15.0, perturb=1.0)
        got = tp.pe_tendencies(ts, grid_from_jax_fields(jg),
                               params_from_jax_fields(JPARAMS))
        want = jp.pe_tendencies(js, jg, JPARAMS)
        _assert_fields(got, want, 1e-4, 1e-6, q_atol=1e-8)

    def test_match_jax_with_terrain(self):
        jg = JGrid(nx=48, ny=32, levels=4, dx=1e5, dy=1e5)
        phi_s = _mountain(32, 48)
        js, ts = _jax_state(jg, phi_s=phi_s, u_jet=10.0, perturb=0.5)
        got = tp.pe_tendencies(ts, grid_from_jax_fields(jg),
                               params_from_jax_fields(JPARAMS),
                               phi_s=tensor_from_numpy(phi_s, CPU))
        want = jp.pe_tendencies(js, jg, JPARAMS, phi_s=jnp.asarray(phi_s))
        _assert_fields(got, want, 1e-4, 1e-6, q_atol=1e-8)

    @pytest.mark.parametrize("bc", ["periodic", "reflective"])
    def test_match_port_oracle(self, bc):
        jg = JGrid(nx=48, ny=32, levels=5, dx=1e5, dy=1e5, bc=bc)
        js, ts = _jax_state(jg, u_jet=15.0, perturb=1.0)
        got = tp.pe_tendencies(ts, grid_from_jax_fields(jg),
                               params_from_jax_fields(JPARAMS))
        ref = t_oracle.pe_tendencies_np(
            *(ts.to_numpy()[n] for n in FIELDS), dx=1e5, dy=1e5, bc=bc,
            coriolis_f=1e-4)
        for name, r in zip(FIELDS, ref):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), r, rtol=1e-4,
                atol=1e-8 if name == "q" else 1e-6, err_msg=name)

    def test_make_tendency_fn_serves_the_core(self):
        grid = GridSpec(nx=16, ny=12, levels=3, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s = tp.pe_initial_state(grid, device=CPU, u_jet=8.0, perturb=0.5)
        got = make_tendency_fn("primitive", grid, params)(s)
        want = tp.pe_tendencies(s, grid, params)
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name))

    def test_resting_isothermal_atmosphere_over_terrain_is_steady(self):
        grid = GridSpec(nx=48, ny=32, levels=5, dx=1e5, dy=1e5)
        phi_s = tensor_from_numpy(_mountain(32, 48, 2000.0), CPU)
        s = tp.pe_initial_state(grid, device=CPU, u_jet=0.0, lapse=0.0,
                                deltaT_y=0.0, phi_s=phi_s)
        t = tp.pe_tendencies(s, grid, PhysicsParams(coriolis_f=1e-4),
                             phi_s=phi_s)
        assert float(t.u.abs().max()) < 1e-3 and float(t.v.abs().max()) < 1e-3


class TestStage:
    """The K5 stage's plain version against the JAX stage kernel."""

    @pytest.mark.parametrize("nbase,terrain", [(1, False), (4, False),
                                               (1, True)],
                             ids=["one_base", "four_bases", "terrain"])
    def test_plain_matches_pallas_interpret(self, nbase, terrain):
        jg = JGrid(nx=128, ny=16, levels=4, dx=1e5, dy=1e5)
        phi_s = _mountain(16, 128) if terrain else None
        jcur, tcur = _jax_state(jg, phi_s=phi_s, u_jet=10.0, perturb=0.5)
        jbases, tbases = [jcur], [tcur]
        for g in range(1, nbase):
            jb, tb = _jax_state(jg, u_jet=4.0 + g, perturb=0.3, seed=g)
            jbases.append(jb)
            tbases.append(tb)
        coeffs = (1.0,) if nbase == 1 else RK4_COEFFS
        want = pe_stage_pallas(
            jcur, jbases[0] if nbase == 1 else tuple(jbases), grid=jg,
            c_dt=15.0, coriolis_f=1e-4, base_coeffs=coeffs,
            phi_s=None if phi_s is None else jnp.asarray(phi_s), by=8,
            interpret=True)
        got = pe_stage_plain(
            tcur, tbases, grid=grid_from_jax_fields(jg), c_dt=15.0,
            coriolis_f=1e-4, base_coeffs=coeffs,
            phi_s=None if phi_s is None else tensor_from_numpy(phi_s, CPU))
        _assert_fields(got, want, 1e-5, 2e-4 if terrain else 1e-4)

    def test_plain_equals_tendency_axpy(self):
        grid = GridSpec(nx=24, ny=20, levels=3, dx=1e5, dy=1e5)
        s = tp.pe_initial_state(grid, device=CPU, u_jet=10.0, perturb=0.5)
        out = s.map(torch.empty_like)
        before = pe_stage_cuda.launches
        got = pe_stage(s, s, grid=grid, c_dt=15.0, coriolis_f=1e-4, out=out)
        assert got is out and pe_stage_cuda.launches == before
        t = tp.pe_tendencies(s, grid, PhysicsParams(coriolis_f=1e-4))
        for name in FIELDS:
            torch.testing.assert_close(
                getattr(got, name), getattr(s, name) + 15.0 * getattr(t, name),
                rtol=1e-5, atol=1e-4)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        grid = GridSpec(nx=8, ny=8, levels=2)
        s = tp.pe_initial_state(grid, device=CPU)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            pe_stage_cuda(s, s, grid=grid, c_dt=1.0)

    @pytest.mark.parametrize("bad,match", [
        ("coeffs", "coefficients"), ("five_bases", "coefficients"),
        ("shape", "shape"), ("alias", "alias"), ("clamped", "periodic")])
    def test_bad_inputs_raise(self, bad, match):
        grid = GridSpec(nx=8, ny=8, levels=2)
        s = tp.pe_initial_state(grid, device=CPU)
        bases, coeffs, out = (s,), (1.0,), None
        if bad == "coeffs":
            coeffs = (1.0, 2.0)
        elif bad == "five_bases":
            bases, coeffs = (s,) * 5, (1.0,) * 5
        elif bad == "shape":
            grid = GridSpec(nx=8, ny=8, levels=3)
        elif bad == "alias":
            out = s
        else:
            grid = GridSpec(nx=8, ny=8, levels=2, bc="clamped")
        with pytest.raises(ValueError, match=match):
            pe_stage(s, bases, grid=grid, c_dt=1.0, base_coeffs=coeffs,
                     out=out)

    def test_supported_predicate(self):
        p = PhysicsParams(coriolis_f=1e-4)
        assert pe_kernel_supported(GridSpec(nx=100, ny=30, levels=3), p)
        assert not pe_kernel_supported(GridSpec(nx=64, ny=64, levels=1), p)
        assert not pe_kernel_supported(
            GridSpec(nx=64, ny=64, levels=4, bc="clamped"), p)
        assert not pe_kernel_supported(GridSpec(nx=64, ny=64, levels=4),
                                       PhysicsParams(viscosity=0.1))
        assert not pe_kernel_supported(GridSpec(nx=64, ny=64, levels=4),
                                       PhysicsParams(beta=1e-11))
        assert pe_kernel_supported(GridSpec(nx=8, ny=8, levels=454), p)
        assert not pe_kernel_supported(GridSpec(nx=8, ny=8, levels=455), p)


class TestWholeStep:
    """The K4 whole step's plain version against the JAX whole-step
    kernel."""

    @pytest.mark.parametrize("nx,bx,terrain", [(128, 128, False),
                                               (128, 128, True),
                                               (256, 128, False)],
                             ids=["flat", "terrain", "x_blocked"])
    def test_plain_matches_pallas_interpret(self, nx, bx, terrain):
        jg = JGrid(nx=nx, ny=16, levels=4, dx=1e5, dy=1e5)
        phi_s = _mountain(16, nx) if terrain else None
        js, ts = _jax_state(jg, phi_s=phi_s, u_jet=10.0, perturb=0.5)
        want = pe_rk4_step_pallas(
            js, grid=jg, dt=30.0, coriolis_f=1e-4, by=8, bx=bx,
            phi_s=None if phi_s is None else jnp.asarray(phi_s),
            interpret=True)
        got = pe_rk4_step_plain(
            ts, grid=grid_from_jax_fields(jg), dt=30.0, coriolis_f=1e-4,
            phi_s=None if phi_s is None else tensor_from_numpy(phi_s, CPU))
        _assert_fields(got, want, 1e-5, 2e-4 if terrain else 1e-4)

    def test_plain_equals_four_plain_stages(self):
        grid = GridSpec(nx=24, ny=20, levels=3, dx=1e5, dy=1e5)
        s = tp.pe_initial_state(grid, device=CPU, u_jet=10.0, perturb=0.5)
        kw = dict(grid=grid, coriolis_f=1e-4)
        s1 = pe_stage_plain(s, s, c_dt=15.0, **kw)
        s2 = pe_stage_plain(s1, s, c_dt=15.0, **kw)
        s3 = pe_stage_plain(s2, s, c_dt=30.0, **kw)
        want = pe_stage_plain(s3, (s, s1, s2, s3), c_dt=5.0,
                              base_coeffs=RK4_COEFFS, **kw)
        out = s.map(torch.empty_like)
        before = pe_rk4_step_cuda.launches
        got = pe_rk4_step(s, dt=30.0, out=out, **kw)
        assert got is out and pe_rk4_step_cuda.launches == before
        _assert_fields(got, want, 1e-5, 1e-4)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        grid = GridSpec(nx=8, ny=8, levels=2)
        s = tp.pe_initial_state(grid, device=CPU)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            pe_rk4_step_cuda(s, grid=grid, dt=1.0)

    @pytest.mark.parametrize("bad,match", [
        ("shape", "shape"), ("alias", "alias"), ("clamped", "periodic"),
        ("phi_s", "phi_s")])
    def test_bad_inputs_raise(self, bad, match):
        grid = GridSpec(nx=8, ny=8, levels=2)
        s = tp.pe_initial_state(grid, device=CPU)
        out, phi_s = None, None
        if bad == "shape":
            grid = GridSpec(nx=8, ny=8, levels=3)
        elif bad == "alias":
            out = s
        elif bad == "phi_s":
            phi_s = torch.zeros(4, 8)
        else:
            grid = GridSpec(nx=8, ny=8, levels=2, bc="clamped")
        with pytest.raises(ValueError, match=match):
            pe_rk4_step(s, grid=grid, dt=1.0, out=out, phi_s=phi_s)

    def test_fits_predicate(self):
        # a one-column tile over a cluster of 8 blocks: ceil(L/8) levels a
        # block, 4 (345 x 131 + 11,425 + 81 + 2L) B = 232,308 at L = 688,
        # 234,932 at L = 689 (over the 232,448 a block may have)
        assert pe_rk4_kernel_fits(20) and pe_rk4_kernel_fits(688)
        assert not pe_rk4_kernel_fits(689) and not pe_rk4_kernel_fits(0)
        assert pe_rk4_kernel_fits(40) and pe_rk4_kernel_fits(2)
        assert pe_rk4_kernel_fits(227) and pe_rk4_kernel_fits(454)

    @pytest.mark.parametrize("L,tile,ncta,want", [
        # with lc = ceil(L / ncta) and F = 4 lc + 1:
        # F ((T+8)^2 + (T+6)^2 + T^2) + max(F (T+4)^2, lc ((T+8)^2 +
        # (T+6)^2) + 5 (T+6)^2) + (T+8)^2 + 2L words, worked out by hand
        (20, 8, 1, 4 * (81 * 516 + 81 * 144 + 256 + 40)),          # 215,024
        (40, 8, 2, 4 * (81 * 516 + 81 * 144 + 256 + 80)),          # 215,184
        (40, 4, 1, 4 * (161 * 260 + 161 * 64 + 144 + 80)),         # 209,552
        (40, 8, 1, 4 * (161 * 516 + 161 * 144 + 256 + 80)),        # 426,384
        (168, 8, 8, 4 * (85 * 516 + 85 * 144 + 256 + 336)),        # 226,768
        (169, 8, 8, 4 * (89 * 516 + 89 * 144 + 256 + 338)),        # 237,336
        (688, 1, 8, 4 * (345 * 131 + 86 * 130 + 245 + 81 + 1376)),  # 232,308
        (689, 1, 8, 4 * (349 * 131 + 87 * 130 + 245 + 81 + 1378)),  # 234,932
        (2, 16, 1, 4 * (9 * 1316 + 2 * 1060 + 2420 + 576 + 4))])   # 67,856
    def test_shared_memory_by_hand(self, L, tile, ncta, want):
        assert rk4_smem_bytes(L, tile, ncta) == want

    @pytest.mark.parametrize("L,ncta,tile", [
        (1, 1, 8), (2, 1, 8), (20, 1, 8), (21, 1, 8), (22, 2, 8),
        (40, 2, 8), (42, 2, 8), (43, 4, 8), (84, 4, 8), (85, 8, 8),
        (168, 8, 8), (169, 8, 7), (227, 8, 6), (454, 8, 2), (688, 8, 1),
        (689, None, None), (0, None, None)])
    def test_tile_choice(self, L, ncta, tile):
        # the smallest cluster whose blocks hold tile 8 with at most 21
        # levels each; past it 8 blocks and the largest tile that fits
        layout = rk4_layout(L)
        if ncta is None:
            assert layout is None
            return
        assert layout == Rk4Layout(ncta, tile)
        assert rk4_smem_bytes(L, tile, ncta) <= SMEM_PER_BLOCK
        assert -(-L // ncta) <= RK4_LEVELS_PER_BLOCK or ncta == 8
        smaller = RK4_CLUSTERS[:RK4_CLUSTERS.index(ncta)]
        assert all(-(-L // c) > RK4_LEVELS_PER_BLOCK for c in smaller)
        if tile < RK4_TILE_MAX:
            assert rk4_smem_bytes(L, tile + 1, ncta) > SMEM_PER_BLOCK

    @pytest.mark.parametrize("L,layout,match", [
        (20, (1, 9), "shared memory"), (40, (1, 5), "shared memory"),
        (40, (1, 6), "shared memory"), (169, (8, 8), "shared memory"),
        (689, None, "do not fit"), (0, None, "do not fit")])
    def test_tile_refusals(self, L, layout, match):
        with pytest.raises(ValueError, match=match):
            _rk4_layout_arg(L, None if layout is None else Rk4Layout(*layout),
                            "pe_rk4_step")

    @pytest.mark.parametrize("L,layout", [
        (20, None), (20, (1, 6)), (40, (1, 3)), (6, (1, 16)),
        (40, (4, 8)), (688, None)])
    def test_tile_accepted(self, L, layout):
        want = rk4_layout(L) if layout is None else Rk4Layout(*layout)
        got = _rk4_layout_arg(
            L, None if layout is None else Rk4Layout(*layout), "pe_rk4_step")
        assert got == want

    def test_padded_form_refuses_levels_the_kernel_does_not_hold(self):
        grid = GridSpec(nx=12, ny=12, levels=689, dx=1e5, dy=1e5)
        s = tp.pe_initial_state(grid, device=CPU)
        with pytest.raises(ValueError, match="do not fit"):
            pe_rk4_padded_plain(s, halo=(4, 4), dt=1.0)

    @pytest.mark.parametrize("levels,want", [(20, (1, 8)), (40, (2, 8)),
                                             (227, (8, 6))])
    def test_padded_form_takes_the_rule_layout(self, levels, want):
        """The padded launches take the rule's layout: config 5's L = 40
        on a cluster of two blocks at tile 8."""
        grid = GridSpec(nx=12, ny=12, levels=levels, dx=1e5, dy=1e5)
        s = tp.pe_initial_state(grid, device=CPU)
        args = _rk4_padded_args(s, halo=(4, 4), dt=1.0)
        assert args[7] == Rk4Layout(*want)


class TestStepper:
    @pytest.mark.parametrize("whole_step,name", [
        (True, "pe_rk4_kernel_fused"), (False, "pe_rk4_kernel")],
        ids=["whole_step", "stages"])
    def test_one_step_matches_pallas_stepper(self, whole_step, name):
        jg = JGrid(nx=128, ny=32, levels=4, dx=1e5, dy=1e5)
        js = jp.pe_initial_state(jg, u_jet=10.0, perturb=0.5)
        _, want = make_pe_pallas_rk4_stepper(jg, JPARAMS, dt=30.0,
                                             interpret=True).step((), js,
                                                                  None)
        st = make_pe_kernel_rk4_stepper(grid_from_jax_fields(jg),
                                        params_from_jax_fields(JPARAMS), 30.0,
                                        whole_step=whole_step)
        assert st.name == name
        ts = pe_state_from_numpy(js, CPU)
        _, got = st.step(st.init(ts), ts, None)
        _assert_fields(got, want, 1e-5, 1e-4)

    @pytest.mark.parametrize("levels", [4, 20, 40, 87, 88, 227, 689])
    def test_auto_choice_is_the_stage_path(self, levels):
        """The default takes the four stage launches at every L: the
        H100 timed the whole-step kernel slower at every L timed."""
        grid = GridSpec(nx=16, ny=12, levels=levels, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        assert make_pe_kernel_rk4_stepper(grid, params, 30.0).name == \
            "pe_rk4_kernel"
        if pe_rk4_kernel_fits(levels):
            assert make_pe_kernel_rk4_stepper(
                grid, params, 30.0, whole_step=True).name == \
                "pe_rk4_kernel_fused"

    @pytest.mark.parametrize("whole_step", [True, False],
                             ids=["whole_step", "stages"])
    def test_stepper_reuses_its_buffers(self, whole_step):
        grid = GridSpec(nx=16, ny=12, levels=3, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s0 = tp.pe_initial_state(grid, device=CPU, u_jet=8.0, perturb=0.5)
        keep = s0.map(torch.clone)
        st = make_pe_kernel_rk4_stepper(grid, params, 30.0,
                                        whole_step=whole_step)
        carry = st.init(s0)
        spares = {t.data_ptr() for sp in carry if isinstance(sp, tp.PEState)
                  for _, t in sp.items()}
        carry, s1 = st.step(carry, s0, None)
        assert {t.data_ptr() for _, t in s1.items()} <= spares
        carry, s2 = st.step(carry, s1, None)
        # s0's buffers became a spare and hold s2 now: nothing new
        s0_bufs = {t.data_ptr() for _, t in s0.items()}
        assert {t.data_ptr() for _, t in s2.items()} <= spares | s0_bufs
        ref = make_pe_kernel_rk4_stepper(grid, params, 30.0,
                                         whole_step=whole_step)
        rc = ref.init(keep)
        rc, r1 = ref.step(rc, keep.map(torch.clone), None)
        rc, r2 = ref.step(rc, r1, None)
        for name in FIELDS:
            assert torch.equal(getattr(s2, name), getattr(r2, name)), name


def _pe_cfg(**kw):
    base = dict(model="primitive", grid_width=48, grid_height=48,
                num_levels=4, dx=1e5, dy=1e5, dt=30.0, coriolis_f=1e-4,
                device=CPU)
    base.update(kw)
    return SimConfig(**base)


class TestSimulation:
    @pytest.mark.parametrize("backend", ["kernel", "plain"])
    def test_matches_port_oracle_200_steps(self, backend):
        sim = Simulation.from_config(_pe_cfg(backend=backend), "baroclinic",
                                     u_jet=10.0, perturb=0.5)
        assert sim.stepper.name == {"kernel": "pe_rk4_kernel",
                                    "plain": "rk4"}[backend]
        s0 = tuple(sim.state.to_numpy()[n].copy() for n in FIELDS)
        sim.step(200)
        ref = t_oracle.PEOracle(dx=1e5, dy=1e5, bc="periodic",
                                coriolis_f=1e-4).run(s0, 30.0, 200)
        for name, r in zip(FIELDS, ref):
            a = getattr(sim.state, name).numpy()
            assert np.isfinite(a).all(), name
            scale = np.abs(r).max() + 1e-30
            np.testing.assert_allclose(a / scale, r / scale, rtol=0,
                                       atol=1e-3, err_msg=name)

    def test_rk4_oracle_1000_steps(self):
        """BASELINE.md's bar for the PE core (tests/test_weather_primitive.py
        :73-97): the kernel backend (the plain version of the stepper the
        auto rule takes, on the CPU) against the NumPy oracle after 1000
        RK4 steps, per-field normalised atol 1e-3."""
        sim = Simulation.from_config(_pe_cfg(backend="kernel"), "baroclinic",
                                     u_jet=10.0, perturb=0.5)
        s0 = tuple(sim.state.to_numpy()[n].copy() for n in FIELDS)
        sim.step(1000)
        ref = t_oracle.PEOracle(dx=1e5, dy=1e5, bc="periodic",
                                coriolis_f=1e-4).run(s0, 30.0, 1000)
        for name, r in zip(FIELDS, ref):
            a = getattr(sim.state, name).numpy()
            assert np.isfinite(a).all(), name
            scale = np.abs(r).max() + 1e-30
            np.testing.assert_allclose(a / scale, r / scale, rtol=0,
                                       atol=1e-3, err_msg=name)

    def test_mass_conserved_50_steps(self):
        sim = Simulation.from_config(_pe_cfg(backend="kernel", grid_height=32,
                                             num_levels=5),
                                     "baroclinic", perturb=0.5)
        m0 = float(sim.state.ps.double().sum())
        sim.step(50)
        m1 = float(sim.state.ps.double().sum())
        assert abs(m1 - m0) / m0 < 1e-5

    def test_terrain_kernel_matches_plain(self):
        phi_s = _mountain(32, 48, 1000.0)
        kw = dict(u_jet=6.0, perturb=0.3, orography=phi_s)
        sk = Simulation.from_config(_pe_cfg(backend="kernel",
                                            grid_height=32, num_levels=3,
                                            dt=20.0), "baroclinic", **kw)
        sp = Simulation.from_config(_pe_cfg(backend="plain", grid_height=32,
                                            num_levels=3, dt=20.0),
                                    "baroclinic", **kw)
        sk.step(5)
        sp.step(5)
        torch.testing.assert_close(sk.state.ps, sp.state.ps, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(sk.state.u, sp.state.u, rtol=1e-4,
                                   atol=1e-4)
        assert float(sk.state.v.abs().max()) > 0.0

    def test_auto_on_cpu_uses_plain_integrators(self):
        sim = Simulation.from_config(_pe_cfg(grid_width=16, grid_height=16),
                                     "baroclinic")
        assert sim.stepper.name == "rk4"
        assert sim.metrics.grid_points == 256

    def test_resting_ic_and_snapshots(self):
        sim = Simulation.from_config(_pe_cfg(grid_width=16, grid_height=16,
                                             backend="kernel"), "resting")
        sim.run(4, output_interval=2)
        assert set(sim.snapshots[0]) >= set(FIELDS)
        assert float(sim.state.u.abs().max()) < 1e-6

    @pytest.mark.parametrize("cfg_kw,ic,exc,match", [
        ({"num_levels": 1}, "baroclinic", ValueError, "2 sigma levels"),
        ({}, "vortex", ValueError, "unknown PE initial condition"),
        ({"backend": "kernel", "viscosity": 1.0}, "baroclinic", ValueError,
         "backend='kernel' requires"),
        ({"backend": "kernel", "boundary_condition": "outflow"}, "baroclinic",
         ValueError, "backend='kernel' requires"),
        ({"integration_method": "semi_implicit",
          "boundary_condition": "clamped"}, "baroclinic",
         NotImplementedError, "periodic boundaries"),
        ({"integration_method": "semi_implicit", "si_order": 3},
         "baroclinic", ValueError, "order must be 1 or 2"),
        ({"integration_method": "semi_implicit", "backend": "kernel"},
         "baroclinic", ValueError, "backend='kernel' requires"),
    ])
    def test_bad_configs_raise(self, cfg_kw, ic, exc, match):
        with pytest.raises(exc, match=match):
            Simulation.from_config(_pe_cfg(grid_width=16, grid_height=16,
                                           **cfg_kw), ic)

    def test_default_device_refuses_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Simulation.from_config(SimConfig(model="primitive",
                                             num_levels=4), "baroclinic")


class TestOracleCopy:
    """The port's NumPy oracles are copies of the JAX package's."""

    @pytest.mark.parametrize("bc", ["periodic", "clamped", "outflow",
                                    "reflective"])
    def test_tendencies_equal_jax_oracle(self, bc):
        jg = JGrid(nx=24, ny=16, levels=3, dx=1e5, dy=1e5)
        js, _ = _jax_state(jg, u_jet=12.0, perturb=1.0)
        args = tuple(np.asarray(getattr(js, n)) for n in FIELDS)
        kw = dict(dx=1e5, dy=1e5, bc=bc, coriolis_f=1e-4,
                  phi_s=_mountain(16, 24) if bc == "periodic" else None)
        for a, b in zip(t_oracle.pe_tendencies_np(*args, **kw),
                        j_oracle.pe_tendencies_np(*args, **kw)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)

    def test_oracle_run_equals_jax_oracle(self):
        jg = JGrid(nx=16, ny=12, levels=3, dx=1e5, dy=1e5)
        js, _ = _jax_state(jg, u_jet=8.0, perturb=0.5)
        s0 = tuple(np.asarray(getattr(js, n)) for n in FIELDS)
        kw = dict(dx=1e5, dy=1e5, coriolis_f=1e-4)
        for a, b in zip(t_oracle.PEOracle(**kw).run(s0, 30.0, 3),
                        j_oracle.PEOracle(**kw).run(s0, 30.0, 3)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


class TestConvert:
    def test_state_round_trip_from_jax_object(self):
        jg = JGrid(nx=12, ny=10, levels=3)
        js = jp.pe_initial_state(jg, perturb=0.5)
        ts = pe_state_from_numpy(js, CPU)
        back = pe_state_to_numpy(ts)
        assert list(back) == list(FIELDS)
        for name in FIELDS:
            np.testing.assert_array_equal(back[name],
                                          np.asarray(getattr(js, name)))
        # and from a plain dict of arrays
        again = pe_state_from_numpy(back, CPU)
        assert torch.equal(again.T, ts.T) and again.T.is_contiguous()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


class TestCLI:
    @pytest.mark.parametrize("extra", [[], ["--mountain-height", "1000"],
                                       ["--backend", "kernel"]],
                             ids=["flat", "mountain", "kernel"])
    def test_json_run(self, extra):
        rc, out = _cli(["--device", "cpu", "--model", "primitive",
                        "--levels", "3", "--width", "24", "--height", "16",
                        "--dx", "1e5", "--dy", "1e5", "--dt", "30",
                        "--coriolis", "1e-4", "--steps", "4", "--json",
                        *extra])
        assert rc == 0
        m = json.loads(out.strip().splitlines()[-1])
        assert m["num_steps"] == 3 and m["grid_points_per_second"] > 0

    def test_output_npz_holds_pe_fields(self, tmp_path):
        path = tmp_path / "pe.npz"
        rc, _ = _cli(["--device", "cpu", "--model", "primitive", "--levels",
                      "3", "--width", "16", "--height", "16", "--dx", "1e5",
                      "--dy", "1e5", "--dt", "30", "--steps", "3",
                      "--output", str(path)])
        assert rc == 0
        with np.load(path) as z:
            assert {f"final_{n}" for n in FIELDS} <= set(z)
            assert z["final_T"].shape == (3, 16, 16)
            assert np.isfinite(z["final_ps"]).all()
