"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device (the kernels have no CPU mode): they carry
the ``cuda`` marker and skip without one. They import torch and the port
only, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu_torch.ops.baro_stencil import (  # noqa: E402
    baro_stage, baro_stage_cuda, baro_stage_plain,
)
from njw_tpu_torch.ops.pe_stencil import (  # noqa: E402
    make_pe_kernel_rk4_stepper, pe_rk4_step, pe_rk4_step_cuda,
    pe_rk4_step_plain, pe_stage, pe_stage_cuda, pe_stage_plain,
)
from njw_tpu_torch.ops.stencil import (  # noqa: E402
    SweLayout, swe_kernel_attributes, swe_layout,
    swe_rk4_multistep, swe_rk4_multistep_cuda, swe_rk4_multistep_plain,
    swe_rk4_step, swe_rk4_step_cuda, swe_rk4_step_plain,
)
from njw_tpu_torch.signal import FIRFilter, fir_batch_bf16  # noqa: E402
from njw_tpu_torch.signal.fir_cuda import (  # noqa: E402
    fir_band_bf16_cuda, fir_band_bf16_plain, fir_band_cuda, fir_band_plain,
    fir_batch_lanes, fir_kernel_attributes, fir_layout,
)
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, PhysicsParams, SimConfig, Simulation,
)
from njw_tpu_torch.weather.primitive import PEState  # noqa: E402


def _fields(ny, nx, seed=0, amp=0.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            rng.uniform(-amp, amp, (ny, nx)).astype(np.float32),
            (10.0 + rng.uniform(-amp, amp, (ny, nx))).astype(np.float32))


def _torch(fields, device):
    return tuple(torch.from_numpy(f.copy()).to(device) for f in fields)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


_TILE = swe_layout(1)   # the rule's output tile (tx, ty)


@pytest.mark.cuda
class TestKernelOnCard:
    # and around the rule's tile: one point over and under it in each axis,
    # tiny, ragged and full-size grids
    @pytest.mark.parametrize("ny,nx,nu", [
        (256, 256, 0.0), (200, 328, 0.02), (3, 5, 0.0), (33, 65, 0.0),
        (_TILE.ty + 1, _TILE.tx + 1, 0.0), (_TILE.ty - 1, _TILE.tx - 1, 0.02),
        (_TILE.ty + 1, _TILE.tx - 1, 0.02), (_TILE.ty - 1, _TILE.tx + 1, 0.0),
        (3, 3, 0.0), (3, 3, 0.02), (5, 7, 0.0), (5, 7, 0.02),
        (1000, 1500, 0.0), (1000, 1500, 0.02), (2048, 2048, 0.0),
        (2048, 2048, 0.02)])
    def test_kernel_matches_plain_version(self, cuda_device, ny, nx, nu):
        grid = GridSpec(nx=nx, ny=ny)
        f = _torch(_fields(ny, nx, seed=nx), cuda_device)
        kw = dict(grid=grid, dt=0.01, coriolis_f=1e-4, viscosity=nu)
        before = swe_rk4_step_cuda.launches
        out = swe_rk4_step(*f, **kw)
        ref = swe_rk4_step_plain(*f, **kw)
        torch.cuda.synchronize()
        assert swe_rk4_step_cuda.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("form", [
        {}, {"bf16": True}, {"n_steps": 2}, {"padded": (1, 0)},
        {"padded": (1, 1)}], ids=["k1", "bf16", "k2", "padded", "padded2d"])
    def test_swe_layout_rule_matches_the_built_kernel(self, cuda_device,
                                                      form):
        n = form.get("n_steps", 1)
        lay = swe_layout(n, form.get("bf16", False))
        a = swe_kernel_attributes(index=cuda_device.index or 0, **form)
        assert SweLayout(**a["layout"]) == lay
        assert a["smem_bytes"] == lay.smem_bytes(n)
        assert a["threads"] == lay.threads(n)
        assert a["static_smem_bytes"] == 0
        assert a["blocks_per_sm"] >= lay.blocks
        assert a["registers"] * a["threads"] * lay.blocks <= 65536
        assert a["local_bytes"] == 0   # the rule's layout does not spill

    def test_simulation_kernel_vs_plain(self, cuda_device):
        cfg = SimConfig(grid_width=128, grid_height=96, dt=0.01,
                        coriolis_f=1e-4, device="cuda")
        ker = Simulation.from_config(cfg, "vortex", strength=2.0)
        ref = Simulation.from_config(SimConfig(
            grid_width=128, grid_height=96, dt=0.01, coriolis_f=1e-4,
            device="cuda", backend="plain"), "vortex", strength=2.0)
        assert ker.stepper.name == "rk4_kernel" and ref.stepper.name == "rk4"
        ker.step(12)
        ref.step(12)
        torch.testing.assert_close(ker.state.h, ref.state.h, rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.cuda
class TestVariantKernelsOnCard:
    """The bf16 instantiation (K1-bf16) and the multistep kernel (K2)."""

    @pytest.mark.parametrize("ny,nx,nu", [(256, 256, 0.0), (200, 328, 0.02),
                                          (5, 7, 0.0), (33, 65, 0.01)])
    def test_bf16_kernel_matches_plain_version(self, cuda_device, ny, nx,
                                               nu):
        """Within 1e-3 max|h| per step (1/20 of the JAX band); its RMS
        distance from the plain version at most 3e-4 of the float32
        kernel's (sound on an H100: <= 1.1e-4 on these cases; one
        product-difference contracted into fma.bf16: >= 3.6e-4); and
        unlike the float32 kernel."""
        grid = GridSpec(nx=nx, ny=ny)
        f = _torch(_fields(ny, nx, seed=nx + 1), cuda_device)
        kw = dict(grid=grid, dt=0.01, coriolis_f=1e-4, viscosity=nu)
        before = (swe_rk4_step_cuda.bf16_launches,
                  swe_rk4_step_cuda.launches)
        out = swe_rk4_step(*f, variant="bf16", **kw)
        ref = swe_rk4_step_plain(*f, variant="bf16", **kw)
        f32 = swe_rk4_step(*f, **kw)
        torch.cuda.synchronize()
        assert (swe_rk4_step_cuda.bf16_launches,
                swe_rk4_step_cuda.launches) == (before[0] + 1, before[1] + 1)
        scale = float(ref[2].abs().max())
        assert max(float((a - b).abs().max()) for a, b in zip(out, ref)) \
            <= 1e-3 * scale

        def rms(a, b):
            return max(float((x.double() - y.double()).pow(2).mean().sqrt())
                       for x, y in zip(a, b))

        assert rms(out, ref) <= 3e-4 * rms(f32, ref)
        assert float((out[2] - f32[2]).abs().max()) > 0

    # and one point over K2's tile in y, one under two tiles in x
    @pytest.mark.parametrize("ny,nx", [
        (256, 256), (200, 328), (5, 7), (33, 65),
        (swe_layout(2).ty + 1, 2 * swe_layout(2).tx - 1)])
    def test_two_step_kernel_equals_two_launches(self, cuda_device, ny, nx):
        grid = GridSpec(nx=nx, ny=ny, dx=1.3)
        f = _torch(_fields(ny, nx, seed=ny + 2), cuda_device)
        kw = dict(grid=grid, dt=0.01, coriolis_f=1e-4)
        before = swe_rk4_multistep_cuda.launches
        two = swe_rk4_multistep(*f, n_fused=2, **kw)
        one = swe_rk4_multistep(*f, n_fused=1, **kw)
        torch.cuda.synchronize()
        assert swe_rk4_multistep_cuda.launches == before + 2
        ref = swe_rk4_step_cuda(*swe_rk4_step_cuda(*f, **kw), **kw)
        assert all(torch.equal(a, b) for a, b in zip(two, ref))
        assert all(torch.equal(a, b) for a, b in
                   zip(one, swe_rk4_step_cuda(*f, **kw)))
        for n, got in ((1, one), (2, two)):
            plain = swe_rk4_multistep_plain(*f, n_fused=n, **kw)
            for a, b in zip(got, plain):
                torch.testing.assert_close(a, b, rtol=n * 1e-5,
                                           atol=n * 1e-6)

    @pytest.mark.parametrize("model", ["shallow_water", "primitive"])
    def test_semi_implicit_on_card_matches_cpu(self, cuda_device, model):
        """cuFFT and the card's matmuls against the port on the CPU."""
        if model == "primitive":
            cfg = dict(model=model, grid_width=64, grid_height=48,
                       num_levels=4, dx=1e5, dy=1e5, dt=450.0,
                       coriolis_f=1e-4, integration_method="semi_implicit",
                       si_order=2)
            ic, ic_kw = "baroclinic", {"u_jet": 8.0}
        else:
            cfg = dict(grid_width=128, grid_height=96, dt=0.25,
                       coriolis_f=1e-4, viscosity=1e-3,
                       integration_method="semi_implicit", si_order=2)
            ic, ic_kw = "jet_stream", {"strength": 2.0}
        card = Simulation.from_config(SimConfig(device="cuda", **cfg), ic,
                                      **ic_kw)
        host = Simulation.from_config(SimConfig(device="cpu", **cfg), ic,
                                      **ic_kw)
        card.step(10)
        host.step(10)
        for (name, a), (_, b) in zip(card.state.items(), host.state.items()):
            scale = float(b.abs().max()) + 1e-30
            if name in ("u", "v"):
                scale = max(float(host.state.u.abs().max()),
                            float(host.state.v.abs().max()))
            assert float((a.cpu() - b).abs().max()) / scale <= 1e-4, name


def _pe_state(L, ny, nx, seed, device):
    rng = np.random.default_rng(seed)

    def f(lo, hi, *shape):
        return torch.from_numpy(
            rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    return PEState(u=f(-10, 10, L, ny, nx), v=f(-10, 10, L, ny, nx),
                   T=f(250, 300, L, ny, nx), q=f(0, 0.01, L, ny, nx),
                   ps=f(990, 1020, ny, nx))


@pytest.mark.cuda
class TestStageKernelsOnCard:
    @pytest.mark.parametrize("ny,nx,beta,nu", [
        (1024, 1024, 1e-3, 1e-4), (200, 328, 0.3, 0.02), (3, 5, 0.0, 0.0),
        (33, 65, 0.0, 0.0)])
    def test_baro_kernel_matches_plain_version(self, cuda_device, ny, nx,
                                               beta, nu):
        grid = GridSpec(nx=nx, ny=ny, dy=1.3)
        psi, z, base = _torch(_fields(ny, nx, seed=ny), cuda_device)
        kw = dict(grid=grid, c_dt=0.7, beta=beta, nu=nu)
        before = baro_stage_cuda.launches
        out = baro_stage(psi, z, base, **kw)
        ref = baro_stage_plain(psi, z, base, **kw)
        torch.cuda.synchronize()
        assert baro_stage_cuda.launches == before + 1
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("L,ny,nx,nbase,terrain", [
        (20, 128, 96, 1, False), (5, 200, 328, 4, False), (2, 3, 5, 1, False),
        (4, 64, 48, 1, True), (5, 200, 328, 4, True)])
    def test_pe_kernel_matches_plain_version(self, cuda_device, L, ny, nx,
                                             nbase, terrain):
        grid = GridSpec(nx=nx, ny=ny, levels=L, dx=1e5, dy=1e5)
        cur = _pe_state(L, ny, nx, 0, cuda_device)
        bases = [_pe_state(L, ny, nx, g + 1, cuda_device)
                 for g in range(nbase)]
        coeffs = (1.0,) if nbase == 1 else (-1 / 3, 1 / 3, 2 / 3, 1 / 3)
        phi_s = (torch.rand(ny, nx, device=cuda_device) * 5000.0
                 if terrain else None)
        kw = dict(grid=grid, c_dt=60.0, coriolis_f=1e-4, base_coeffs=coeffs,
                  phi_s=phi_s)
        before = pe_stage_cuda.launches
        out = pe_stage(cur, bases, **kw)
        ref = pe_stage_plain(cur, bases, **kw)
        torch.cuda.synchronize()
        assert pe_stage_cuda.launches == before + 1
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=2e-4 if terrain else 1e-4,
                                       msg=name)

    # every strip K3 builds (an index of BARO_STRIPS; the 4-column ones
    # need nx % 4 == 0) on grids under one strip (3 x 5, 33 x 65), ragged
    # in both axes (37 x 131, 1000 x 1024 against 4-row strips) and square
    @pytest.mark.parametrize("ny,nx", [(3, 5), (33, 65), (37, 131), (5, 8),
                                       (1000, 1024), (130, 260)])
    @pytest.mark.parametrize("strip", range(2))
    def test_baro_strips_match_plain_version(self, cuda_device, ny, nx,
                                             strip):
        from njw_tpu_torch.ops import baro_stencil as bs

        cols, _ = bs.BARO_STRIPS[strip]
        if cols == 4 and nx % 4:
            pytest.skip("4 columns a lane need nx % 4 == 0")
        grid = GridSpec(nx=nx, ny=ny, dx=0.9, dy=1.3)
        psi, z, base = _torch(_fields(ny, nx, seed=ny + nx), cuda_device)
        k = bs.baro_constants(grid, 0.7, 0.3, 0.02)
        out = torch.full_like(z, float("nan"))
        bs._launch(psi, z, base, out, grid, k, strip)
        ref = baro_stage_plain(psi, z, base, grid=grid, c_dt=0.7, beta=0.3,
                               nu=0.02)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        # each strip computes the rule's bits
        rule = torch.empty_like(z)
        bs._launch(psi, z, base, rule, grid, k)
        assert torch.equal(out, rule)

    # dx = dy = 1 (the main path's spacing) takes an instantiation without
    # the divisions by dx^2 and dy^2; fields with subnormal far fields, as
    # a decayed vortex has
    @pytest.mark.parametrize("ny,nx", [(64, 128), (37, 131)])
    def test_baro_unit_spacing_matches_plain_version(self, cuda_device, ny,
                                                     nx):
        grid = GridSpec(nx=nx, ny=ny)
        psi, z, base = _torch(_fields(ny, nx, seed=ny), cuda_device)
        z[:, : nx // 2] *= 1e-40
        base[:, : nx // 2] *= 1e-40
        kw = dict(grid=grid, c_dt=0.7, beta=0.3, nu=0.02)
        out = baro_stage(psi, z, base, **kw)
        ref = baro_stage_plain(psi, z, base, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)

    def test_baro_strip_rule_matches_the_built_kernel(self, cuda_device):
        from njw_tpu_torch.ops import baro_stencil as bs

        for i, (cols, rows) in enumerate(bs.BARO_STRIPS):
            for unit in (False, True):
                a = bs.baro_kernel_attributes(i, unit=unit)
                assert (a["columns_per_lane"], a["rows_per_warp"]) == (
                    cols, rows)
                assert a["local_bytes"] == 0 and a["blocks_per_sm"] >= 1
        assert bs.BARO_STRIPS[bs.baro_strip(1024)] == (4, 4)
        assert bs.BARO_STRIPS[bs.baro_strip(1026)] == (1, 4)

    # K5 at every tile height it builds (0: the rule's), on grids ragged
    # against the 64-column tile and each height, with terrain, 1 and 4
    # bases, rows 16-byte aligned (nx % 4 == 0) and not; the reach
    # (L = 454, 1-row tiles) on a small grid
    @pytest.mark.parametrize("L,ny,nx,nbase,terrain,rows", [
        (40, 37, 50, 1, True, 0), (40, 37, 50, 4, False, 4),
        (40, 37, 50, 1, False, 2), (20, 9, 100, 4, True, 4),
        (3, 3, 5, 1, False, 0), (7, 70, 33, 4, True, 1),
        (6, 13, 200, 1, True, 0), (6, 13, 200, 4, False, 1),
        (6, 7, 131, 1, False, 2), (8, 5, 256, 4, True, 0),
        (41, 11, 40, 1, False, 0), (193, 11, 72, 4, True, 0),
        (454, 5, 37, 1, False, 0), (454, 5, 70, 4, True, 0)])
    def test_pe_stage_tiles_match_plain_version(self, cuda_device, L, ny,
                                                nx, nbase, terrain, rows):
        from njw_tpu_torch.ops import pe_stencil as ps

        grid = GridSpec(nx=nx, ny=ny, levels=L, dx=1e5, dy=1e5)
        cur = _pe_state(L, ny, nx, 0, cuda_device)
        bases = tuple(_pe_state(L, ny, nx, g + 1, cuda_device)
                      for g in range(nbase))
        coeffs = (1.0,) if nbase == 1 else (-1 / 3, 1 / 3, 2 / 3, 1 / 3)
        phi_s = (torch.rand(ny, nx, device=cuda_device) * 5000.0
                 if terrain else None)
        k = ps.column_constants(grid, 1e-4)
        levc = ps.level_constants(L, "cuda")
        out = cur.map(lambda a: torch.full_like(a, float("nan")))
        ps._launch_stage(cur, bases, tuple(ps._f32(c) for c in coeffs), out,
                         phi_s, grid, k, ps._f32(60.0), levc,
                         tile_rows=rows)
        ref = pe_stage_plain(cur, bases, grid=grid, c_dt=60.0,
                             coriolis_f=1e-4, base_coeffs=coeffs,
                             phi_s=phi_s)
        torch.cuda.synchronize()
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=2e-4 if terrain else 1e-4,
                                       msg=name)
        # every height computes the rule's bits
        rule = pe_stage_cuda(cur, bases, grid=grid, c_dt=60.0,
                             coriolis_f=1e-4, base_coeffs=coeffs,
                             phi_s=phi_s)
        for (name, a), (_, b) in zip(out.items(), rule.items()):
            assert torch.equal(a, b), name

    def test_pe_stage_rule_matches_the_built_kernel(self, cuda_device):
        from njw_tpu_torch.ops import pe_stencil as ps

        for L in (2, 20, 40, 41, 80, 193, 232, 454):
            for nbase in (1, 4):
                a = ps.stage_kernel_attributes(L, nbase=nbase)
                rows = ps.stage_tile_rows(L)
                assert a["tile"] == [rows, 64], L
                assert a["smem_bytes"] == ps.stage_smem_bytes(rows, L), L
                assert a["threads"] == 64 * rows and a["local_bytes"] == 0
                assert a["blocks_per_sm"] >= 1, L
        with pytest.raises(RuntimeError):
            ps.stage_kernel_attributes(455)

    # layout None: the rule's (rk4_layout: one block, tile 8 up to L = 21;
    # a cluster of two at L = 40; eight blocks past L = 84, tile 1 at the
    # limit L = 688); others as (blocks per cluster, tile); ragged tiles in
    # both axes
    @pytest.mark.parametrize("L,ny,nx,terrain,layout", [
        (20, 128, 96, False, None), (5, 200, 328, True, None),
        (2, 3, 5, False, None), (4, 64, 48, True, (1, 3)),
        (6, 70, 90, False, (1, 16)), (20, 33, 47, True, (1, 5)),
        (40, 37, 50, True, None), (40, 45, 29, False, (1, 3)),
        (87, 11, 13, False, None), (87, 9, 14, True, None),
        (20, 128, 96, False, (2, 8)),
        (20, 33, 47, True, (2, 8)),
        (20, 40, 36, True, (4, 8)),
        (40, 37, 50, True, (4, 5)),
        (40, 29, 45, False, (8, 8)),
        (227, 19, 23, True, None), (688, 11, 9, False, None)])
    def test_pe_rk4_kernel_matches_plain_version(self, cuda_device, L, ny,
                                                 nx, terrain, layout):
        from njw_tpu_torch.ops.pe_stencil import Rk4Layout
        grid = GridSpec(nx=nx, ny=ny, levels=L, dx=1e5, dy=1e5)
        s = _pe_state(L, ny, nx, 7, cuda_device)
        phi_s = (torch.rand(ny, nx, device=cuda_device) * 5000.0
                 if terrain else None)
        kw = dict(grid=grid, dt=60.0, coriolis_f=1e-4, phi_s=phi_s)
        before = pe_rk4_step_cuda.launches
        out = (pe_rk4_step(s, **kw) if layout is None
               else pe_rk4_step_cuda(s, layout=Rk4Layout(*layout), **kw))
        ref = pe_rk4_step_plain(s, **kw)
        torch.cuda.synchronize()
        assert pe_rk4_step_cuda.launches == before + 1
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=2e-4 if terrain else 1e-4,
                                       msg=name)

    @pytest.mark.parametrize("L", [2, 20, 21, 22, 40, 44, 68, 87, 168, 169,
                                   688])
    def test_pe_rk4_shared_memory_rule_matches_the_built_kernel(
            self, cuda_device, L):
        from njw_tpu_torch.ops.pe_stencil import (
            SMEM_PER_BLOCK, rk4_layout, rk4_occupancy, rk4_smem_bytes,
            rk4_smem_bytes_built,
        )
        lay = rk4_layout(L)
        for t, c in ((1, lay.ncta), (lay.tile, lay.ncta),
                     (lay.tile + 1, lay.ncta), (lay.tile, 1)):
            assert rk4_smem_bytes_built(L, t, c) == rk4_smem_bytes(L, t, c)
        assert rk4_smem_bytes(L, lay.tile, lay.ncta) <= SMEM_PER_BLOCK
        blocks, clusters = rk4_occupancy(L, lay, cuda_device.index or 0)
        assert blocks >= 1 and clusters >= 1

    def test_pe_rk4_launch_refuses_a_tile_over_the_shared_memory(
            self, cuda_device):
        from njw_tpu_torch.ops.pe_stencil import Rk4Layout
        grid = GridSpec(nx=16, ny=16, levels=40, dx=1e5, dy=1e5)
        s = _pe_state(40, 16, 16, 1, cuda_device)
        with pytest.raises(ValueError, match="shared memory"):
            pe_rk4_step_cuda(s, grid=grid, dt=60.0, layout=Rk4Layout(1, 5))

    @pytest.mark.parametrize("layout", [(3, 8), (16, 8), (6, 8), (2, 0),
                                        (64, 1)])
    def test_pe_rk4_kernel_refuses_a_bad_layout(self, cuda_device, layout):
        # 3, 16 or 6 blocks a cluster; no tile; more blocks than levels
        from njw_tpu_torch.ops.pe_stencil import Rk4Layout
        L = 40
        grid = GridSpec(nx=16, ny=16, levels=L, dx=1e5, dy=1e5)
        s = _pe_state(L, 16, 16, 1, cuda_device)
        with pytest.raises(RuntimeError, match="invalid argument"):
            pe_rk4_step_cuda(s, grid=grid, dt=60.0,
                             layout=Rk4Layout(*layout))

    def test_pe_stage_stepper_vs_plain(self, cuda_device):
        grid = GridSpec(nx=64, ny=48, levels=4, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s0 = _pe_state(4, 48, 64, 3, cuda_device)
        runs = {}
        for whole_step in (True, False):
            st = make_pe_kernel_rk4_stepper(grid, params, 30.0,
                                            whole_step=whole_step)
            carry, s = st.init(s0), s0.map(torch.clone)
            before = (pe_rk4_step_cuda.launches, pe_stage_cuda.launches)
            for _ in range(12):
                carry, s = st.step(carry, s, None)
            torch.cuda.synchronize()
            runs[whole_step] = s.map(torch.clone)
            launched = (pe_rk4_step_cuda.launches - before[0],
                        pe_stage_cuda.launches - before[1])
            assert launched == ((12, 0) if whole_step else (0, 48))
        for (name, a), (_, b) in zip(runs[False].items(),
                                     runs[True].items()):
            scale = float(b.abs().max()) + 1e-30
            torch.testing.assert_close(a / scale, b / scale, rtol=0,
                                       atol=1e-5, msg=name)

    @pytest.mark.parametrize("model,cfg_kw,ic_kw,stepper", [
        ("barotropic", dict(grid_width=128, grid_height=96, dt=0.01,
                            beta=1e-3, viscosity=1e-4),
         {"strength": 3.0}, "baro_rk4_kernel"),
        ("primitive", dict(grid_width=64, grid_height=48, num_levels=4,
                           dx=1e5, dy=1e5, dt=30.0, coriolis_f=1e-4),
         {"u_jet": 5.0, "perturb": 0.5}, "pe_rk4_kernel"),
    ])
    def test_simulation_kernel_vs_plain(self, cuda_device, model, cfg_kw,
                                        ic_kw, stepper):
        ic = "vortex" if model == "barotropic" else "baroclinic"
        ker = Simulation.from_config(SimConfig(model=model, device="cuda",
                                               **cfg_kw), ic, **ic_kw)
        ref = Simulation.from_config(SimConfig(model=model, device="cuda",
                                               backend="plain", **cfg_kw),
                                     ic, **ic_kw)
        assert ker.stepper.name == stepper and ref.stepper.name == "rk4"
        counter, per_step = ((baro_stage_cuda, 4) if model == "barotropic"
                             else (pe_stage_cuda, 4))
        before = counter.launches
        ker.step(12)
        ref.step(12)
        assert counter.launches == before + per_step * 12
        for (name, a), (_, b) in zip(ker.state.items(), ref.state.items()):
            scale = float(b.abs().max()) + 1e-30
            torch.testing.assert_close(a / scale, b / scale, rtol=0,
                                       atol=1e-3, msg=name)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each element of ``t``."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


# bf16 outputs agree within one bf16 ulp of the rounding, plus the float32
# summation-order spread of the sums before it (where a sum cancels to
# near zero, that spread is larger than the ulp of the result)
BF16_SUM_ATOL = 1e-5


@pytest.mark.cuda
class TestFIRKernelsOnCard:
    # ragged last frames, one-row and one-sample rows, rows whose length
    # is no multiple of 4 (scalar loads and stores), the band's extremes
    @pytest.mark.parametrize("shape,k", [
        ((3, 1000), 101), ((9, 4096), 101), ((2, 300), 101), ((5, 1280), 101),
        ((1, 1), 101), ((17, 8193), 128), ((4, 9000), 1), ((2, 70000), 16)])
    @pytest.mark.parametrize("passes", [0, 1, 2, 3, 6])
    def test_fir_band_matches_plain_version(self, cuda_device, shape, k,
                                            passes):
        rng = np.random.default_rng(k + shape[1])
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        taps = rng.standard_normal(k).astype(np.float32) * 0.1
        x = x.to(cuda_device)
        before = fir_band_cuda.launches
        out = fir_batch_lanes(x, taps, passes=passes)
        ref = fir_band_plain(x, taps, passes=passes)
        torch.cuda.synchronize()
        assert fir_band_cuda.launches == before + 1
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        oracle = np.stack([np.convolve(r, taps)[:shape[1]]
                           for r in x.cpu().numpy().astype(np.float64)])
        tol = 2e-4 if passes in (0, 3, 6) else 3e-2
        assert np.abs(out.cpu().numpy() - oracle).max() < tol

    @pytest.mark.parametrize("passes", [0, 3])
    def test_fir_band_never_reads_past_the_rows(self, cuda_device, passes):
        """The rows lie at the start of a NaN-filled buffer: a kernel that
        loaded the ragged last frame's missing samples would turn valid
        outputs NaN (0 * NaN in the band product)."""
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((3, 1000)).astype(
            np.float32)).to(cuda_device)
        taps = rng.standard_normal(101).astype(np.float32) * 0.1
        buf = torch.full((x.numel() + 4096,), float("nan"),
                         device=cuda_device)
        buf[:x.numel()] = x.flatten()
        out = fir_batch_lanes(buf[:x.numel()].view(3, 1000), taps,
                              passes=passes)
        torch.testing.assert_close(out, fir_band_plain(x, taps, passes=passes),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", [(3, 1000), (2, 300), (7, 777),
                                       (9, 4096)])
    @pytest.mark.parametrize("taps_passes", [1, 2])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_fir_band_bf16_matches_plain_version(self, cuda_device, shape,
                                                 taps_passes, out_dtype):
        rng = np.random.default_rng(shape[1])
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        taps = rng.standard_normal(101).astype(np.float32) * 0.1
        xb = x.to(cuda_device, torch.bfloat16)
        before = fir_band_bf16_cuda.launches
        out = fir_batch_bf16(xb, taps, taps_passes=taps_passes,
                             out_dtype=out_dtype)
        ref = fir_band_bf16_plain(xb, taps, taps_passes=taps_passes,
                                  out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert fir_band_bf16_cuda.launches == before + 1
        assert out.dtype == out_dtype
        if out_dtype == torch.bfloat16:
            assert bool(((out.float() - ref.float()).abs()
                         <= _bf16_ulp(ref) + BF16_SUM_ATOL).all())
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)

    # the new design's edges: rows the staging branch takes (n no multiple
    # of 4 or 8), fewer tiles than SMs, a row ending on a tile and ring
    # boundary (two tiles of 64 frames) and one frame past it
    @pytest.mark.parametrize("shape,streamed", [
        ((7, 777), False), ((3, 65537), False), ((1, 10**6), True),
        ((2, 8192), True), ((2, 16384), True), ((2, 16384 + 128), True)])
    @pytest.mark.parametrize("passes", [0, 3])
    def test_fir_band_edges(self, cuda_device, shape, streamed, passes):
        rng = np.random.default_rng(shape[1])
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device)
        taps = rng.standard_normal(101).astype(np.float32) * 0.1
        assert fir_layout(*shape, data_ptr=x.data_ptr()).streamed is streamed
        out = fir_band_cuda(x, taps, passes=passes)
        torch.testing.assert_close(out, fir_band_plain(x, taps, passes=passes),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("k", [1, 16, 128])
    @pytest.mark.parametrize("passes", [0, 3])
    def test_fir_band_tap_counts(self, cuda_device, k, passes):
        rng = np.random.default_rng(k)
        x = torch.from_numpy(rng.standard_normal((3, 20000)).astype(
            np.float32)).to(cuda_device)
        taps = rng.standard_normal(k).astype(np.float32) * 0.1
        torch.testing.assert_close(fir_band_cuda(x, taps, passes=passes),
                                   fir_band_plain(x, taps, passes=passes),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("offset", [1, 4])
    def test_fir_band_row_inside_a_buffer(self, cuda_device, offset):
        """Rows starting 4 (or 16) bytes into a buffer, NaN around them:
        the 4-byte view takes the staging branch, the 16-byte one TMA."""
        rng = np.random.default_rng(offset)
        x = torch.from_numpy(rng.standard_normal((3, 1000)).astype(
            np.float32)).to(cuda_device)
        taps = rng.standard_normal(101).astype(np.float32) * 0.1
        buf = torch.full((x.numel() + 4096,), float("nan"),
                         device=cuda_device)
        buf[offset:offset + x.numel()] = x.flatten()
        view = buf[offset:offset + x.numel()].view(3, 1000)
        assert fir_layout(3, 1000, data_ptr=view.data_ptr()).streamed is (
            offset == 4)
        torch.testing.assert_close(fir_band_cuda(view, taps, passes=3),
                                   fir_band_plain(x, taps, passes=3),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", [(3, 1000), (7, 777), (2, 8200)])
    @pytest.mark.parametrize("offset", [0, 1])
    def test_fir_band_bf16_never_reads_past_the_rows(self, cuda_device, shape,
                                                     offset):
        """bf16 rows (at the buffer's start, or 2 bytes in) in front of
        NaN; no sample at or past n may reach a valid output."""
        rng = np.random.default_rng(shape[1] + offset)
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, torch.bfloat16)
        taps = rng.standard_normal(101).astype(np.float32) * 0.1
        buf = torch.full((x.numel() + 4096,), float("nan"),
                         device=cuda_device, dtype=torch.bfloat16)
        buf[offset:offset + x.numel()] = x.flatten()
        view = buf[offset:offset + x.numel()].view(shape)
        out = fir_band_bf16_cuda(view, taps)
        ref = fir_band_bf16_plain(x, taps)
        assert bool(((out.float() - ref.float()).abs()
                     <= _bf16_ulp(ref) + BF16_SUM_ATOL).all())

    @pytest.mark.parametrize("dtype,passes,out", [
        (torch.float32, 0, None), (torch.float32, 1, None),
        (torch.float32, 2, None), (torch.float32, 3, None),
        (torch.bfloat16, 1, torch.bfloat16), (torch.bfloat16, 2, torch.bfloat16),
        (torch.bfloat16, 1, torch.float32), (torch.bfloat16, 2, torch.float32)])
    def test_fir_layout_matches_the_built_kernel(self, cuda_device, dtype,
                                                 passes, out):
        got = fir_kernel_attributes(dtype, passes, out_dtype=out
                                    or torch.bfloat16)
        lay = fir_layout(1000, 100_000, dtype, passes, out_dtype=out,
                         sms=torch.cuda.get_device_properties(0)
                         .multi_processor_count)
        assert (got["frames"], got["stages"], got["threads"],
                got["smem_bytes"]) == (lay.frames, lay.stages, lay.threads,
                                       lay.smem_bytes)
        assert got["blocks_per_sm"] >= lay.blocks_per_sm

    def test_fir_apply_batch_branch_launches_the_kernel(self, cuda_device):
        x = torch.randn(8, 65536 + 40, device=cuda_device)
        filt = FIRFilter(num_taps=101, cutoff=0.25)
        before = fir_band_cuda.launches
        y = filt(x)
        torch.cuda.synchronize()
        assert fir_band_cuda.launches == before + 1
        torch.testing.assert_close(y, fir_band_plain(x, filt.taps),
                                   rtol=1e-5, atol=1e-5)


def _nan_framed(a: torch.Tensor, halo: tuple, reach: int,
                margin: int = 8) -> torch.Tensor:
    """``a``, a padded block (interior at ``halo``; hx = 0: x whole), as a
    view inside a NaN buffer ``margin`` cells wider on every side, with NaN
    also in each of the block's cells that no interior output depends on:
    those whose distances dy, dx outside the interior have dy + dx >
    ``reach`` (4 for the whole-step kernels, 1 for the stage kernel)."""
    hy, hx = halo
    rows, cols = a.shape[-2:]
    buf = torch.full(a.shape[:-2] + (rows + 2 * margin, cols + 2 * margin),
                     float("nan"), device=a.device)
    view = buf[..., margin:margin + rows, margin:margin + cols]
    view.copy_(a)

    def dist(n, h):
        i = torch.arange(n, device=a.device)
        return torch.clamp(torch.maximum(h - i, i - (n - h - 1)), min=0)

    view.masked_fill_(dist(rows, hy)[:, None] + dist(cols, hx)[None, :]
                      > reach, float("nan"))
    return view


def _padded_pe(L, ly, lx, halo, seed, device):
    hy, hx = halo
    return _pe_state(L, ly + 2 * hy, lx + 2 * hx, seed, device)


@pytest.mark.cuda
class TestShardedKernelsOnCard:
    """The padded launches of K1, K4 and K5 against their plain versions,
    with NaN in every cell the kernel must not read, and each sharded
    stepper on a LocalMesh against the whole-domain kernel path."""

    @pytest.mark.parametrize("form,halo", [
        ("local", (4, 0)), ("carry", (4, 0)), ("local2d", (4, 4)),
        ("local2d", (8, 128)), ("local", (5, 0))])
    @pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
    def test_swe_padded_matches_plain(self, cuda_device, form, halo, nan):
        from njw_tpu_torch.ops.stencil import (
            swe_rk4_step_carry, swe_rk4_step_local, swe_rk4_step_local2d,
            swe_rk4_step_padded,
        )
        hy, hx = halo
        ly, lx = 45, 70
        f = _torch(_fields(ly + 2 * hy, lx + 2 * hx, seed=ly + hx),
                   cuda_device)
        kw = dict(dt=0.01, dx=1.3, dy=0.7, coriolis_f=1e-4, viscosity=0.02)
        ref = swe_rk4_step_padded(*(t.cpu() for t in f), halo=halo, **kw)
        ins = tuple(_nan_framed(t, halo, 4) for t in f) if nan else f
        before = swe_rk4_step_cuda.launches
        if form == "carry":
            out = swe_rk4_step_carry(*ins, hy=hy, **kw)
            out = tuple(o[hy:hy + ly] for o in out)
        elif form == "local":
            out = swe_rk4_step_local(*ins, hy=hy, **kw)
        else:
            out = swe_rk4_step_local2d(*ins, hy=hy, hx=hx, **kw)
        torch.cuda.synchronize()
        assert swe_rk4_step_cuda.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("halo,nbase", [((1, 0), 1), ((1, 1), 4),
                                            ((3, 2), 4)])
    @pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
    def test_pe_stage_padded_matches_plain(self, cuda_device, halo, nbase,
                                           nan):
        from njw_tpu_torch.ops.pe_stencil import pe_stage_padded

        L, ly, lx = 5, 37, 70
        cur = _padded_pe(L, ly, lx, halo, 1, cuda_device)
        bases = [_pe_state(L, ly, lx, 2 + g, cuda_device)
                 for g in range(nbase)]
        coeffs = (1.0,) if nbase == 1 else (-1 / 3, 1 / 3, 2 / 3, 1 / 3)
        kw = dict(halo=halo, c_dt=60.0, dx=1e5, dy=1.2e5, coriolis_f=1e-4,
                  base_coeffs=coeffs)
        ref = pe_stage_padded(cur.map(torch.Tensor.cpu),
                              [b.map(torch.Tensor.cpu) for b in bases], **kw)
        if nan:
            cur = cur.map(lambda a: _nan_framed(a, halo, 1))
        before = pe_stage_cuda.launches
        out = pe_stage_padded(cur, bases, **kw)
        torch.cuda.synchronize()
        assert pe_stage_cuda.launches == before + 1
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4,
                                       msg=name)

    # rows of cur 16-byte aligned (the 16-byte copies: pitch and the
    # interior's first column multiples of 4), whole tiles and ragged ones,
    # at every tile height K5 builds
    @pytest.mark.parametrize("halo,ly,lx,nbase,rows", [
        ((1, 0), 37, 72, 1, 0), ((4, 4), 21, 72, 4, 0),
        ((4, 4), 21, 72, 1, 2), ((2, 0), 9, 96, 4, 4),
        ((1, 1), 19, 64, 1, 1), ((1, 1), 19, 130, 4, 0),
        ((1, 0), 6, 192, 4, 0)])
    @pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
    def test_pe_stage_padded_tiles_match_plain(self, cuda_device, halo, ly,
                                               lx, nbase, rows, nan):
        from njw_tpu_torch.ops import pe_stencil as ps

        L = 6
        cur = _padded_pe(L, ly, lx, halo, 1, cuda_device)
        bases = [_pe_state(L, ly, lx, 2 + g, cuda_device)
                 for g in range(nbase)]
        coeffs = (1.0,) if nbase == 1 else (-1 / 3, 1 / 3, 2 / 3, 1 / 3)
        kw = dict(halo=halo, c_dt=60.0, dx=1e5, dy=1.2e5, coriolis_f=1e-4,
                  base_coeffs=coeffs)
        ref = ps.pe_stage_padded(cur.map(torch.Tensor.cpu),
                                 [b.map(torch.Tensor.cpu) for b in bases],
                                 **kw)
        if nan:
            cur = cur.map(lambda a: _nan_framed(a, halo, 1))
        args = ps._stage_padded_args(cur, bases, **kw)
        before = pe_stage_cuda.launches
        out = ps._launch_stage(*args, tile_rows=rows)
        torch.cuda.synchronize()
        assert pe_stage_cuda.launches == before + 1
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4,
                                       msg=name)

    @pytest.mark.parametrize("form,halo", [
        ("local", (4, 0)), ("carry", (4, 0)), ("local2d", (4, 4)),
        ("carry2d", (4, 4)), ("local2d", (6, 5))])
    @pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
    @pytest.mark.parametrize("L", [4, 40])
    def test_pe_rk4_padded_matches_plain(self, cuda_device, form, halo, nan,
                                         L):
        from njw_tpu_torch.ops.pe_stencil import (
            interior, pe_rk4_carry, pe_rk4_carry2d, pe_rk4_local,
            pe_rk4_local2d, pe_rk4_padded,
        )
        ly, lx = 37, 50
        s = _padded_pe(L, ly, lx, halo, 3, cuda_device)
        kw = dict(dt=60.0, dx=1e5, dy=1.2e5, coriolis_f=1e-4)
        ref = pe_rk4_padded(s.map(torch.Tensor.cpu), halo=halo, **kw)
        if nan:
            s = s.map(lambda a: _nan_framed(a, halo, 4))
        hy, hx = halo
        before = pe_rk4_step_cuda.launches
        if form == "local":
            out = pe_rk4_local(s, hy=hy, **kw)
        elif form == "local2d":
            out = pe_rk4_local2d(s, hy=hy, hx=hx, **kw)
        elif form == "carry":
            out = interior(pe_rk4_carry(s, hy=hy, **kw), halo)
        else:
            out = interior(pe_rk4_carry2d(s, hy=hy, hx=hx, **kw), halo)
        torch.cuda.synchronize()
        assert pe_rk4_step_cuda.launches == before + 1
        for (name, a), (_, b) in zip(out.items(), ref.items()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4,
                                       msg=name)

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2), (3, 2)])
    def test_swe_stepper_matches_whole_domain(self, cuda_device, shape):
        from njw_tpu_torch.parallel import LocalMesh, sharded_swe_step_kernel

        cfg = SimConfig(grid_width=96, grid_height=48, dt=0.01,
                        coriolis_f=1e-4, device="cuda")
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        mesh = LocalMesh(*shape)
        shards = mesh.shard_state(sim.state)
        step = sharded_swe_step_kernel(cfg.grid_spec(), cfg.physics(), mesh,
                                       dt=cfg.dt, n_steps=3)
        before = swe_rk4_step_cuda.launches
        got = mesh.gather_state(step(shards))
        torch.cuda.synchronize()
        assert swe_rk4_step_cuda.launches == before + 3 * mesh.size
        sim.step(3)
        for (name, a), (_, b) in zip(got.items(), sim.state.items()):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)

    @pytest.mark.parametrize("ctor,shape,kw,counter,per_step", [
        ("sharded_pe_step_kernel_fused", (4, 1), {}, "rk4", 1),
        ("sharded_pe_step_kernel_fused", (2, 2), {}, "rk4", 1),
        ("sharded_pe_step_kernel_fused_2d", (2, 2), {"carry": True}, "rk4",
         1),
        ("sharded_pe_step_kernel", (4, 1), {}, "stage", 4),
        ("sharded_pe_step_kernel", (2, 2), {}, "stage", 4)])
    def test_pe_stepper_matches_whole_domain(self, cuda_device, ctor, shape,
                                             kw, counter, per_step):
        from njw_tpu_torch import parallel
        from njw_tpu_torch.weather.primitive import pe_initial_state

        grid = GridSpec(nx=64, ny=48, levels=4, dx=1e5, dy=1e5)
        params = PhysicsParams(coriolis_f=1e-4)
        s0 = pe_initial_state(grid, device="cuda", u_jet=15.0, perturb=0.5)
        mesh = parallel.LocalMesh(*shape)
        step = getattr(parallel, ctor)(grid, params, mesh, dt=30.0,
                                       n_steps=3, **kw)
        wrapper = pe_rk4_step_cuda if counter == "rk4" else pe_stage_cuda
        before = wrapper.launches
        got = mesh.gather_state(step(mesh.shard_state(s0)))
        torch.cuda.synchronize()
        assert wrapper.launches == before + 3 * per_step * mesh.size
        ref = make_pe_kernel_rk4_stepper(grid, params, 30.0,
                                         whole_step=counter == "rk4")
        s = s0.map(torch.clone)
        carry = ref.init(s)
        for _ in range(3):
            carry, s = ref.step(carry, s, None)
        for (name, a), (_, b) in zip(got.items(), s.items()):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4, msg=name)


@pytest.mark.cuda
class TestPlainShardedOnCard:
    """The plain sharded steppers on a LocalMesh on the card against the
    whole-domain plain run on the card (the JAX sharded tests'
    tolerances; the SWE overlap form equal to the padded form bit for bit),
    with no kernel launched; and the config-5 mesh sweep on K4."""

    def _counts(self):
        return (swe_rk4_step_cuda.launches, baro_stage_cuda.launches,
                pe_stage_cuda.launches, pe_rk4_step_cuda.launches)

    @pytest.mark.parametrize("shape,bc", [((2, 2), "reflective"),
                                          ((4, 1), "periodic")])
    def test_swe_matches_whole_domain(self, cuda_device, shape, bc):
        from njw_tpu_torch.parallel import LocalMesh, sharded_swe_step

        cfg = SimConfig(grid_width=128, grid_height=96, dt=0.01,
                        coriolis_f=1e-4, beta=0.5, boundary_condition=bc,
                        backend="plain")
        sim = Simulation.from_config(cfg, "vortex", strength=2.0)
        s0 = sim.state
        mesh = LocalMesh(*shape)
        before = self._counts()
        outs = [mesh.gather_state(sharded_swe_step(
            cfg.grid_spec(), cfg.physics(), mesh, dt=0.01, n_steps=5,
            overlap=ov)(mesh.shard_state(s0))) for ov in (True, False)]
        sim.step(5)
        assert self._counts() == before
        for (name, a), (_, b), (_, w) in zip(outs[0].items(),
                                             outs[1].items(),
                                             sim.state.items()):
            assert torch.equal(a, b), name
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)

    @pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
    def test_barotropic_matches_whole_domain(self, cuda_device, shape):
        from njw_tpu_torch.parallel import LocalMesh, sharded_barotropic_step

        cfg = SimConfig(model="barotropic", grid_width=128, grid_height=128,
                        dt=0.05, beta=1e-3, viscosity=1e-3, backend="plain")
        sim = Simulation.from_config(cfg, "vortex", strength=3.0)
        mesh = LocalMesh(*shape)
        before = self._counts()
        got = mesh.gather_state(sharded_barotropic_step(
            cfg.grid_spec(), cfg.physics(), mesh, dt=0.05, n_steps=5)(
            mesh.shard_state(sim.state)))
        sim.step(5)
        assert self._counts() == before
        torch.testing.assert_close(got.zeta, sim.state.zeta, rtol=5e-4,
                                   atol=5e-5)

    def test_pe_matches_whole_domain(self, cuda_device):
        from njw_tpu_torch.parallel import LocalMesh, sharded_pe_step

        cfg = SimConfig(model="primitive", grid_width=96, grid_height=64,
                        num_levels=4, dx=1e5, dy=1e5, dt=30.0,
                        coriolis_f=1e-4, backend="plain")
        sim = Simulation.from_config(cfg, "baroclinic", u_jet=15.0,
                                     perturb=0.5)
        mesh = LocalMesh(2, 2)
        got = mesh.gather_state(sharded_pe_step(
            cfg.grid_spec(), cfg.physics(), mesh, dt=30.0, n_steps=4)(
            mesh.shard_state(sim.state)))
        sim.step(4)
        for (name, a), (_, b) in zip(got.items(), sim.state.items()):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=name)

    def test_pe_mesh_shape_sweep_on_k4(self, cuda_device):
        from njw_tpu_torch.bench.scaling import pe_mesh_shape_sweep

        before = pe_rk4_step_cuda.launches
        rows = pe_mesh_shape_sweep(4, ny=64, nx=128, L=6, dt=10.0)
        torch.cuda.synchronize()
        assert [r["mesh"] for r in rows] == [[4, 1], [2, 2], [1, 4]]
        assert all(r["ok"] for r in rows), rows
        assert pe_rk4_step_cuda.launches == before + 2 * 4 * 3
        assert rows[0]["device"].startswith("cuda")


def _group_diff(a_state, b_state, groups=(("u", "v"), ("zeta", "div"),
                                          ("coarse_u", "coarse_v"),
                                          ("fine_u", "fine_v"))):
    """max |a - b| per field over the scale of b's field group."""
    bs = {n: t.cpu() for n, t in b_state.items()}

    def scale(name):
        group = next((g for g in groups if name in g), (name,))
        return max(float(bs[g].abs().max()) for g in group if g in bs)

    return {n: float((a.cpu() - bs[n]).abs().max()) / scale(n)
            for n, a in a_state.items()}


@pytest.mark.cuda
class TestGlobalCoresOnCard:
    """The C-grid, nested, spectral and icosahedral cores and their
    sharded forms on the card against the port on the CPU at a small
    size (20 steps, normalised by field group at 1e-4), with no kernel
    launched."""

    def _counts(self):
        return (swe_rk4_step_cuda.launches, baro_stage_cuda.launches,
                pe_stage_cuda.launches, pe_rk4_step_cuda.launches)

    @pytest.mark.parametrize("case", [
        dict(grid_width=128, grid_height=128, grid_type="staggered",
             coriolis_f=1e-4, dt=0.01),
        dict(grid_type="spherical_harmonic", grid_width=128, grid_height=64,
             dt=900.0),
        dict(grid_type="spherical_harmonic", grid_width=128, grid_height=64,
             dt=900.0, model="barotropic"),
        dict(grid_type="icosahedral", grid_width=16, grid_height=16,
             dt=450.0)], ids=["staggered", "sph_swe", "sph_bve", "icosa"])
    @pytest.mark.parametrize("fold", [False, True])
    def test_card_matches_cpu(self, cuda_device, case, fold):
        ic = {"staggered": ("vortex", {"strength": 1.0}),
              "icosahedral": ("gaussian", {"amplitude": 50.0})}.get(
            case["grid_type"], ("rossby_haurwitz", {"fold_parity": fold}))
        if case["grid_type"] != "spherical_harmonic" and fold:
            pytest.skip("the parity fold is the spectral transform's")
        before = self._counts()
        sims = [Simulation.from_config(SimConfig(device=d, **case), ic[0],
                                       **ic[1]) for d in ("cuda", "cpu")]
        for sim in sims:
            sim.step(20)
        assert self._counts() == before
        diffs = _group_diff(*(s.state for s in sims))
        assert max(diffs.values()) <= 1e-4, diffs

    def test_nested_matches_cpu(self, cuda_device):
        from njw_tpu_torch.weather.nested import make_nested_sim

        sims = [make_nested_sim(Simulation, SimConfig(
            grid_width=64, grid_height=64, coriolis_f=1e-4, dt=0.02,
            device=d), "vortex", patch=(16, 48, 16, 48), strength=1.0)
            for d in ("cuda", "cpu")]
        for sim in sims:
            sim.step(20)
        diffs = _group_diff(*(s.state for s in sims))
        assert max(diffs.values()) <= 1e-4, diffs

    def test_sht_products_stay_float32(self, cuda_device):
        """With TF32 allowed for the process, the transform's products
        still run in full float32: the card's synthesis equals the CPU's
        to float32 rounding, and the setting comes back."""
        from njw_tpu_torch.ops.sht import SphericalHarmonicTransform

        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            t = {d: SphericalHarmonicTransform(64, device=d)
                 for d in ("cuda", "cpu")}
            a = t["cpu"].analysis(torch.from_numpy(np.random.default_rng(
                0).standard_normal((64, 128)).astype(np.float32)))
            got = t["cuda"].synthesis(a.cuda()).cpu()
            want = t["cpu"].synthesis(a)
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision(prev)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-5

    def test_sharded_sphere_and_icosa(self, cuda_device):
        from njw_tpu_torch.parallel import LocalMesh
        from njw_tpu_torch.parallel.icosa import unshard_state
        from njw_tpu_torch.weather.main_paths import GlobalPath

        sph = GlobalPath(dict(grid_type="spherical_harmonic", grid_width=128,
                              grid_height=64, dt=900.0), "rossby_haurwitz",
                         {"nu4": 1e15, "fold_parity": False}, warm=0,
                         steps=5, mesh=(4, 1))
        ico = GlobalPath(dict(grid_type="icosahedral", grid_width=16,
                              grid_height=16, dt=450.0), "williamson2", {},
                         warm=0, steps=5, mesh=(5, 1))
        for p in (sph, ico):
            whole = p.simulation()
            mesh = LocalMesh(*p.mesh)
            step, states = p.sharded(whole, mesh)
            out = step(states, whole.dt)
            got = (unshard_state(out, mesh) if p is ico else out[0])
            whole.step(p.steps)
            diffs = _group_diff(got, whole.state)
            assert max(diffs.values()) <= 1e-4, diffs


@pytest.mark.cuda
class TestSignalAnalysisOnCard:
    """The rest of the signal package on the card: against the port on
    the CPU (normalised 1e-4), products with TF32 off, and MODWT on a
    batch through fir_band."""

    @staticmethod
    def _norm(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    def test_iir_adaptive_and_median_match_cpu(self, cuda_device):
        from njw_tpu_torch.signal import (
            AdaptiveFilter, IIRFilter, median_filter, sos_apply,
        )

        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5000)).astype(np.float32)
        d = rng.standard_normal(5000).astype(np.float32)
        sos = IIRFilter(design="butterworth", order=8, cutoff=0.2,
                        device="cpu").sos
        for method in ("parallel", "scan"):
            got = sos_apply(x[:, :1000] if method == "scan" else x, sos,
                            method)
            want = sos_apply(x[:, :1000] if method == "scan" else x, sos,
                             method, device="cpu")
            assert self._norm(got, want) <= 1e-4
        assert self._norm(median_filter(x, 11),
                          median_filter(x, 11, device="cpu")) == 0.0
        for dev_y, cpu_y in zip(
                AdaptiveFilter(num_taps=64, mu=0.01).apply(x[0], d),
                AdaptiveFilter(num_taps=64, mu=0.01,
                               device="cpu").apply(x[0], d)):
            assert self._norm(dev_y, cpu_y) <= 1e-4

    def test_products_ignore_the_tf32_setting(self, cuda_device):
        from njw_tpu_torch.signal import AdaptiveFilter

        rng = np.random.default_rng(1)
        x, d = (rng.standard_normal(3000).astype(np.float32)
                for _ in range(2))
        af = AdaptiveFilter(num_taps=64, mu=0.01)
        prev = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("high")
            tf32 = af.apply(x, d)
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision(prev)
        for a, b in zip(tf32, af.apply(x, d)):
            assert torch.equal(a, b)

    def test_modwt_batch_launches_fir_band(self, cuda_device, monkeypatch):
        """MODWT on a batch launches fir_band 8 times, on rows that grow by
        its periodic joins (by 7 and 14 samples: not 16-byte aligned, the
        staging branch; by 28 and 56: the TMA stream); each launch agrees
        with the plain version on its own input at the kernel's band
        (rtol / atol 1e-5)."""
        from njw_tpu_torch.signal import MODWT
        from njw_tpu_torch.signal import fir_cuda

        rng = np.random.default_rng(8)
        x = torch.from_numpy(rng.standard_normal((8, 1 << 16)).astype(
            np.float32)).to(cuda_device)
        seen = []
        real = fir_cuda.fir_batch_lanes

        def recording(xb, taps, **kw):
            y = real(xb, taps, **kw)
            seen.append((xb, taps, kw.get("passes", 3), y))
            return y

        monkeypatch.setattr(fir_cuda, "fir_batch_lanes", recording)
        before = fir_band_cuda.launches
        MODWT("db4").decompose(x, level=4)
        torch.cuda.synchronize()
        assert fir_band_cuda.launches == before + 8
        assert len(seen) == 8
        assert {xb.shape[1] - x.shape[1] for xb, *_ in seen} == {7, 14, 28,
                                                                  56}
        assert {fir_layout(*xb.shape, data_ptr=xb.data_ptr()).streamed
                for xb, *_ in seen} == {False, True}
        for xb, taps, passes, y in seen:
            torch.testing.assert_close(
                y, fir_band_plain(xb, taps, passes=passes), rtol=1e-5,
                atol=1e-5)


def _checkerboard(mesh: int):
    """A particle at each cell centre with mass 1 + 0.9 (-1)^(i+j+k), and
    64 random ones: the mass grid is mostly its Nyquist mode."""
    i = np.stack(np.meshgrid(*[np.arange(mesh)] * 3, indexing="ij"),
                 axis=-1).reshape(-1, 3)
    rng = np.random.default_rng(13)
    pos = np.concatenate([((i + 0.5) / mesh).astype(np.float32),
                          rng.random((64, 3)).astype(np.float32)])
    mass = np.concatenate([(1.0 + 0.9 * (-1.0) ** i.sum(1)).astype(
        np.float32), (0.5 + rng.random(64)).astype(np.float32)])
    return pos, mass


@pytest.mark.cuda
class TestParticlesOnCard:
    """The N-body and MD packages on the card against the CPU: normalised
    1e-4 (the Gram form at its 2e-3 band against the direct form: cuBLAS
    sums the products in another order), the cell table exactly."""

    @staticmethod
    def _norm(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    @pytest.mark.parametrize("method,tol", [("direct", 1e-4),
                                            ("mxu", 2e-3),
                                            ("pm", 1e-4), ("p3m", 1e-4)])
    def test_force_methods_match_cpu(self, cuda_device, method, tol):
        from njw_tpu_torch.nbody import accelerations, create_random_system

        kw = dict(pm_box=10.0, pm_mesh=32) if method in ("pm", "p3m") \
            else {}
        a = {dev: accelerations(create_random_system(3000, seed=1,
                                                     device=dev),
                                method=method, **kw)
             for dev in (cuda_device, "cpu")}
        assert a[cuda_device].is_cuda
        assert self._norm(a[cuda_device], a["cpu"]) <= tol

    @pytest.mark.parametrize("mesh", [16, 32])
    def test_p3m_nyquist_modes_match_cpu(self, cuda_device, mesh):
        from njw_tpu_torch.nbody.pm import p3m_accelerations

        pos, mass = _checkerboard(mesh)
        a = {dev: p3m_accelerations(torch.from_numpy(pos).to(dev),
                                    torch.from_numpy(mass).to(dev),
                                    mesh=mesh)
             for dev in (cuda_device, "cpu")}
        assert self._norm(a[cuda_device], a["cpu"]) <= 1e-4

    @pytest.mark.parametrize("method", ["all_pairs", "cell_list"])
    def test_md_force_fn_matches_cpu(self, cuda_device, method):
        from njw_tpu_torch.md import create_water_box, make_force_fn

        out = {}
        for dev in (cuda_device, "cpu"):
            st, topo, lj = create_water_box(200, seed=4, device=dev)
            out[dev] = make_force_fn(topo, lj, 2.5, st.n, method=method,
                                     box_static=st.box.cpu().numpy(),
                                     device=dev)(st)
        (fc, ec), (f, e) = out[cuda_device], out["cpu"]
        assert self._norm(fc, f) <= 1e-4
        assert float(ec["potential"]) == pytest.approx(float(e["potential"]),
                                                       rel=1e-4)

    def test_cell_table_equal_on_card(self, cuda_device):
        from njw_tpu_torch.md import create_lj_fluid
        from njw_tpu_torch.md.neighbors import (
            build_cell_table, cell_grid, neighbor_candidates, pick_capacity,
        )

        out = {}
        for dev in (cuda_device, "cpu"):
            st, _, _ = create_lj_fluid(5000, density=0.5, seed=2, device=dev)
            box = st.box.cpu().numpy()
            nc = cell_grid(box, 2.5)
            table, coords, occ = build_cell_table(
                st.pos, st.box, nc, pick_capacity(st.n, box, nc))
            out[dev] = (table, coords, occ,
                        neighbor_candidates(table, coords, nc))
        for a, b in zip(out[cuda_device], out["cpu"]):
            assert torch.equal(a.cpu(), b)


def test_particle_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from njw_tpu_torch import md, nbody
    from njw_tpu_torch.md.ewald import make_ewald_coulomb
    from njw_tpu_torch.nbody.simulation import NBodySimulation

    calls = [lambda: nbody.create_random_system(8),
             lambda: nbody.create_solar_system(),
             lambda: nbody.create_galaxy_model(8),
             lambda: NBodySimulation.load_state("missing.npz"),
             lambda: md.create_lj_fluid(8),
             lambda: md.create_water_box(2),
             lambda: make_ewald_coulomb(np.ones(3))]
    st, topo, lj = md.create_lj_fluid(8, device="cpu")
    calls.append(lambda: md.make_force_fn(topo, lj, 2.5, 8))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.cuda
class TestImagingOnCard:
    """The medical and geospatial packages on the card against the CPU:
    FBP, CG-SENSE and the Kaiser-Bessel grid at normalised 1e-4; flow
    accumulation and the min and max rasters exactly equal; the gradient
    of register_deformable's objective at 256^2 at normalised 1e-4, with
    its backward's time (the control-grid gathers by index_select)."""

    @staticmethod
    def _norm(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    def test_fbp_matches_cpu(self, cuda_device):
        from njw_tpu_torch.medical import filtered_backprojection, radon
        from njw_tpu_torch.medical.main_paths import ct_shepp_logan

        img = torch.from_numpy(ct_shepp_logan(128))
        ang = torch.linspace(0, np.pi, 91)[:90]
        out = {dev: filtered_backprojection(
            radon(img.to(dev), ang.to(dev)), ang.to(dev))
            for dev in (cuda_device, "cpu")}
        assert out[cuda_device].is_cuda
        assert self._norm(out[cuda_device], out["cpu"]) <= 1e-4

    def test_cg_sense_matches_cpu(self, cuda_device):
        from njw_tpu_torch.medical import reconstruct_cg
        from njw_tpu_torch.medical.main_paths import coil_maps, insert_phantom

        n = 64
        img, sens = insert_phantom(n), coil_maps(n, 4)
        mask = np.zeros((n, n), np.float32)
        mask[::2] = 1.0
        mask[n // 2 - 6:n // 2 + 6] = 1.0
        k = (mask[None] * np.fft.fftshift(np.fft.fft2(
            sens * img[None], norm="ortho"), axes=(-2, -1))).astype(
                np.complex64)
        out = {dev: reconstruct_cg(*(torch.from_numpy(a).to(dev)
                                     for a in (k, mask, sens)),
                                   num_iterations=10)
               for dev in (cuda_device, "cpu")}
        assert self._norm(out[cuda_device], out["cpu"]) <= 1e-4

    def test_kb_grid_matches_cpu(self, cuda_device):
        from njw_tpu_torch.medical import mri
        from njw_tpu_torch.medical.main_paths import radial_trajectory

        coords = radial_trajectory(64, 128)
        rng = np.random.default_rng(6)
        s = (rng.standard_normal(len(coords))
             + 1j * rng.standard_normal(len(coords))).astype(np.complex64)
        beta = mri._kb_beta(4, 2.0)
        out = {dev: mri._kb_grid(torch.from_numpy(s).to(dev),
                                 torch.from_numpy(coords).to(dev),
                                 torch.ones(len(coords), device=dev), 128, 4,
                                 beta)
               for dev in (cuda_device, "cpu")}
        assert self._norm(out[cuda_device], out["cpu"]) <= 1e-4

    @pytest.mark.parametrize("method", ["push", "doubling"])
    def test_flow_accumulation_equal_on_card(self, cuda_device, method):
        from njw_tpu_torch.geospatial import flow_accumulation
        from njw_tpu_torch.geospatial.main_paths import measure_dem

        z = torch.from_numpy(measure_dem(256))
        out = {dev: flow_accumulation(z.to(dev), method=method)
               for dev in (cuda_device, "cpu")}
        assert torch.equal(out[cuda_device].cpu(), out["cpu"])

    @pytest.mark.parametrize("statistic", ["min", "max"])
    def test_rasters_equal_on_card(self, cuda_device, statistic):
        from njw_tpu_torch.geospatial import rasterize_dem
        from njw_tpu_torch.geospatial.datasets import synthetic_point_cloud

        pc = synthetic_point_cloud(100_000, seed=2)
        a, b = (rasterize_dem(pc, 2.0, statistic, device=dev)[0]
                for dev in (cuda_device, "cpu"))
        a = a.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])

    def test_deformable_gradient_matches_cpu(self, cuda_device):
        import time

        from njw_tpu_torch.medical.main_paths import registration_image
        from njw_tpu_torch.medical.registration import (
            _value_and_grad, deformable_loss, warp_deformable,
        )

        f = registration_image(256)
        ctrl = np.random.default_rng(0).normal(0, 1.5, (2, 9, 9)).astype(
            np.float32)
        grads = {}
        for dev in (cuda_device, "cpu"):
            ft = torch.from_numpy(f).to(dev)
            m = warp_deformable(ft, torch.from_numpy(-ctrl).to(dev))
            c = torch.from_numpy(0.5 * ctrl).to(dev)

            def loss(c_, ft=ft, m=m):
                return deformable_loss(ft, m, c_)

            grads[dev] = _value_and_grad(loss, c)[1]
            if dev == cuda_device:
                with torch.enable_grad():
                    p = c.detach().requires_grad_(True)
                    val = loss(p)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(10):
                        torch.autograd.grad(val, p, retain_graph=True)
                    torch.cuda.synchronize()
                print(f"deformable loss backward at 256^2: "
                      f"{(time.perf_counter() - t0) * 100:.3f} ms")
        assert self._norm(grads[cuda_device], grads["cpu"]) <= 1e-4


def test_imaging_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from njw_tpu_torch import geospatial as geo
    from njw_tpu_torch import medical as med
    from njw_tpu_torch.geospatial.datasets import synthetic_point_cloud

    img = np.zeros((8, 8), np.float32)
    pc = synthetic_point_cloud(200, seed=0)
    calls = [lambda: med.radon(img, [0.0]),
             lambda: med.filtered_backprojection(img, np.zeros(8)),
             lambda: med.reconstruct_ct(img, np.zeros(8)),
             lambda: med.reconstruct_kspace(img),
             lambda: med.MRIReconstructor("fft").process(img),
             lambda: med.MRIReconstructor().undersampling_mask(8, 8),
             lambda: med.gaussian_filter(img),
             lambda: med.apply_filter(img, "median"),
             lambda: med.apply_segmentation(img, "otsu"),
             lambda: med.register_images(img, img, n_iterations=1),
             lambda: med.load_image("missing.npy"),
             lambda: geo.terrain_derivatives(img),
             lambda: geo.DEMProcessor(img),
             lambda: geo.flow_accumulation(img),
             lambda: geo.rasterize_dem(pc),
             lambda: geo.classify_ground(pc)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _normalised(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


@pytest.mark.cuda
class TestFinanceOnCard:
    """The geo-financial Monte-Carlo transforms and prices on the card
    against the port on the CPU, on the same normals (drawn once on the
    CPU and moved: the two devices' generators give different streams)."""

    def _market(self, n):
        from njw_tpu_torch.geofinancial.main_paths import market

        return market(n)

    def test_transforms_same_normals(self, cuda_device):
        from njw_tpu_torch.geofinancial import options as O
        from njw_tpu_torch.geofinancial.portfolio import terminal_wealth
        from njw_tpu_torch.geofinancial.risk_metrics import (
            portfolio_samples, standard_normals,
        )

        mean, _, w, chol = self._market(50)
        z = standard_normals((20_000, 50), 1, "cpu")
        for fn in (lambda z: portfolio_samples(z, mean, chol, w),
                   lambda z: terminal_wealth(z, w, mean, chol, 80, 250)):
            assert _normalised(fn(z.to(cuda_device)), fn(z)) <= 1e-5
        zp = standard_normals((400, 252), 2, "cpu")
        assert _normalised(O.gbm_paths(zp.to(cuda_device), 100.0, 1.0, 0.05,
                                       0.2),
                           O.gbm_paths(zp, 100.0, 1.0, 0.05, 0.2)) <= 1e-5

    def test_prices_same_normals(self, cuda_device):
        import njw_tpu_torch.geofinancial as T
        from njw_tpu_torch.geofinancial.risk_metrics import standard_normals

        mean, cov, w, _ = self._market(20)
        z = standard_normals((20_000, 20), 3, "cpu")
        card = T.monte_carlo_var(mean=mean, cov=cov, weights=w,
                                 n_samples=20_000, return_cvar=True,
                                 normals=z.to(cuda_device))
        cpu = T.monte_carlo_var(mean=mean, cov=cov, weights=w,
                                n_samples=20_000, return_cvar=True,
                                normals=z)
        np.testing.assert_allclose(card, cpu, rtol=1e-5)
        zp = standard_normals((5000, 100), 4, "cpu")
        for fn in (T.barrier_option_price, T.asian_option_price):
            args = ((100.0, 100.0, 120.0) if fn is T.barrier_option_price
                    else (100.0, 100.0))
            a = fn(*args, 1.0, 0.05, 0.2, n_paths=5000, n_steps=100,
                   normals=zp.to(cuda_device))
            b = fn(*args, 1.0, 0.05, 0.2, n_paths=5000, n_steps=100,
                   normals=zp)
            for k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-12)

    def test_float32_products_guard(self, cuda_device):
        """TF32 forced on before the call: the transforms' products still
        run in full float32 and match the CPU, and the process's setting
        is restored after."""
        from njw_tpu_torch.geofinancial.portfolio import terminal_wealth
        from njw_tpu_torch.geofinancial.risk_metrics import (
            portfolio_samples, standard_normals,
        )

        mean, _, w, chol = self._market(100)
        z = standard_normals((252 * 400, 100), 5, "cpu")
        zc = z.to(cuda_device)
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")      # TF32 on
        try:
            assert torch.backends.cuda.matmul.allow_tf32
            samples = portfolio_samples(zc, mean, chol, w)
            wealth = terminal_wealth(zc, w, mean, chol, 400, 252)
            assert torch.get_float32_matmul_precision() == "high"
            cholc = torch.as_tensor(chol, dtype=torch.float32,
                                    device=cuda_device)
            tf32 = _normalised(zc @ cholc.T, z @ cholc.cpu().T)
        finally:
            torch.set_float32_matmul_precision(prev)
        assert _normalised(samples, portfolio_samples(z, mean, chol, w)) \
            <= 1e-5
        exact = _normalised(wealth, terminal_wealth(z, w, mean, chol, 400,
                                                    252))
        assert exact <= 1e-5
        # the guard is what holds it: the same product in TF32 parts more
        assert tf32 > 10 * exact


def test_finance_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    import njw_tpu_torch.geofinancial as T

    calls = [lambda: T.monte_carlo_var(mean=[0.0], cov=[[1e-4]],
                                       n_samples=10),
             lambda: T.black_scholes(100, 100, 1, 0.05, 0.2),
             lambda: T.create_flood_risk_factor(np.zeros((8, 8))),
             lambda: T.TPUOptimizer()]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.cuda
class TestShellOnCard:
    """The interop transfers and a small suite run on the card."""

    def test_transfers_round_trip(self, cuda_device):
        from njw_tpu_torch.interop import (
            DeviceMemoryManager, chunked_device_put,
        )

        x = np.random.default_rng(16).standard_normal((1000, 333),
                                                      dtype=np.float32)
        t = chunked_device_put(x, chunk_bytes=40_000, device=cuda_device)
        assert t.is_cuda
        np.testing.assert_array_equal(t.cpu().numpy(), x)
        with DeviceMemoryManager(cuda_device) as mgr:
            h = mgr.to_device("x", x)
            h.wait()
            assert h.ready and mgr.get("x").is_cuda
            mgr.copy("x", "y").wait()
            np.testing.assert_array_equal(mgr.to_host("y").wait(), x)
            assert mgr.allocated_bytes == 2 * x.nbytes
            mgr.free("x")
            with pytest.raises(KeyError):
                mgr.get("x")
            stats = mgr.memory_stats()
            assert stats["tracked_buffers"] == 1
            assert stats["allocated_bytes.all.current"] >= x.nbytes

    def test_suite_weather_signal_launch_counts(self, cuda_device, tmp_path):
        """--workloads weather signal: K1 once a step and K7 once an
        application, over the run's 6 repeats (warm-ups included)."""
        import contextlib
        import io
        import json

        from njw_tpu_torch.bench.__main__ import main
        from njw_tpu_torch.ops import launch_counts

        params = {"weather": {"grid_size": 128, "num_steps": 10},
                  "signal": {"num_samples": 65536, "batch": 8}}
        before = launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--workloads", "weather", "signal", "--params",
                       json.dumps(params), "--output-dir", str(tmp_path)])
        assert rc == 0
        after = launch_counts()
        weather, signal = [json.loads(ln) for ln in
                           buf.getvalue().splitlines()]
        k1 = 6 * weather["additional_metrics"]["steps_per_repeat"]
        k7 = 6 * signal["additional_metrics"]["applications_per_repeat"]
        delta = {k: after[k] - before[k] for k in after}
        assert delta == {**dict.fromkeys(delta, 0), "swe_rk4": k1,
                         "fir_band": k7}
        assert weather["additional_metrics"]["kernel_launches"]["swe_rk4"] \
            == k1
        assert signal["additional_metrics"]["kernel_launches"]["fir_band"] \
            == k7
        assert weather["device"].startswith("cuda:")
        assert weather["throughput"] > 0 and signal["throughput"] > 0


def test_shell_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from njw_tpu_torch.bench import BenchmarkSuite, WeatherBenchmark
    from njw_tpu_torch.interop import DeviceMemoryManager, chunked_device_put
    from njw_tpu_torch.platform import default_mesh

    calls = [BenchmarkSuite, WeatherBenchmark, DeviceMemoryManager,
             default_mesh, lambda: chunked_device_put(np.zeros(4))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
