"""The port's scaling harness (njw_tpu_torch.bench.scaling) against the
JAX package's row contracts (tests/test_infra_misc.py:13-46).

The port runs on LocalMesh(device='cpu'): the rows it times here are CPU
times, which validate the harness and nothing about the card. The JAX
functions run at small sizes on the 8 virtual CPU devices of
tests/conftest.py for their row keys; every port row carries them, plus
``ok``, the mesh kind and the device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu.bench import scaling as jscaling  # noqa: E402

from njw_tpu_torch.bench import scaling  # noqa: E402
from njw_tpu_torch.bench.scaling import (  # noqa: E402
    halo_overlap_efficiency, pe_mesh_shape_sweep, swe_scaling_sweep,
)
from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.weather.grid import WeatherState  # noqa: E402

CPU = "cpu"
LABEL = {"mesh_kind": "LocalMesh", "device": "cpu (cpu)"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_rows():
    """One small row of each JAX function, for its keys."""
    return {
        "sweep": jscaling.swe_scaling_sweep(global_grid=32, steps_per_call=2,
                                            device_counts=[2])[0],
        "overlap": jscaling.halo_overlap_efficiency(grid_size=32,
                                                    n_devices=2, n_steps=2),
        # njw_tpu/bench/scaling.py:196-201
        "pe": dict.fromkeys([
            "mesh", "local_block", "normalized_maxdiff", "ok",
            "collective_permutes_per_step", "ici_payload_bytes_per_step"]),
    }


class TestScalingHarness:
    def test_strong_scaling_sweep(self, jax_rows):
        rows = swe_scaling_sweep(global_grid=64, steps_per_call=5,
                                 device_counts=[1, 4], device=CPU)
        assert [r["devices"] for r in rows] == [1, 4]
        assert rows[1]["mesh"] == [2, 2]
        for r in rows:
            assert set(jax_rows["sweep"]) <= set(r)
            assert r["grid_points_per_second"] > 0
            assert 0 < r["scaling_efficiency"] <= 4.0
            # the sharded result equals the one-shard result
            assert r["ok"] and r["max_abs_diff_vs_first"] == 0.0
            assert {k: r[k] for k in LABEL} == LABEL

    def test_weak_scaling_grid_grows(self):
        rows = swe_scaling_sweep(global_grid=32, steps_per_call=2,
                                 device_counts=[1, 4], mode="weak",
                                 device=CPU)
        assert rows[1]["grid"] == [64, 64] and rows[0]["grid"] == [32, 32]
        assert all(r["ok"] for r in rows)

    @pytest.mark.parametrize("overlap", [True, False])
    def test_halo_overlap_metric(self, jax_rows, overlap):
        m = halo_overlap_efficiency(grid_size=64, n_devices=4, n_steps=5,
                                    overlap=overlap, device=CPU)
        assert set(jax_rows["overlap"]) <= set(m)
        assert 0 < m["overlap_efficiency"] <= 1.0
        assert m["t_full_s"] > 0 and m["overlap"] is overlap
        assert m["ok"] and m["devices"] == 4
        assert {k: m[k] for k in LABEL} == LABEL

    def test_pe_mesh_shape_sweep(self, jax_rows):
        """Every (py, px) of the fused PE path (the plain versions of K4's
        padded launches on the CPU) equals the whole-domain step and
        reports the port's exchange counts: one exchange a direction and
        axis that moves data."""
        rows = pe_mesh_shape_sweep(n_devices=4, ny=32, nx=64, L=4,
                                   shapes=[(4, 1), (2, 2), (1, 4), (3, 1)],
                                   device=CPU)
        assert [r["mesh"] for r in rows] == [[4, 1], [2, 2], [1, 4]]
        for r in rows:
            assert set(jax_rows["pe"]) <= set(r)
            assert r["ok"], r
        assert [r["collective_permutes_per_step"] for r in rows] == [2, 4, 2]
        # (4, 1): 4 shards x 2 directions x 4 rows x 64 columns x (4 x 4
        # level planes + ps) floats
        assert rows[0]["ici_payload_bytes_per_step"] == \
            4 * 2 * 4 * 64 * 17 * 4

    def test_default_shapes_and_mesh_for(self):
        assert [scaling._mesh_for(n, CPU).shape for n in (1, 2, 4, 6, 8)] \
            == [(1, 1), (2, 1), (2, 2), (3, 2), (4, 2)]
        rows = pe_mesh_shape_sweep(n_devices=2, ny=16, nx=16, L=2,
                                   device=CPU)
        assert [r["mesh"] for r in rows] == [[2, 1], [1, 2]]

    def test_no_exchange_mesh_moves_nothing(self):
        """The no-exchange mesh hands every shard its own payload and
        counts nothing."""
        quiet = scaling._NoExchange(2, 2, device=CPU)
        payloads = [(torch.full((1,), float(i)),) for i in range(4)]
        got = quiet.ring_shift(payloads, "x", 1)
        assert [float(p[0]) for p in got] == [0.0, 1.0, 2.0, 3.0]
        assert quiet.exchanges == 0
        moved = LocalMesh(2, 2, device=CPU).ring_shift(payloads, "x", 1)
        assert [float(p[0]) for p in moved] == [1.0, 0.0, 3.0, 2.0]

    def test_swe_state_is_the_jax_vortex(self):
        """The harness's state is the JAX harness's (vortex 2.0)."""
        from njw_tpu.weather import GridSpec as JGrid
        from njw_tpu.weather import make_initial_state

        from njw_tpu_torch.weather.grid import GridSpec

        want = make_initial_state("vortex", JGrid(nx=24, ny=16),
                                  strength=2.0)
        got = scaling._swe_state(GridSpec(nx=24, ny=16), CPU)
        assert isinstance(got, WeatherState) and got.T is None
        for name in ("u", "v", "h"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("fn,args", [
        (swe_scaling_sweep, (32,)), (halo_overlap_efficiency, (32, 2)),
        (pe_mesh_shape_sweep, (2,))])
    def test_default_device_is_cuda(self, fn, args):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args)
