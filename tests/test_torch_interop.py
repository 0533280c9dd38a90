"""The port's interop layer and native loader held against the JAX
package's ``njw_tpu.interop`` and ``njw_tpu.native``.

``tests/test_interop.py`` and ``tests/test_native.py`` run again on the
port, on the CPU (``device="cpu"``; the CUDA transfers are card tests in
``tests/test_torch_cuda.py``). The native library is the same
``native/libnjw_host.so`` for both packages, loaded by each package's own
loader; its results are compared with the JAX package's, the port's and
NumPy's at ``tests/test_native.py``'s tolerances.
"""
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import njw_tpu.interop as jinterop  # noqa: E402
from njw_tpu import native as jnative  # noqa: E402

import njw_tpu_torch.interop as tinterop  # noqa: E402
from njw_tpu_torch import native  # noqa: E402
from njw_tpu_torch.interop import (  # noqa: E402
    DeviceMemoryManager, SharedArray, SharedMemoryManager,
    chunked_device_put, to_numpy, to_torch, zero_copy_view,
)

CPU = "cpu"


def _child_doubles(name, out_q):
    sa = SharedArray.attach(name)
    sa.array[...] = sa.array * 2
    total = float(sa.array.sum())
    sa.close()
    out_q.put(total)


def test_every_name_exported_but_to_jax():
    jax_names = {n for n in dir(jinterop) if not n.startswith("_")}
    jax_names -= {"array_ops", "device_memory", "shared_memory"}
    assert jax_names - {"to_jax"} <= set(dir(tinterop))
    assert not hasattr(tinterop, "to_jax")


class TestSharedMemory:
    def test_create_attach_roundtrip(self):
        with SharedArray.create("njwt_test_rt", (8, 8), np.float32) as sa:
            sa.array[...] = 7.0
            other = SharedArray.attach("njwt_test_rt")
            np.testing.assert_array_equal(other.array, 7.0)
            other.array[0, 0] = 1.0
            assert sa.array[0, 0] == 1.0  # same memory
            other.close()

    def test_cross_process_mutation(self):
        ctx = mp.get_context("spawn")
        with SharedArray.from_array("njwt_test_xp",
                                    np.arange(16.0, dtype=np.float32)) as sa:
            q = ctx.Queue()
            p = ctx.Process(target=_child_doubles, args=("njwt_test_xp", q))
            p.start()
            total = q.get(timeout=60)
            p.join(timeout=30)
            assert p.exitcode == 0
            assert total == pytest.approx(2 * np.arange(16.0).sum())
            np.testing.assert_array_equal(
                sa.array, 2 * np.arange(16.0, dtype=np.float32))

    def test_jax_package_attaches_the_ports_segment(self):
        """The header format is shared: the JAX package's SharedArray
        attaches a segment the port created."""
        src = np.random.default_rng(3).standard_normal((3, 5))
        with SharedArray.from_array("njwt_test_cross", src):
            other = jinterop.SharedArray.attach("njwt_test_cross")
            np.testing.assert_array_equal(other.array, src)
            other.close()

    def test_manager_lifecycle(self):
        with SharedMemoryManager(prefix="njwtm") as mgr:
            a = mgr.allocate((4,), np.int32)
            b = mgr.share(np.ones(3, np.float64))
            assert a.array.sum() == 0
            np.testing.assert_array_equal(mgr.get(b.name).array, 1.0)
        with pytest.raises(FileNotFoundError):
            SharedArray.attach(a.name)


class TestDeviceMemory:
    def test_put_get_roundtrip(self):
        with DeviceMemoryManager(CPU) as mgr:
            h = np.random.default_rng(0).standard_normal(64).astype(
                np.float32)
            handle = mgr.to_device("x", h)
            assert handle.ready
            handle.wait()
            back = mgr.to_host("x").wait()
            np.testing.assert_array_equal(back, h)
            assert mgr.allocated_bytes == h.nbytes
            assert mgr.memory_stats()["tracked_buffers"] == 1

    def test_to_device_copies(self):
        with DeviceMemoryManager(CPU) as mgr:
            h = np.ones(4, np.float32)
            mgr.to_device("x", h)
            h[0] = 5.0
            assert float(mgr.get("x")[0]) == 1.0

    def test_d2d_copy_and_free(self):
        with DeviceMemoryManager(CPU) as mgr:
            mgr.to_device("a", np.ones(8, np.float32))
            mgr.copy("a", "b").wait()
            np.testing.assert_array_equal(mgr.to_host("b").wait(), 1.0)
            mgr.free("a")
            with pytest.raises(KeyError):
                mgr.get("a")

    def test_stats_keys_as_jax(self):
        x = np.arange(6, dtype=np.float32)
        with DeviceMemoryManager(CPU) as t, jinterop.DeviceMemoryManager() as j:
            t.to_device("x", x)
            j.to_device("x", x)
            ts, js = t.memory_stats(), j.memory_stats()
            for k in ("tracked_buffers", "tracked_bytes"):
                assert ts[k] == js[k]


class TestArrayOps:
    def test_conversions(self):
        x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
        t = to_torch(jinterop.to_jax(x))
        np.testing.assert_array_equal(to_numpy(t), x)
        assert zero_copy_view(t).shape == (2, 3)
        assert to_torch(t) is t

    def test_zero_copy_view_shares_memory(self):
        t = torch.zeros(5)
        v = zero_copy_view(t)
        v[2] = 3.0
        assert float(t[2]) == 3.0

    def test_same_as_jax(self):
        x = np.random.default_rng(5).standard_normal((3, 4))
        for a in (x, x.tolist(), torch.from_numpy(x)):
            np.testing.assert_array_equal(to_numpy(a), jinterop.to_numpy(a))
            np.testing.assert_array_equal(to_torch(a).numpy(),
                                          jinterop.to_torch(a).numpy())
        assert to_torch(x).device == torch.device("cpu")

    @pytest.mark.parametrize("chunk_bytes", [128 * 4 * 8, 1 << 30])
    def test_chunked_device_put(self, chunk_bytes):
        x = np.random.default_rng(1).standard_normal((64, 128)).astype(
            np.float32)
        out = chunked_device_put(x, chunk_bytes=chunk_bytes, device=CPU)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), x)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jinterop.chunked_device_put(
                x, chunk_bytes=chunk_bytes)))


needs_native = pytest.mark.skipif(
    not jnative.available(),
    reason=f"native library unavailable: {jnative.load_error()}")


@needs_native
class TestNative:
    def test_port_loader_loads(self):
        assert native.available() and native.load_error() is None
        assert native.load().omp_thread_count() >= 1

    def test_swe_rk4_matches_oracles(self):
        from njw_tpu_torch.ops.stencil import swe_rk4_step_plain
        from njw_tpu_torch.weather import GridSpec
        from njw_tpu_torch.weather.oracle import SWEOracle

        rng = np.random.default_rng(0)
        n = 48
        u = rng.normal(0, 0.5, (n, n)).astype(np.float32)
        v = rng.normal(0, 0.5, (n, n)).astype(np.float32)
        h = (10 + rng.normal(0, 0.1, (n, n))).astype(np.float32)
        nu, nv, nh = native.swe_rk4_run(u, v, h, dt=0.01, n_steps=20,
                                        coriolis_f=1e-4)
        ju, jv, jh = jnative.swe_rk4_run(u, v, h, dt=0.01, n_steps=20,
                                         coriolis_f=1e-4)
        for a, b in ((nu, ju), (nv, jv), (nh, jh)):
            np.testing.assert_array_equal(a, b)  # the same library
        ou, ov, oh = SWEOracle(coriolis_f=1e-4).run((u, v, h), 0.01, 20,
                                                    "rk4")
        np.testing.assert_allclose(nh, oh, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(nu, ou, rtol=1e-4, atol=1e-4)
        ref = tuple(torch.from_numpy(a) for a in (u, v, h))
        for _ in range(20):
            ref = swe_rk4_step_plain(*ref, grid=GridSpec(nx=n, ny=n),
                                     dt=0.01, coriolis_f=1e-4)
        np.testing.assert_allclose(nh, ref[2].numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(nu, ref[0].numpy(), rtol=1e-4, atol=1e-4)

    def test_nbody_matches_port_and_jax_forces(self):
        from njw_tpu.nbody import accelerations as j_acc
        from njw_tpu.nbody import create_random_system
        from njw_tpu_torch.nbody import accelerations, convert

        s = create_random_system(256, seed=1)
        a_native = native.nbody_accelerations(
            np.asarray(s.pos), np.asarray(s.mass), G=1.0, softening=1e-6)
        a_jax = np.asarray(j_acc(s, method="direct"))
        a_port = accelerations(convert.system_from(s, device=CPU),
                               method="direct").numpy()
        np.testing.assert_allclose(a_native, a_jax, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a_native, a_port, rtol=1e-4, atol=1e-4)

    def test_lj_dimer_force_sign(self):
        pos = np.asarray([[0, 0, 0], [1.5, 0, 0]], np.float32) + 10
        f = native.lj_forces(pos, np.full(3, 50.0, np.float32))
        assert f[0, 0] > 0 > f[1, 0]
        pos2 = np.asarray([[0, 0, 0], [0.9, 0, 0]], np.float32) + 10
        f2 = native.lj_forces(pos2, np.full(3, 50.0, np.float32))
        assert f2[0, 0] < 0 < f2[1, 0]

    def test_fir_matches_numpy_and_the_port(self):
        from njw_tpu_torch.signal import fir_apply

        rng = np.random.default_rng(2)
        x = rng.standard_normal(512).astype(np.float32)
        taps = rng.standard_normal(31).astype(np.float32)
        y = native.fir_filter(x, taps)
        ref = np.convolve(x, taps)[:512].astype(np.float32)
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            y, fir_apply(x, taps, device=CPU).numpy(), rtol=1e-4, atol=1e-4)

    def test_async_writer(self, tmp_path):
        with native.AsyncSnapshotWriter(max_queue=2) as w:
            arrays = [np.full(100, float(i), np.float32) for i in range(5)]
            paths = [str(tmp_path / f"snap_{i}.bin") for i in range(5)]
            for i, (p, a) in enumerate(zip(paths, arrays)):
                assert w.enqueue(p, a, step=i)
            w.flush()
            assert w.written == 5
            step, data = native.AsyncSnapshotWriter.read_snapshot(paths[3])
            assert step == 3
            np.testing.assert_array_equal(data, arrays[3])
            # the JAX package reads the port's snapshots
            jstep, jdata = jnative.AsyncSnapshotWriter.read_snapshot(paths[3])
            assert jstep == 3
            np.testing.assert_array_equal(jdata, data)


def test_load_error_names_the_compilers_error(monkeypatch):
    """A failed build reports the first error line of make's output (for
    example a g++ without OpenMP's spec file)."""
    import subprocess

    def failing_make(*args, **kwargs):
        raise subprocess.CalledProcessError(
            2, ["make"], stderr="g++: fatal error: cannot read spec file "
            "'libgomp.spec'\ncompilation terminated.\nmake: *** [all] "
            "Error 1\n")

    monkeypatch.setattr(native.subprocess, "run", failing_make)
    monkeypatch.setattr(native, "_load_error", None)
    assert native._build() is False
    assert native.load_error().endswith(
        "g++: fatal error: cannot read spec file 'libgomp.spec'")


def test_jax_arrays_convert():
    """A JAX array goes through ``to_numpy`` / ``to_torch`` as any
    array-like."""
    j = jnp.arange(4.0)
    np.testing.assert_array_equal(to_torch(j).numpy(), np.arange(4.0))
