"""The port's distributed FFT (njw_tpu_torch.parallel.fft) and the mesh's
all-to-all held against the JAX package.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
LocalMesh(device='cpu'). The inputs are made with numpy from a seed.
Tolerances are the JAX tests' (tests/test_parallel_halo.py:427-474:
Poisson rtol 1e-3 / atol 1e-4, the 2-D round trip 1e-5); the all-to-all
only moves data, so it must equal ``lax.all_to_all`` exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from njw_tpu.ops.spectral import poisson_solve as jpoisson_solve  # noqa: E402
from njw_tpu.parallel import fft as jfft  # noqa: E402

from njw_tpu_torch.ops.spectral import poisson_solve  # noqa: E402
from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.parallel import fft  # noqa: E402
from njw_tpu_torch.weather.barotropic import BarotropicState  # noqa: E402

CPU = "cpu"
POISSON_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(py, px):
    return Mesh(np.array(jax.devices()[:py * px]).reshape(py, px), ("y", "x"))


def _field(ny, nx, seed, zero_mean=True):
    f = np.random.default_rng(seed).standard_normal((ny, nx)).astype(
        np.float32)
    return f - f.mean() if zero_mean else f


def _shards(mesh, f):
    return [s.zeta for s in mesh.shard_state(
        BarotropicState(zeta=torch.from_numpy(f)))]


def _gather(mesh, blocks):
    return mesh.gather_state([BarotropicState(zeta=b)
                              for b in blocks]).zeta.numpy()


# ------------------------------------------------------------ all-to-all

@pytest.mark.parametrize("axis,split,concat", [
    ("x", 0, 1), ("x", 1, 0), ("x", 1, 1), ("x", 0, 0), ("y", 1, 1),
    ("y", 2, 0), (("y", "x"), 1, 1), (("y", "x"), 0, 2)])
def test_all_to_all_is_lax_all_to_all(axis, split, concat):
    """Every shard's block (a, b, c) with the axis size at ``split``:
    LocalMesh.all_to_all equals lax.all_to_all(tiled=False) under
    shard_map on a (2, 4) mesh, bit for bit."""
    py, px = 2, 4
    n = {"x": px, "y": py}.get(axis, py * px)
    shape = [3, 5, 2]
    shape[split] = n
    rng = np.random.default_rng(7)
    blocks = rng.standard_normal([py, px] + shape).astype(np.float32)
    # shard (iy, ix) holds tile (iy, ix) of the first two dims
    whole = blocks.transpose(0, 2, 1, 3, 4).reshape(
        py * shape[0], px * shape[1], shape[2])

    def local(b):
        return lax.all_to_all(b, axis, split, concat, tiled=False)

    out = jax.jit(jax.shard_map(local, mesh=_jmesh(py, px),
                                in_specs=P("y", "x"), out_specs=P("y", "x"),
                                check_vma=False))(jnp.asarray(whole))
    out = np.asarray(out)
    mesh = LocalMesh(py, px, device=CPU)
    got = mesh.all_to_all([torch.from_numpy(blocks[iy, ix])
                           for iy, ix in mesh.coords], axis, split, concat)
    h, w = out.shape[0] // py, out.shape[1] // px
    for (iy, ix), g in zip(mesh.coords, got):
        np.testing.assert_array_equal(
            g.numpy(), out[iy * h:(iy + 1) * h, ix * w:(ix + 1) * w])


def test_all_to_all_counts_and_refuses():
    mesh = LocalMesh(2, 2, device=CPU)
    blocks = [torch.zeros(2, 3, dtype=torch.complex64) for _ in range(4)]
    mesh.all_to_all(blocks, "x", 0, 1)
    assert (mesh.exchanges, mesh.exchange_bytes) == (1, 4 * 6 * 8)
    mesh.ring_shift([(b,) for b in blocks], "y", 1)
    assert (mesh.exchanges, mesh.exchange_bytes) == (2, 2 * 4 * 6 * 8)
    with pytest.raises(ValueError, match="must be the axis size 4"):
        mesh.all_to_all(blocks, ("y", "x"), 0, 1)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_size("z")


def test_transposes_round_trip_exactly():
    """fwd then bwd (and the pencils around them) is the identity, bit for
    bit: it only moves data."""
    mesh = LocalMesh(2, 4, device=CPU)
    f = _field(32, 64, 1, zero_mean=False)
    z = [b.to(torch.complex64) for b in _shards(mesh, f)]
    back = fft.transpose_round_trip(mesh, z, pencils=True)
    for a, b in zip(back, z):
        assert torch.equal(a, b)
    row = LocalMesh(4, 1, device=CPU)
    z = [b.to(torch.complex64) for b in _shards(row, f)]
    t = fft._local_transpose_fwd(row, z)
    assert t[1].shape == (16, 32)   # (nx / n, ny)
    # shard i holds the x columns i*16 .. of every row, as rows
    np.testing.assert_array_equal(t[1].real.numpy(), f[:, 16:32].T)


# ---------------------------------------------------------------- Poisson

def test_poisson_1d_matches_jax_and_whole_domain():
    """tests/test_parallel_halo.py:427-441: 64^2 on 4 devices."""
    f = _field(64, 64, 0)
    jmesh = Mesh(np.array(jax.devices()[:4]), ("y",))
    want = np.asarray(jfft.make_distributed_poisson(jmesh, 64, 64, 1.0, 1.0)(
        jnp.asarray(f)))
    got = fft.make_distributed_poisson(LocalMesh(4, 1, device=CPU), 64, 64,
                                       1.0, 1.0)(torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, **POISSON_TOL)
    np.testing.assert_allclose(
        got.numpy(), poisson_solve(torch.from_numpy(f), 1.0, 1.0).numpy(),
        **POISSON_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
def test_poisson_2d_matches_jax(shape):
    """tests/test_parallel_halo.py:443-457: pencil transpose FFT,
    anisotropic dx, dy."""
    f = _field(64, 64, 3)
    want = np.asarray(jfft.make_distributed_poisson_2d(
        _jmesh(*shape), 64, 64, 0.7, 1.3)(jnp.asarray(f)))
    got = fft.make_distributed_poisson_2d(LocalMesh(*shape, device=CPU), 64,
                                          64, 0.7, 1.3)(torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, **POISSON_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpoisson_solve(jnp.asarray(f), 0.7, 1.3)),
        **POISSON_TOL)


@pytest.mark.parametrize("kind", ["laplacian5", "central", "spectral"])
def test_poisson_kinds_match_jax(kind):
    f = _field(32, 32, 4)
    jmesh = Mesh(np.array(jax.devices()[:2]), ("y",))
    want = np.asarray(jfft.make_distributed_poisson(
        jmesh, 32, 32, 0.5, 2.0, kind)(jnp.asarray(f)))
    got = fft.make_distributed_poisson(LocalMesh(2, 1, device=CPU), 32, 32,
                                       0.5, 2.0, kind)(torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), want, **POISSON_TOL)


def test_spectral_apply_2d_roundtrip_identity():
    """tests/test_parallel_halo.py:459-474: symbol 1 gives the input
    back."""
    f = _field(32, 64, 5, zero_mean=False)
    mesh = LocalMesh(2, 4, device=CPU)
    out = fft.spectral_apply_distributed_2d(mesh, _shards(mesh, f),
                                            lambda kx, ky: 1.0)
    np.testing.assert_allclose(_gather(mesh, out), f, rtol=1e-5, atol=1e-5)


def test_spectral_apply_1d_matches_jax():
    """A symbol of the wavenumbers (-(kx^2 + ky^2), the exact Laplacian)
    over the transposed spectrum, as spectral_apply_distributed gives
    them."""
    f = _field(32, 64, 6)
    jmesh = Mesh(np.array(jax.devices()[:4]), ("y",))

    def local(fl):
        return jfft.spectral_apply_distributed(
            fl, lambda kx, ky: -(kx * kx + ky * ky))

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=jmesh, in_specs=P("y", None), out_specs=P("y", None),
        check_vma=False))(jnp.asarray(f)))
    mesh = LocalMesh(4, 1, device=CPU)
    out = fft.spectral_apply_distributed(
        mesh, _shards(mesh, f), lambda kx, ky: -(kx * kx + ky * ky))
    got = _gather(mesh, out)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())


def test_zero_mode_is_zeroed_on_its_shard():
    """The k = 0 mode lies on shard 0 (row 0, column 0 of its transposed
    spectrum); a constant field solves to 0."""
    mesh = LocalMesh(4, 1, device=CPU)
    syms = fft._poisson_symbols(32, 32, 4, (0, 1, 2, 3), 1.0, 1.0,
                                "laplacian5", CPU)
    assert float(syms[0][0, 0]) == 0.0
    assert all(bool((s != 0).all()) for s in syms[1:])
    got = fft.make_distributed_poisson(mesh, 32, 32, 1.0, 1.0)(
        torch.full((32, 32), 3.0))
    assert float(got.abs().max()) < 1e-5


def test_refusals():
    with pytest.raises(ValueError, match="make_distributed_poisson_2d"):
        fft.make_distributed_poisson(LocalMesh(2, 2, device=CPU), 16, 16,
                                     1.0, 1.0)
    with pytest.raises(ValueError, match="local rows divisible"):
        fft.make_distributed_poisson_2d(LocalMesh(2, 4, device=CPU), 12, 16,
                                        1.0, 1.0)
    with pytest.raises(ValueError, match="total device count"):
        fft.make_distributed_poisson_2d(LocalMesh(2, 2, device=CPU), 16, 18,
                                        1.0, 1.0)
    mesh = LocalMesh(4, 1, device=CPU)
    with pytest.raises(ValueError, match="nx=18 must divide"):
        fft.distributed_poisson_solve(mesh, [torch.zeros(4, 18)] * 4, 1.0,
                                      1.0)
    with pytest.raises(ValueError, match="must divide the local rows"):
        fft._pencilize(LocalMesh(1, 4, device=CPU), [torch.zeros(6, 4)] * 4)
