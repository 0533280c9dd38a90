"""The port's latitude-sharded spectral cores (njw_tpu_torch.parallel.
sphere) held against the JAX package's (njw_tpu.parallel.sphere) and
against the port's whole-domain run, and the meshes' all_reduce_sum
against lax.psum.

JAX runs on its tests' 8 virtual CPU devices (tests/conftest.py); the
port on LocalMesh(D, 1, device='cpu') and, in the gloo case, on a
ProcessMesh of 4 CPU processes. The quadrature's partial sums are added
in another order than the whole domain's, so the sharded runs are held
to the JAX test's bound (tests/test_parallel_sphere.py:42: atol 1e-4 of
the scale after 4 RK4 steps; zeta and div share one scale, see
``_close_state``); the gloo processes to the LocalMesh run within 1e-6
(gloo adds the partials in its own order).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from njw_tpu.ops.sht import SphericalHarmonicTransform as JSHT  # noqa: E402
from njw_tpu.parallel import sphere as jsphere  # noqa: E402
from njw_tpu.weather import spherical as jsp  # noqa: E402

from njw_tpu_torch.ops.sht import SphericalHarmonicTransform  # noqa: E402
from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.parallel.sphere import (  # noqa: E402
    _PsumSHT, replicate, shard_sht, sharded_spherical_step,
)
from njw_tpu_torch.weather.spherical import (  # noqa: E402
    EARTH_OMEGA, bve_tendencies, rossby_haurwitz_bve, rossby_haurwitz_swe,
    swe_tendencies,
)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
STEPS, DT = 4, 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shts():
    return JSHT(32), SphericalHarmonicTransform(32, device=CPU)


def _close_state(got, want, msg=""):
    """atol 1e-4 of each field group's scale: zeta and div share one (a
    balanced state's div is orders below its zeta and carries the winds'
    rounding), phi has its own."""
    wind = max(np.abs(np.asarray(getattr(want, f))).max()
               for f in ("zeta", "div") if hasattr(want, f))
    for name, v in got.items():
        w = np.asarray(getattr(want, name))
        scale = (np.abs(w).max() if name == "phi" else wind) + 1e-30
        np.testing.assert_allclose(np.asarray(v) / scale, w / scale, rtol=0,
                                   atol=1e-4, err_msg=f"{msg} {name}")


def _states(core, j, t):
    if core == "bve":
        return jsp.rossby_haurwitz_bve(j), rossby_haurwitz_bve(t)
    return (jsp.rossby_haurwitz_swe(j, EARTH_OMEGA),
            rossby_haurwitz_swe(t, EARTH_OMEGA))


def _nu4(core):
    return 0.0 if core == "bve" else 1e15


@pytest.mark.parametrize("core", ["bve", "swe"])
@pytest.mark.parametrize("nd", [2, 4, 8])
def test_sharded_matches_jax_sharded(shts, core, nd):
    j, t = shts
    js0, ts0 = _states(core, j, t)
    jmesh = Mesh(np.array(jax.devices()[:nd]), ("lat",))
    jstep = jsphere.sharded_spherical_step(j, jmesh, core=core,
                                           omega=EARTH_OMEGA,
                                           nu4=_nu4(core), n_steps=STEPS)
    want = jsp.unpack_state(jstep(jsp.pack_state(js0),
                                  jsphere.shard_sht(j, jmesh),
                                  jnp.float32(DT)))
    mesh = LocalMesh(nd, 1, device=CPU)
    step = sharded_spherical_step(t, mesh, core=core, omega=EARTH_OMEGA,
                                  nu4=_nu4(core), n_steps=STEPS)
    got = step(replicate(ts0, mesh), DT)
    assert len(got) == nd
    _close_state(got[0], want, msg=f"{core} nd={nd}")
    # every shard holds the same replicated state
    for other in got[1:]:
        for name, v in other.items():
            assert torch.equal(v, getattr(got[0], name))
    # one reduction a tendency
    assert mesh.exchanges == 4 * STEPS


@pytest.mark.parametrize("core", ["bve", "swe"])
def test_sharded_matches_whole_domain(shts, core):
    """The same RK4 arithmetic (0.5 dt, dt / 6) on the whole domain."""
    _, t = shts
    s0 = (rossby_haurwitz_bve(t) if core == "bve"
          else rossby_haurwitz_swe(t, EARTH_OMEGA))
    tend = {"bve": bve_tendencies, "swe": swe_tendencies}[core]
    s = s0
    for _ in range(STEPS):
        k1 = tend(s, t, EARTH_OMEGA, _nu4(core))
        k2 = tend(s.map(lambda a, b: a + 300.0 * b, k1), t, EARTH_OMEGA,
                  _nu4(core))
        k3 = tend(s.map(lambda a, b: a + 300.0 * b, k2), t, EARTH_OMEGA,
                  _nu4(core))
        k4 = tend(s.map(lambda a, b: a + 600.0 * b, k3), t, EARTH_OMEGA,
                  _nu4(core))
        comb = k1.map(lambda a, b, c, d: a + 2 * b + 2 * c + d, k2, k3, k4)
        s = s.map(lambda a, c: a + 100.0 * c, comb)
    mesh = LocalMesh(4, 1, device=CPU)
    got = sharded_spherical_step(t, mesh, core=core, omega=EARTH_OMEGA,
                                 nu4=_nu4(core), n_steps=STEPS)(
        replicate(s0, mesh), DT)[0]
    _close_state(got, s, msg=core)


def test_slabs_are_the_whole_tables(shts):
    _, t = shts
    mesh = LocalMesh(4, 1, device=CPU)
    slabs = shard_sht(t, mesh)
    for name, full in t.tables.items():
        assert torch.equal(torch.cat([s.tables[name] for s in slabs], -1),
                           full)
    assert torch.equal(torch.cat([s.mu_grid for s in slabs]), t.mu_grid)
    assert [s.slab for s in slabs] == [(0, 8), (8, 16), (16, 24), (24, 32)]


class TestRefusals:
    def test_nlat_divisibility_guard(self):
        with pytest.raises(ValueError, match="divisible"):
            sharded_spherical_step(SphericalHarmonicTransform(30, device=CPU),
                                   LocalMesh(4, 1, device=CPU), core="bve",
                                   omega=EARTH_OMEGA)

    def test_lat_sharding_rejects_folded_tables(self):
        folded = SphericalHarmonicTransform(32, fold_parity=True, device=CPU)
        with pytest.raises(NotImplementedError, match="fold_parity"):
            shard_sht(folded, LocalMesh(4, 1, device=CPU))

    def test_two_d_mesh_refused(self, shts):
        with pytest.raises(ValueError, match=r"\(D, 1\) mesh"):
            shard_sht(shts[1], LocalMesh(2, 2, device=CPU))

    def test_global_mean_raises_on_a_slab(self, shts):
        mesh = LocalMesh(2, 1, device=CPU)
        with pytest.raises(NotImplementedError, match="slabs"):
            _PsumSHT(shard_sht(shts[1], mesh), mesh).global_mean(
                torch.ones(16, 64))

    def test_unknown_core(self, shts):
        with pytest.raises(ValueError, match="unknown core"):
            sharded_spherical_step(shts[1], LocalMesh(2, 1, device=CPU),
                                   core="pe", omega=EARTH_OMEGA)


@pytest.mark.parametrize("shape,axis", [((4, 1), "y"), ((2, 2), "x"),
                                        ((2, 4), ("y", "x")),
                                        ((8, 1), "y")])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_all_reduce_sum_matches_psum(shape, axis, dtype):
    """LocalMesh.all_reduce_sum against lax.psum on the same blocks, each
    shard's result the same tensor along a ring."""
    py, px = shape
    rng = np.random.default_rng(5)
    blocks = rng.standard_normal((py, px, 3, 5)).astype(np.float32)
    if dtype == np.complex64:
        blocks = (blocks + 1j * rng.standard_normal(blocks.shape)).astype(
            np.complex64)
    jmesh = Mesh(np.array(jax.devices()[:py * px]).reshape(py, px),
                 ("y", "x"))
    spec = P("y", "x")
    want = np.asarray(jax.jit(jax.shard_map(
        lambda b: lax.psum(b, axis), mesh=jmesh, in_specs=(spec,),
        out_specs=spec, check_vma=False))(jnp.asarray(blocks)))
    mesh = LocalMesh(py, px, device=CPU)
    got = mesh.all_reduce_sum(
        [torch.from_numpy(blocks[iy, ix].copy()) for iy, ix in mesh.coords],
        axis)
    for (iy, ix), g in zip(mesh.coords, got):
        np.testing.assert_allclose(g.numpy(), want[iy, ix], rtol=1e-6,
                                   atol=1e-6)
    assert mesh.exchanges == 1
    assert mesh.exchange_bytes == blocks.nbytes
    members = mesh.axis_members(mesh.coords[0], axis)
    assert all(got[mesh.index(c)] is got[0] for c in members)


# ---------------------------------------------------- ProcessMesh over gloo

_RUNS = textwrap.dedent('''
    import torch
    from njw_tpu_torch.ops.sht import SphericalHarmonicTransform
    from njw_tpu_torch.parallel.sphere import replicate, sharded_spherical_step
    from njw_tpu_torch.weather.spherical import (
        EARTH_OMEGA, rossby_haurwitz_bve, rossby_haurwitz_swe)

    def run(mesh):
        t = SphericalHarmonicTransform(32, device="cpu")
        res = {}
        for core, s0, nu4 in (("bve", rossby_haurwitz_bve(t), 0.0),
                              ("swe", rossby_haurwitz_swe(t, EARTH_OMEGA),
                               1e15)):
            step = sharded_spherical_step(t, mesh, core=core,
                                          omega=EARTH_OMEGA, nu4=nu4,
                                          n_steps=2)
            out = step(replicate(s0, mesh), 600.0)
            res.update({core + "_" + k: v.numpy()
                        for k, v in out[0].items()})
        return res
''')

_WORKER = _RUNS + textwrap.dedent('''
    import datetime, sys
    import numpy as np, torch.distributed as dist
    from njw_tpu_torch.parallel import ProcessMesh
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    got = run(ProcessMesh(4, 1, device="cpu"))
    np.savez(out + f"_{rank}.npz", **got)
    dist.destroy_process_group()
''')


def test_process_mesh_over_gloo_equals_local_mesh(tmp_path):
    """Four CPU processes over gloo, one latitude slab each, both cores
    over 2 RK4 steps: the ranks hold one state, within 1e-6 of the
    LocalMesh(4, 1) run's scale (the sums' order alone differs). Each
    process has 120 s."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "rank"
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
    ns: dict = {}
    exec(_RUNS, ns)
    want = ns["run"](LocalMesh(4, 1, device=CPU))
    first = np.load(f"{out}_0.npz")
    for r in range(4):
        got = np.load(f"{out}_{r}.npz")
        for k, v in want.items():
            # every rank holds the same reduced state ...
            np.testing.assert_array_equal(got[k], first[k])
            # ... which equals LocalMesh's to rounding: gloo's all_reduce
            # adds the four partials in its own order
            core = k.split("_")[0]
            scale = max(np.abs(want[f"{core}_{f}"]).max()
                        for f in ("zeta", "div") if f"{core}_{f}" in want)
            if k.endswith("phi"):
                scale = np.abs(v).max()
            np.testing.assert_allclose(got[k] / scale, v / scale, rtol=0,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
