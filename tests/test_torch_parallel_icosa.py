"""The port's panel-pair sharded icosahedral SWE (njw_tpu_torch.parallel.
icosa) held against the JAX package's (njw_tpu.parallel.icosa) and the
port's whole-domain run.

JAX runs on 5 of its tests' 8 virtual CPU devices; the port on
LocalMesh(5, 1, device='cpu') and, in the gloo case, on a ProcessMesh of
5 CPU processes. The pairs' halo is exactly the whole-domain halo; the
sharded step is held to the JAX test's bounds
(tests/test_parallel_icosa.py:94-97: h atol 1e-3, V atol 1e-5) and to
the port's whole-domain run of the same RK4 arithmetic bit for bit.
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
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from njw_tpu.parallel import icosa as jpi  # noqa: E402
from njw_tpu.weather import icosa as J  # noqa: E402

from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.parallel.icosa import (  # noqa: E402
    FROM_NEXT, FROM_PREVIOUS, from_pairs, pad_halo_pairs, shard_icosa,
    sharded_icosa_swe_step, to_pairs, unshard_state,
)
from njw_tpu_torch.weather.icosa import (  # noqa: E402
    EARTH_OMEGA, IcosaSWEState, build_operators, cell_centers,
    gaussian_hill, pad_halo, swe_tendencies_icosa, williamson2_icosa,
)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
N, STEPS, DT, NU = 8, 3, 600.0, 1e5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ops():
    return build_operators(N, device=CPU)


def _state(ops):
    base = williamson2_icosa(ops)
    return IcosaSWEState(V=base.V,
                         h=base.h + 50.0 * gaussian_hill(ops, lat0=0.4))


def test_pair_roundtrip():
    f = torch.arange(10 * 4 * 4, dtype=torch.float32).reshape(10, 4, 4)
    assert torch.equal(from_pairs(to_pairs(f)), f)
    np.testing.assert_array_equal(
        to_pairs(f).numpy(), np.asarray(jpi.to_pairs(jnp.asarray(f.numpy()))))


def test_ring_shift_sign_is_jax_fwd():
    """JAX's fwd pairs send k-1 -> k: with ring_shift(+1) shard k receives
    shard k-1's payload, with ring_shift(-1) shard k+1's."""
    mesh = LocalMesh(5, 1, device=CPU)
    payloads = [(torch.tensor([float(k)]),) for k in range(5)]
    prev = mesh.ring_shift(payloads, "y", FROM_PREVIOUS)
    nxt = mesh.ring_shift(payloads, "y", FROM_NEXT)
    assert [float(p[0]) for (p,) in prev] == [4.0, 0.0, 1.0, 2.0, 3.0]
    assert [float(p[0]) for (p,) in nxt] == [1.0, 2.0, 3.0, 4.0, 0.0]


@pytest.mark.parametrize("trail", [(), (3,)])
def test_pairs_halo_matches_whole_domain_and_jax(trail):
    """pad_halo_pairs (two ring exchanges + two local copies) equals the
    whole-domain 8-slice exchange and JAX's ppermute form in every slot
    the stencil reads."""
    c = cell_centers(N).astype(np.float32)
    f = c if trail else c[..., 0].copy()
    ref = pad_halo(torch.from_numpy(f)).numpy()
    mesh = LocalMesh(5, 1, device=CPU)
    pairs = to_pairs(torch.from_numpy(f))
    got = from_pairs(torch.stack(pad_halo_pairs(list(pairs), mesh))).numpy()
    jmesh = Mesh(np.array(jax.devices()[:5]), ("p",))
    jgot = np.asarray(jpi.from_pairs(jax.jit(jax.shard_map(
        lambda x: jpi.pad_halo_pairs(x[0])[None], mesh=jmesh,
        in_specs=(P("p"),), out_specs=P("p"), check_vma=False))(
            jpi.to_pairs(jnp.asarray(f)))))
    for want in (ref, jgot):
        np.testing.assert_array_equal(got[:, 1:-1, :], want[:, 1:-1, :])
        np.testing.assert_array_equal(got[:, :, 1:-1], want[:, :, 1:-1])
    assert mesh.exchanges == 2


def _whole_rk4(s, ops, dt, steps):
    """The sharded stepper's RK4 arithmetic (0.5 dt and dt / 6 rounded to
    float32) on the whole domain."""
    half = float(np.float32(0.5) * np.float32(dt))
    sixth = float(np.float32(dt) / np.float32(6.0))

    def rhs(x):
        return swe_tendencies_icosa(x, ops, omega=EARTH_OMEGA, nu=NU)

    for _ in range(steps):
        k1 = rhs(s)
        k2 = rhs(s.map(lambda a, k: a + half * k, k1))
        k3 = rhs(s.map(lambda a, k: a + half * k, k2))
        k4 = rhs(s.map(lambda a, k: a + dt * k, k3))
        comb = k1.map(lambda a, b, c, d: a + 2 * b + 2 * c + d, k2, k3, k4)
        s = s.map(lambda a, c: a + sixth * c, comb)
    return s


def test_sharded_step_matches_jax_and_whole_domain(ops):
    s0 = _state(ops)
    mesh = LocalMesh(5, 1, device=CPU)
    ops_p, st_p = shard_icosa(ops, s0, mesh)
    step = sharded_icosa_swe_step(ops_p, mesh, omega=EARTH_OMEGA, nu=NU,
                                  n_steps=STEPS)
    got = unshard_state(step(st_p, DT), mesh)
    # the whole-domain run: the same operations on the same cells
    whole = _whole_rk4(s0, ops, DT, STEPS)
    assert torch.equal(got.h, whole.h) and torch.equal(got.V, whole.V)
    # two ring exchanges a pad, 4 pads a tendency plus 8 for nu
    assert mesh.exchanges == 2 * (3 + 8) * 4 * STEPS
    # JAX's sharded step on its own operators and state
    jops = J.build_operators(N)
    jbase = J.williamson2_icosa(jops)
    js0 = J.IcosaSWEState(V=jbase.V, h=jbase.h + 50.0 * J.gaussian_hill(
        jops, lat0=0.4))
    jmesh = Mesh(np.array(jax.devices()[:5]), ("p",))
    jops_p, jst_p = jpi.shard_icosa(jops, js0, jmesh)
    jstep = jpi.sharded_icosa_swe_step(jmesh, omega=EARTH_OMEGA, nu=NU,
                                       n_steps=STEPS)
    want = jpi.unshard_state(jstep(jst_p, jops_p, jnp.float32(DT)))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.V.numpy(), np.asarray(want.V), rtol=0,
                               atol=1e-5)


def test_mesh_size_guard(ops):
    with pytest.raises(ValueError, match="5-shard"):
        sharded_icosa_swe_step([ops], LocalMesh(4, 1, device=CPU),
                               omega=EARTH_OMEGA)
    with pytest.raises(ValueError, match="5-shard"):
        shard_icosa(ops, _state(ops), LocalMesh(5, 2, device=CPU))


# ---------------------------------------------------- ProcessMesh over gloo

_RUNS = textwrap.dedent('''
    from njw_tpu_torch.parallel.icosa import (
        shard_icosa, sharded_icosa_swe_step, unshard_state)
    from njw_tpu_torch.weather.icosa import (
        EARTH_OMEGA, IcosaSWEState, build_operators, gaussian_hill,
        williamson2_icosa)

    def run(mesh):
        ops = build_operators(8, device="cpu")
        base = williamson2_icosa(ops)
        s0 = IcosaSWEState(V=base.V,
                           h=base.h + 50.0 * gaussian_hill(ops, lat0=0.4))
        ops_p, st_p = shard_icosa(ops, s0, mesh)
        step = sharded_icosa_swe_step(ops_p, mesh, omega=EARTH_OMEGA,
                                      nu=1e5, n_steps=2)
        return unshard_state(step(st_p, 600.0), mesh).to_numpy()
''')

_WORKER = _RUNS + textwrap.dedent('''
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from njw_tpu_torch.parallel import ProcessMesh
    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=5,
                            timeout=datetime.timedelta(seconds=120))
    got = run(ProcessMesh(5, 1, device="cpu"))
    if rank == 0:
        np.savez(out, **got)
    dist.destroy_process_group()
''')


def test_process_mesh_over_gloo_equals_local_mesh(tmp_path):
    """Five CPU processes over gloo, one panel pair each, 2 RK4 steps with
    viscosity: the gathered state equals the LocalMesh(5, 1) run bit for
    bit. Each process has 120 s."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "gathered.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"),
         str(out)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(5)]
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
    want = ns["run"](LocalMesh(5, 1, device=CPU))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
