"""The port's framework shell held against the JAX package: pytree
dataclasses, configs, profiling, the platform layer, the sharded
checkpoint pair and the API gaps of the weather grid and shifts.

Everything runs on the CPU with inputs made by NumPy from fixed seeds.
Pytree leaves, configs, mesh shapes, shifts and dtype conversions are
compared for equality. The sharded checkpoint pair has no file format in
common with orbax's (the port writes ``torch.distributed.checkpoint``
files), so it is held to a bit-for-bit round trip, in this process and
over gloo in two processes, as ``tests/test_infra_io.py`` holds the JAX
pair.
"""
import dataclasses
import json
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
from torch.utils import _pytree  # noqa: E402

import njw_tpu.md.system as jmd  # noqa: E402
import njw_tpu.nbody.system as jnb  # noqa: E402
import njw_tpu.platform.device as jdev  # noqa: E402
from njw_tpu.utils import config as jconfig  # noqa: E402
from njw_tpu.weather import barotropic as jbaro  # noqa: E402
from njw_tpu.weather import dynamics as jdyn  # noqa: E402
from njw_tpu.weather import grid as jgrid  # noqa: E402
from njw_tpu.weather import icosa as jicosa  # noqa: E402
from njw_tpu.weather import model as jmodel  # noqa: E402
from njw_tpu.weather import nested as jnested  # noqa: E402
from njw_tpu.weather import primitive as jprim  # noqa: E402
from njw_tpu.weather import spherical as jsph  # noqa: E402

import njw_tpu_torch.md.system as tmd  # noqa: E402
import njw_tpu_torch.nbody.system as tnb  # noqa: E402
from njw_tpu_torch import platform as tplat  # noqa: E402
from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.utils import config as tconfig  # noqa: E402
from njw_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint_orbax, save_checkpoint_orbax,
)
from njw_tpu_torch.utils.profiling import (  # noqa: E402
    OpStats, Timer, time_jitted, trace,
)
from njw_tpu_torch.weather import barotropic as tbaro  # noqa: E402
from njw_tpu_torch.weather import dynamics as tdyn  # noqa: E402
from njw_tpu_torch.weather import grid as tgrid  # noqa: E402
from njw_tpu_torch.weather import icosa as ticosa  # noqa: E402
from njw_tpu_torch.weather import model as tmodel  # noqa: E402
from njw_tpu_torch.weather import nested as tnested  # noqa: E402
from njw_tpu_torch.weather import primitive as tprim  # noqa: E402
from njw_tpu_torch.weather import spherical as tsph  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------
# pytree_dataclass: the 11 classes of the API gap, and .replace
# --------------------------------------------------------------------------

def _arrays(rng, **shapes) -> dict:
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _weather(rng, pkg):
    a = _arrays(rng, u=(4, 4), v=(4, 4), h=(4, 4))
    if pkg == "jax":
        return jgrid.WeatherState(**{k: jnp.asarray(v) for k, v in a.items()})
    return tgrid.WeatherState(**{k: torch.from_numpy(v)
                                 for k, v in a.items()})


# name: (JAX class, port class, fields as NumPy or numbers, the field
# replaced)
PYTREE_CASES = {
    "GridSpec": (jgrid.GridSpec, tgrid.GridSpec,
                 lambda rng: {"nx": 8, "ny": 8}, "nx"),
    "BarotropicState": (jbaro.BarotropicState, tbaro.BarotropicState,
                        lambda rng: _arrays(rng, zeta=(6, 5)), "zeta"),
    "PEState": (jprim.PEState, tprim.PEState,
                lambda rng: _arrays(rng, u=(2, 4, 4), v=(2, 4, 4),
                                    T=(2, 4, 4), q=(2, 4, 4), ps=(4, 4)),
                "T"),
    "NestedState": (jnested.NestedState, tnested.NestedState, None,
                    "fine"),
    "IcosaOperators": (jicosa.IcosaOperators, ticosa.IcosaOperators,
                       lambda rng: {**_arrays(rng, w=(4, 10, 2, 2, 3),
                                              r=(10, 2, 2, 3),
                                              east=(10, 2, 2, 3),
                                              north=(10, 2, 2, 3)),
                                    "radius": np.float32(6.37122e6)},
                       "radius"),
    "IcosaSWEState": (jicosa.IcosaSWEState, ticosa.IcosaSWEState,
                      lambda rng: _arrays(rng, V=(10, 2, 2, 3),
                                          h=(10, 2, 2)), "h"),
    "SphericalBarotropicState": (
        jsph.SphericalBarotropicState, tsph.SphericalBarotropicState,
        lambda rng: _arrays(rng, zeta=(2, 5, 6)), "zeta"),
    "SphericalSWEState": (jsph.SphericalSWEState, tsph.SphericalSWEState,
                          lambda rng: _arrays(rng, zeta=(2, 5, 6),
                                              div=(2, 5, 6),
                                              phi=(2, 5, 6)), "div"),
    "NBodySystem": (jnb.NBodySystem, tnb.NBodySystem,
                    lambda rng: {**_arrays(rng, pos=(5, 3), vel=(5, 3),
                                           mass=(5,)),
                                 "G": 1.0, "softening": 1e-6}, "G"),
    "LJParams": (jmd.LJParams, tmd.LJParams,
                 lambda rng: _arrays(rng, epsilon=(2,), sigma=(2,)),
                 "sigma"),
    "Topology": (jmd.Topology, tmd.Topology,
                 lambda rng: {"bonds": np.array([[0, 1], [1, 2]]),
                              **_arrays(rng, bond_k=(2,), bond_r0=(2,))},
                 "bond_k"),
}


def _build(name, rng_seed=0):
    """(JAX instance, port instance, the field to replace, its new value
    for each) from the same seeded numbers."""
    jcls, tcls, fields, key = PYTREE_CASES[name]
    if name == "NestedState":
        j = jcls(coarse=_weather(np.random.default_rng(1), "jax"),
                 fine=_weather(np.random.default_rng(2), "jax"))
        t = tcls(coarse=_weather(np.random.default_rng(1), "torch"),
                 fine=_weather(np.random.default_rng(2), "torch"))
        return (j, t, key, _weather(np.random.default_rng(3), "jax"),
                _weather(np.random.default_rng(3), "torch"))
    f = fields(np.random.default_rng(rng_seed))
    jf = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in f.items()}
    tf = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
          for k, v in f.items()}
    new = f[key] * 2
    jnew = jnp.asarray(new) if isinstance(new, np.ndarray) else new
    tnew = torch.from_numpy(new) if isinstance(new, np.ndarray) else new
    return jcls(**jf), tcls(**tf), key, jnew, tnew


def _same_leaves(jobj, tobj):
    jl = jax.tree.leaves(jobj)
    tl = _pytree.tree_leaves(tobj)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


class TestPytree:
    @pytest.mark.parametrize("name", sorted(PYTREE_CASES))
    def test_replace_as_jax(self, name):
        j, t, key, jnew, tnew = _build(name)
        j2, t2 = j.replace(**{key: jnew}), t.replace(**{key: tnew})
        assert type(t2) is type(t) and getattr(t2, key) is tnew
        _same_leaves(j2, t2)
        _same_leaves(j, t)  # the original is untouched

    @pytest.mark.parametrize("name", sorted(PYTREE_CASES))
    def test_flatten_round_trip(self, name):
        _, t, *_ = _build(name)
        leaves, spec = _pytree.tree_flatten(t)
        back = _pytree.tree_unflatten(leaves, spec)
        assert type(back) is type(t)
        for a, b in zip(_pytree.tree_leaves(back), _pytree.tree_leaves(t)):
            assert a is b
        doubled = _pytree.tree_map(
            lambda x: x * 2 if isinstance(x, torch.Tensor) else x, t)
        assert type(doubled) is type(t)

    @pytest.mark.parametrize("name", sorted(PYTREE_CASES))
    def test_frozen(self, name):
        _, t, key, _, tnew = _build(name)
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(t, key, tnew)

    def test_none_fields_are_no_leaves(self):
        s = _weather(np.random.default_rng(0), "torch")
        assert s.p is None and len(_pytree.tree_leaves(s)) == 3
        back = _pytree.tree_unflatten(*_pytree.tree_flatten(s))
        assert back.p is None and back.T is None

    def test_static_fields_in_the_context(self):
        g = tgrid.GridSpec(nx=8, ny=6, bc="clamped")
        leaves, spec = _pytree.tree_flatten(g)
        assert leaves == [] and _pytree.tree_unflatten([], spec) == g

    def test_decorator_forms(self):
        from njw_tpu_torch.utils import pytree_dataclass, static_field

        @pytree_dataclass
        class A:
            x: torch.Tensor
            n: int = static_field(default=3)

        @pytree_dataclass(frozen=False)
        class B:
            y: torch.Tensor

        a = A(torch.ones(2))
        assert _pytree.tree_leaves(a)[0] is a.x and a.replace(n=4).n == 4
        b = B(torch.zeros(1))
        b.y = torch.ones(1)  # not frozen
        assert float(b.replace(y=torch.full((1,), 5.0)).y) == 5.0


def test_checkpoint_leaves_unchanged():
    """The npz checkpoint's leaf order is the dataclass field order, as
    before the states became pytrees (and JAX's flatten order)."""
    from njw_tpu_torch.utils.checkpoint import _leaves

    for name in ("PEState", "NestedState", "NBodySystem", "Topology"):
        j, t, *_ = _build(name)
        if name == "NBodySystem":
            t = t.replace(G=torch.tensor(1.0), softening=torch.tensor(1e-6))
        got = _leaves(t)
        want = _pytree.tree_leaves(t)
        assert len(got) == len(want) == len(jax.tree.leaves(j))
        assert all(a is b for a, b in zip(got, want))


# --------------------------------------------------------------------------
# config (tests/test_infra_misc.py:47-76 on the port)
# --------------------------------------------------------------------------

class TestConfig:
    def test_json_roundtrip_and_overrides(self, tmp_path):
        cfg = tmodel.SimConfig(grid_width=128, dt=0.02)
        p = tconfig.save_config(cfg, str(tmp_path / "cfg.json"))
        back = tconfig.load_config(tmodel.SimConfig, p, grid_height=64)
        assert back.grid_width == 128 and back.grid_height == 64
        assert back.dt == 0.02 and back.device == "cuda"

    def test_yaml_roundtrip(self, tmp_path):
        pytest.importorskip("yaml")
        cfg = tmodel.SimConfig(model="barotropic", device="cpu")
        p = tconfig.save_config(cfg, str(tmp_path / "cfg.yaml"))
        assert tconfig.load_config(tmodel.SimConfig, p) == cfg

    def test_unknown_key_raises(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text(json.dumps({"grid_width": 4, "warp_speed": 9}))
        with pytest.raises(ValueError, match="unknown config keys"):
            tconfig.load_config(tmodel.SimConfig, str(p))

    def test_cli_overrides_coerce_types(self):
        cfg = tmodel.SimConfig()
        out = tconfig.apply_cli_overrides(
            cfg, ["grid_width=512", "dt=0.5", "model=primitive",
                  "device=cpu"])
        assert out.grid_width == 512 and out.dt == 0.5
        assert out.model == "primitive" and out.device == "cpu"
        with pytest.raises(ValueError):
            tconfig.apply_cli_overrides(cfg, ["nope=1"])

    def test_same_as_jax(self, tmp_path):
        pairs = ["grid_width=96", "dt=0.25", "coriolis_f=1e-4",
                 "integration_method=euler", "max_steps=7"]
        j = jconfig.apply_cli_overrides(jmodel.SimConfig(), pairs)
        t = tconfig.apply_cli_overrides(tmodel.SimConfig(), pairs)
        jd = dataclasses.asdict(j)
        td = dataclasses.asdict(t)
        assert {k: td[k] for k in jd} == jd
        # a JAX config file loads into the port's SimConfig
        p = jconfig.save_config(j, str(tmp_path / "j.json"))
        assert tconfig.load_config(tmodel.SimConfig, p, device="cpu") == \
            dataclasses.replace(t, device="cpu")


# --------------------------------------------------------------------------
# profiling (tests/test_infra_misc.py:122-141 on the port)
# --------------------------------------------------------------------------

class TestProfiling:
    def test_timer_and_opstats(self):
        t = Timer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        assert t.counts["a"] == 2 and "a" in t.report()
        stats = OpStats()
        stats.record("stencil", (8, 128), 2.0)
        stats.record("stencil", (16, 128), 1.0)
        assert stats.best_key("stencil") == (16, 128)
        assert np.isnan(stats.average_ms("stencil", (1, 1)))

    def test_time_jitted_keys_as_jax(self):
        from njw_tpu.utils.profiling import time_jitted as j_time_jitted

        calls = []

        def f(x):
            calls.append(1)
            return x * 2

        m = time_jitted(f, torch.ones(8), repeats=3)
        jm = j_time_jitted(jax.jit(lambda x: x * 2), jnp.ones(8), repeats=3)
        assert set(m) == set(jm) == {"best_s", "mean_s", "repeats"}
        assert len(calls) == 4  # one warm-up, three timed
        assert 0 < m["best_s"] <= m["mean_s"] and m["repeats"] == 3

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(str(tmp_path / "tr")):
            torch.ones(16).cumsum(0)
        data = json.loads((tmp_path / "tr" / "trace.json").read_text())
        assert "traceEvents" in data


# --------------------------------------------------------------------------
# platform (tests/test_infra_misc.py:152-157 on the port; default_mesh)
# --------------------------------------------------------------------------

class TestPlatform:
    @pytest.mark.parametrize("n", range(1, 17))
    def test_default_mesh_factorisation_as_jax(self, n, monkeypatch):
        import jax.sharding

        monkeypatch.setattr(jdev.jax, "devices", lambda *a: list(range(n)))
        monkeypatch.setattr(jax.sharding, "Mesh",
                            lambda devs, names: tuple(devs.shape))
        want = jdev.default_mesh()
        assert tplat.mesh_shape(n) == want
        mesh = tplat.default_mesh(tplat.mesh_shape(n), device=CPU)
        assert isinstance(mesh, LocalMesh) and mesh.shape == want

    def test_default_mesh_shape_and_device(self):
        mesh = tplat.default_mesh((2, 3), device=CPU)
        assert mesh.shape == (2, 3) and mesh.device == torch.device("cpu")
        assert tplat.default_mesh(device=CPU).shape == (1, 1)

    def test_device_info(self):
        info = tplat.get_device_info(CPU)
        assert "generation" in info and info["num_devices"] >= 1
        assert isinstance(tplat.is_tpu_available(), bool)
        assert tplat.is_tpu_available() is jdev.is_tpu_available() is False

    def test_device_info_has_the_jax_keys(self):
        info = tplat.get_device_info(CPU)
        assert set(jdev.get_device_info()) <= set(info)
        assert info["platform"] == "cpu" and info["hbm_gb"] == 0.0
        assert info["vmem_bytes"] is None and info["ici_bandwidth_gbps"] is None
        assert info["peak_bf16_tflops"] == info["peak_bf16_tensor_tflops"]

    def test_tpu_names(self):
        caps = tplat.detect(CPU)
        assert caps.is_tpu is False and caps.generation == "cpu"
        assert tplat.hbm_bandwidth_gbps(CPU) is None
        with pytest.raises(NotImplementedError, match="TPU generation"):
            tplat.tpu_generation()
        with pytest.raises(NotImplementedError, match="VMEM"):
            tplat.stencil_block_shape(256, 256)

    def test_every_name_exported(self):
        import njw_tpu.platform as jplat

        names = {n for n in dir(jplat) if not n.startswith("_")} - {"device"}
        assert names <= set(dir(tplat))


# --------------------------------------------------------------------------
# the sharded checkpoint pair on torch.distributed.checkpoint
# --------------------------------------------------------------------------

def _vortex(n=32):
    cfg = tmodel.SimConfig(grid_width=n, grid_height=n, device=CPU)
    return tmodel.Simulation.from_config(cfg, "vortex", strength=2.0).state


def _assert_states_equal(a, b):
    assert type(a) is type(b)
    for (na, ta), (nb, tb_) in zip(a.items(), b.items()):
        assert na == nb and ta.dtype == tb_.dtype
        assert torch.equal(ta, tb_)


class TestShardedCheckpoint:
    def test_whole_state_round_trip(self, tmp_path):
        s = _vortex()
        p = save_checkpoint_orbax(str(tmp_path / "ck"), s, step=12,
                                  time=0.12, extra={"note": "r2"})
        back, meta = load_checkpoint_orbax(p, s)
        assert meta["step"] == 12 and meta["time"] == 0.12
        assert meta["extra"]["note"] == "r2"
        _assert_states_equal(back, s)

    def test_complex_leaves(self, tmp_path):
        rng = np.random.default_rng(4)
        z = [torch.from_numpy((rng.standard_normal((5, 6))
                               + 1j * rng.standard_normal((5, 6)))
                              .astype(np.complex64)) for _ in range(3)]
        s = tsph.SphericalSWEState(zeta=z[0], div=z[1], phi=z[2])
        back, _ = load_checkpoint_orbax(
            save_checkpoint_orbax(str(tmp_path / "ck"), s), s)
        _assert_states_equal(back, s)

    def test_local_mesh_round_trip(self, tmp_path):
        mesh = LocalMesh(2, 2, device=CPU)
        shards = mesh.shard_state(_vortex())
        p = save_checkpoint_orbax(str(tmp_path / "ck"), shards, step=3,
                                  mesh=mesh)
        back, meta = load_checkpoint_orbax(p, shards, mesh=mesh)
        assert meta["mesh"] == [2, 2] and meta["step"] == 3
        for a, b in zip(back, shards):
            _assert_states_equal(a, b)
        _assert_states_equal(mesh.gather_state(back), _vortex())

    def test_wrong_shard_count_raises(self, tmp_path):
        mesh = LocalMesh(2, 1, device=CPU)
        with pytest.raises(ValueError, match="shards"):
            save_checkpoint_orbax(str(tmp_path / "ck"), [_vortex()],
                                  mesh=mesh)

    def test_process_mesh_over_gloo(self, tmp_path):
        """Two gloo ranks of a ProcessMesh(2, 1) each write their own
        shard (a file each) and read it back bit for bit; a LocalMesh
        then reads both shards of the same checkpoint."""
        worker = textwrap.dedent('''
            import datetime, sys
            import torch, torch.distributed as dist
            from njw_tpu_torch.parallel import ProcessMesh
            from njw_tpu_torch.utils.checkpoint import (
                load_checkpoint_orbax, save_checkpoint_orbax)
            from njw_tpu_torch.weather import SimConfig, Simulation
            rank, store, ck = int(sys.argv[1]), sys.argv[2], sys.argv[3]
            dist.init_process_group("gloo", init_method="file://" + store,
                                    rank=rank, world_size=2,
                                    timeout=datetime.timedelta(seconds=120))
            cfg = SimConfig(grid_width=32, grid_height=32, device="cpu")
            s = Simulation.from_config(cfg, "vortex", strength=2.0).state
            mesh = ProcessMesh(2, 1, device="cpu")
            shards = mesh.shard_state(s)
            save_checkpoint_orbax(ck, shards, step=12, time=0.12,
                                  extra={"note": "gloo"}, mesh=mesh)
            back, meta = load_checkpoint_orbax(ck, shards, mesh=mesh)
            assert meta["step"] == 12 and meta["mesh"] == [2, 1]
            for (n, a), (_, b) in zip(back[0].items(), shards[0].items()):
                assert torch.equal(a, b), n
            dist.destroy_process_group()
        ''')
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")]))
        ck = tmp_path / "ck"
        procs = [subprocess.Popen(
            [sys.executable, "-c", worker, str(r), str(tmp_path / "store"),
             str(ck)], env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
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
        assert {"__0_0.distcp", "__1_0.distcp", ".metadata",
                "njw_meta.json"} <= set(os.listdir(ck))
        mesh = LocalMesh(2, 1, device=CPU)
        shards = mesh.shard_state(_vortex())
        back, meta = load_checkpoint_orbax(str(ck), shards, mesh=mesh)
        assert meta["extra"] == {"note": "gloo"}
        for a, b in zip(back, shards):
            _assert_states_equal(a, b)


# --------------------------------------------------------------------------
# API gaps 2 and 3: GridSpec.shape3, WeatherState.astype, make_shift_fn
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nx,ny,levels", [(8, 8, 1), (16, 12, 5),
                                          (5, 7, 40)])
def test_shape3_as_jax(nx, ny, levels):
    assert tgrid.GridSpec(nx=nx, ny=ny, levels=levels).shape3 == \
        jgrid.GridSpec(nx=nx, ny=ny, levels=levels).shape3


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_astype_as_jax(dtype):
    rng = np.random.default_rng(9)
    a = {k: rng.standard_normal((6, 7)).astype(np.float32)
         for k in ("u", "v", "h", "T")}
    j = jgrid.WeatherState(**{k: jnp.asarray(v) for k, v in a.items()})
    t = tgrid.WeatherState(**{k: torch.from_numpy(v) for k, v in a.items()})
    jc = j.astype(getattr(jnp, dtype))
    tc = t.astype(getattr(torch, dtype))
    assert tc.p is None and jc.p is None
    for k in a:
        np.testing.assert_array_equal(
            getattr(tc, k).float().numpy(),
            np.asarray(getattr(jc, k).astype(jnp.float32)))
        assert getattr(tc, k).dtype == getattr(torch, dtype)


SHIFTS = [(1, 0), (-1, 0), (2, 0), (-2, 0), (0, 1), (0, -1), (0, 2),
          (0, -2), (1, 1), (-1, 1)]


@pytest.mark.parametrize("bc", ["periodic", "clamped", "outflow",
                                "reflective"])
@pytest.mark.parametrize("dxi,dyi", SHIFTS)
def test_make_shift_fn_as_jax(bc, dxi, dyi):
    f = np.random.default_rng(11).standard_normal((3, 6, 7)).astype(
        np.float32)
    jshift, tshift = jdyn.make_shift_fn(bc), tdyn.make_shift_fn(bc)
    try:
        want = np.asarray(jshift(jnp.asarray(f), dxi, dyi))
    except ValueError as e:
        # the edge rule takes one cell; so does the port's
        with pytest.raises(ValueError, match=str(e)):
            tshift(torch.from_numpy(f), dxi, dyi)
        return
    np.testing.assert_array_equal(tshift(torch.from_numpy(f), dxi,
                                         dyi).numpy(), want)
