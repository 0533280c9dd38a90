"""The port's NetCDF-3 writer, output managers and checkpoints
(njw_tpu_torch.utils.netcdf3, njw_tpu_torch.weather.output,
njw_tpu_torch.utils.checkpoint) held against the JAX package's, and the
JAX package's own tests of them (tests/test_infra_io.py) run on the
port.

Both packages write the same NetCDF bytes for the same arrays, and a
checkpoint written by either loads into the other's state: the leaves are
the same arrays in the same order.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu.utils import checkpoint as jck  # noqa: E402
from njw_tpu.utils import netcdf3 as jnc  # noqa: E402
from njw_tpu.weather import SimConfig as JSimConfig  # noqa: E402
from njw_tpu.weather import Simulation as JSimulation  # noqa: E402
from njw_tpu.weather import nested as jnested  # noqa: E402
from njw_tpu.weather import output as jout  # noqa: E402

from njw_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, restore_simulation, save_checkpoint, save_simulation,
)
from njw_tpu_torch.utils.netcdf3 import read_netcdf, write_netcdf  # noqa: E402
from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402
from njw_tpu_torch.weather.__main__ import main as cli_main  # noqa: E402
from njw_tpu_torch.weather.nested import make_nested_sim  # noqa: E402
from njw_tpu_torch.weather.output import (  # noqa: E402
    FieldStatistics, OutputConfig, attach_output, create_output_manager,
)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(steps=0, **kw):
    cfg = SimConfig(grid_width=32, grid_height=32, dt=0.01, device=CPU, **kw)
    sim = Simulation.from_config(cfg, "vortex", strength=2.0)
    if steps:
        sim.step(steps)
    return sim


def _nc_arrays():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((6, 8)).astype(np.float32),
            rng.standard_normal((3, 6, 8)).astype(np.float32),
            np.arange(5, dtype=np.int32))


class TestNetCDF3:
    def test_roundtrip(self, tmp_path):
        h, T, _ = _nc_arrays()
        p = str(tmp_path / "snap.nc")
        write_netcdf(p, {"h": (("y", "x"), h),
                         "T": (("level", "y", "x"), T)},
                     {"y": 6, "x": 8, "level": 3},
                     global_attrs={"step": 7, "time": 1.5, "source": "x"})
        variables, dims, gatts = read_netcdf(p)
        assert open(p, "rb").read(4) == b"CDF\x01"
        assert dims == {"y": 6, "x": 8, "level": 3}
        np.testing.assert_array_equal(variables["h"][1], h)
        np.testing.assert_array_equal(variables["T"][1], T)
        assert variables["T"][0] == ("level", "y", "x")
        assert int(gatts["step"]) == 7 and gatts["source"] == "x"

    def test_same_bytes_as_jax(self, tmp_path):
        h, T, idx = _nc_arrays()
        args = ({"h": (("y", "x"), h), "T": (("level", "y", "x"), T),
                 "idx": (("n",), idx), "c": ((), np.float64(2.5))},
                {"y": 6, "x": 8, "level": 3, "n": 5})
        kw = dict(global_attrs={"step": 7, "time": 1.5, "title": "snap",
                                "w": [1.0, 2.0]},
                  var_attrs={"h": {"units": "m"}})
        a, b = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
        write_netcdf(a, *args, **kw)
        jnc.write_netcdf(b, *args, **kw)
        assert open(a, "rb").read() == open(b, "rb").read()
        # and each package reads the other's file
        mine, theirs = read_netcdf(b), jnc.read_netcdf(a)
        assert mine[1] == theirs[1]
        np.testing.assert_array_equal(mine[0]["T"][1], theirs[0]["T"][1])

    def test_scipy_reads_it(self, tmp_path):
        scipy_io = pytest.importorskip("scipy.io")
        p = str(tmp_path / "c.nc")
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        write_netcdf(p, {"a": (("y", "x"), a)}, {"y": 3, "x": 4})
        f = scipy_io.netcdf_file(p, "r", mmap=False)
        np.testing.assert_array_equal(np.asarray(f.variables["a"][:]), a)
        f.close()

    def test_shape_mismatch_raises(self, tmp_path):
        with pytest.raises(ValueError, match="shape"):
            write_netcdf(str(tmp_path / "x.nc"),
                         {"a": (("y",), np.zeros(3, np.float32))}, {"y": 4})


class TestOutputManagers:
    FIELDS = {"h": np.arange(12.0, dtype=np.float32).reshape(3, 4),
              "u": np.ones((3, 4), np.float32)}

    def _tensor_fields(self):
        return {k: torch.from_numpy(v) for k, v in self.FIELDS.items()}

    @pytest.mark.parametrize("fmt,ext", [("csv", "csv"), ("npz", "npz"),
                                         ("vtk", "vtk"), ("netcdf", "nc")])
    def test_writers_match_jax(self, tmp_path, fmt, ext):
        """Each manager writes the file JAX's writes for the same fields
        (tensors here, arrays there); the NetCDF files differ only in the
        'source' attribute."""
        m = create_output_manager(OutputConfig(path=str(tmp_path / "t"),
                                               format=fmt))
        p = m.write(self._tensor_fields(), step=3, time=0.03)
        jm = jout.create_output_manager(jout.OutputConfig(
            path=str(tmp_path / "j"), format=fmt))
        q = jm.write(dict(self.FIELDS), step=3, time=0.03)
        assert p.endswith(f"_00000003.{ext}") and m.written == [p]
        assert os.path.basename(p) == os.path.basename(q)
        if fmt in ("csv", "vtk"):
            assert open(p).read() == open(q).read()
        elif fmt == "npz":
            with np.load(p) as a, np.load(q) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        else:
            va, da, ga = read_netcdf(p)
            vb, db, gb = read_netcdf(q)
            assert da == db and ga["step"] == gb["step"]
            assert ga["source"] == "njw_tpu_torch"
            for k in vb:
                np.testing.assert_array_equal(va[k][1], vb[k][1])

    def test_vtk_header(self, tmp_path):
        m = create_output_manager(OutputConfig(path=str(tmp_path),
                                               format="vtk"))
        head = open(m.write(self._tensor_fields(), 0, 0.0)).read(200)
        assert "vtk DataFile" in head and "DIMENSIONS 4 3 1" in head

    @pytest.mark.parametrize("fmt", ["npz", "netcdf"])
    def test_field_selection(self, tmp_path, fmt):
        m = create_output_manager(
            OutputConfig(path=str(tmp_path), format=fmt, fields=["h"]))
        p = m.write(self._tensor_fields(), step=0, time=0.0)
        if fmt == "npz":
            with np.load(p) as d:
                assert "h" in d and "u" not in d
        else:
            assert list(read_netcdf(p)[0]) == ["h"]

    def test_netcdf_levels(self, tmp_path):
        m = create_output_manager(OutputConfig(path=str(tmp_path),
                                               format="netcdf"))
        T = torch.arange(24.0).reshape(2, 3, 4)
        variables, dims, _ = read_netcdf(m.write({"T": T}, 1, 0.1))
        assert dims == {"level": 2, "y": 3, "x": 4}
        np.testing.assert_array_equal(variables["T"][1], T.numpy())

    def test_unknown_format_raises(self, tmp_path):
        with pytest.raises(ValueError, match="unknown output format"):
            create_output_manager(OutputConfig(path=str(tmp_path),
                                               format="hdf9"))

    def test_attach_to_simulation(self, tmp_path):
        sim = _sim()
        manager, cb = attach_output(sim, OutputConfig(path=str(tmp_path),
                                                      format="npz"))
        sim.run(20, output_interval=10, callback=cb)
        assert len(manager.written) == 2
        with np.load(manager.written[-1]) as d:
            np.testing.assert_array_equal(d["h"], sim.state.h.numpy())
            assert "vorticity" in d


@pytest.mark.parametrize("arr", [
    np.array([[1.0, 2.0], [3.0, np.nan]], np.float32),
    np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32),
    np.full((2, 2), np.inf, np.float32)])
def test_field_statistics_match_jax(arr):
    got = FieldStatistics.of("h", torch.from_numpy(arr))
    want = jout.FieldStatistics.of("h", arr)
    assert vars(got) == vars(want)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        sim = _sim(10)
        p = save_checkpoint(str(tmp_path / "ck"), sim.state, step=10,
                            time=0.1, extra={"note": "x"})
        state, meta = load_checkpoint(p, like=sim.state)
        assert meta["step"] == 10 and meta["extra"]["note"] == "x"
        assert torch.equal(state.h, sim.state.h)
        assert meta["treedef"].startswith("WeatherState(u=*")

    def test_resume_continues_identically(self, tmp_path):
        a = _sim(10)
        p = save_simulation(str(tmp_path / "ck"), a)
        a.step(10)
        b = _sim(0)
        restore_simulation(p, b)
        assert b.step_count == 10 and b.time == pytest.approx(0.1)
        b.step(10)
        assert torch.equal(a.state.h, b.state.h)

    def test_resume_ab2_nested(self, tmp_path):
        """A carry-bearing nested run resumed from its checkpoint equals
        one resumed from the same state in memory (the carry starts anew
        from the state in both)."""
        kw = dict(grid_width=32, grid_height=32, dt=0.02, device=CPU,
                  integration_method="adams_bashforth")

        def nested():
            return make_nested_sim(Simulation, SimConfig(**kw), "vortex",
                                   patch=(8, 24, 8, 24), strength=2.0)

        a = nested()
        a.step(5)
        p = save_simulation(str(tmp_path / "n"), a)
        b = nested()
        restore_simulation(p, b)
        a._carry = a.stepper.init(a.state)
        a.step(5)
        b.step(5)
        assert torch.equal(a.state.fine.h, b.state.fine.h)
        assert torch.equal(a.state.coarse.u, b.state.coarse.u)

    def test_template_mismatch_raises(self, tmp_path):
        sim = _sim()
        p = save_checkpoint(str(tmp_path / "ck"), (sim.state.u, sim.state.v))
        with pytest.raises(ValueError, match="leaves"):
            load_checkpoint(p, like=(sim.state.u,))
        q = save_checkpoint(str(tmp_path / "ck2"), (sim.state.u[:4],))
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(q, like=(sim.state.u,))

    @pytest.mark.parametrize("model", ["shallow_water", "primitive",
                                       "nested"])
    def test_jax_checkpoint_loads_into_the_port(self, tmp_path, model):
        kw = dict(grid_width=32, grid_height=32, dt=0.01)
        if model == "primitive":
            kw.update(model="primitive", num_levels=3, dx=1e5, dy=1e5,
                      dt=60.0, coriolis_f=1e-4)
        ic = "baroclinic" if model == "primitive" else "vortex"
        if model == "nested":
            jsim = jnested.make_nested_sim(JSimulation, JSimConfig(**kw), ic,
                                           patch=(8, 24, 8, 24))
            sim = make_nested_sim(Simulation, SimConfig(device=CPU, **kw),
                                  ic, patch=(8, 24, 8, 24))
        else:
            jsim = JSimulation.from_config(JSimConfig(**kw), ic)
            sim = Simulation.from_config(SimConfig(device=CPU, **kw), ic)
        jsim.step(3)
        p = jck.save_simulation(str(tmp_path / "j"), jsim)
        restore_simulation(p, sim)
        assert sim.step_count == 3
        jl = jck.load_checkpoint(p)[0]
        mine = [t for _, t in sim.state.items()]
        assert len(mine) == len(jl)
        for t, a in zip(mine, jl):
            np.testing.assert_array_equal(t.numpy(), a)
        # and back: the port's checkpoint loads into the JAX state
        q = save_simulation(str(tmp_path / "t"), sim)
        state, meta = jck.load_checkpoint(q, like=jsim.state)
        assert meta["step"] == 3 and meta["extra"]["config"]["device"] == CPU
        import jax

        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(jsim.state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fmt,ext", [("netcdf", "nc"), ("csv", "csv")])
def test_cli_output_format(tmp_path, fmt, ext):
    out = tmp_path / "snaps"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--device", "cpu", "--width", "16", "--height", "16",
                       "--steps", "5", "--output-interval", "2",
                       "--output-format", fmt, "--output-dir", str(out),
                       "--json"])
    assert rc == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])[
        "num_steps"] == 4
    files = sorted(os.listdir(out))
    # the 4 steps after the warm-up step, in chunks of 2: steps 3 and 5
    assert files == [f"weather_00000003.{ext}", f"weather_00000005.{ext}"]
    if fmt == "netcdf":
        variables, dims, gatts = read_netcdf(str(out / files[-1]))
        assert dims == {"y": 16, "x": 16} and int(gatts["step"]) == 5
        assert {"u", "v", "h", "vorticity", "divergence"} <= set(variables)
