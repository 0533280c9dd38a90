"""The primitive-equation core on a mesh through the port's own entry,
``Simulation.from_config(..., mesh=)``, on the CPU at a small size.

Each process's part of the domain is built alone and stepped by the
sharded stepper the backend rule picks; with the same operations in the
same order, the sharded run equals the whole-domain ``Simulation`` bit for
bit: on a ``LocalMesh`` in this process, and on a ``ProcessMesh`` of four
CPU processes over gloo. The assembled snapshot is held to the
benchmark's plain reference (``perfbench/reference/pe.py``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from njw_tpu_torch.parallel import LocalMesh  # noqa: E402
from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402
from njw_tpu_torch.weather.convert import shards_to_numpy  # noqa: E402
from njw_tpu_torch.weather.grid import GridSpec  # noqa: E402
from njw_tpu_torch.weather.primitive import pe_initial_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("u", "v", "T", "q", "ps")
PE = dict(model="primitive", grid_width=64, grid_height=64, num_levels=4,
          dx=1e5, dy=1e5, dt=240.0, coriolis_f=1e-4, device="cpu")
IC = dict(u_jet=5.0, perturb=0.5, seed=11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forecast(mesh=None, steps=5, **cfg):
    sim = Simulation.from_config(SimConfig(**{**PE, **cfg}), "baroclinic",
                                 mesh=mesh, **IC)
    sim.run(steps, output_interval=steps)
    return sim


def _fused_forecast(mesh=None, steps=5):
    """The kernel-backend forecast with K4 in place of K5: on a mesh the
    sharded fused stepper through ``halo.simulation_stepper``, else the
    whole-step stepper."""
    from njw_tpu_torch.ops.pe_stencil import make_pe_kernel_rk4_stepper
    from njw_tpu_torch.parallel import halo

    cfg = SimConfig(**PE, backend="kernel")
    sim = _forecast(mesh, steps=0, backend="kernel")
    grid, params = cfg.grid_spec(), cfg.physics()
    if mesh is None:
        stepper = make_pe_kernel_rk4_stepper(grid, params, cfg.dt,
                                             whole_step=True)
    else:
        shards = sim.state
        sim.state, stepper = halo.simulation_stepper(
            halo.sharded_pe_step_kernel_fused(grid, params, mesh,
                                              dt=cfg.dt), shards)
    sim.stepper, sim._carry = stepper, stepper.init(sim.state)
    sim.run(steps, output_interval=steps)
    return sim


def _equal(got: dict, want: dict) -> None:
    for name in FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


class TestLocalMesh:
    @pytest.mark.parametrize("backend,whole_step,name", [
        ("kernel", False, "pe_stage_local2d"),
        ("kernel", True, "pe_rk4_local2d"),
        ("auto", False, "sharded_pe_step"),
        ("plain", False, "sharded_pe_step")])
    def test_equals_the_whole_domain(self, backend, whole_step, name):
        """The backend's sharded stepper, and K4's fused form built
        through ``halo.simulation_stepper`` (the kernel backend takes K5),
        equal the whole-domain run bit for bit."""
        mesh = LocalMesh(2, 2, device="cpu")
        if whole_step:
            sim = _fused_forecast(mesh)
            want = _fused_forecast()
        else:
            sim = _forecast(mesh, backend=backend)
            want = _forecast(backend=backend)
        assert sim.stepper.name == name and isinstance(sim.state, list)
        snap = sim.snapshots[-1]
        assert snap["block"] == (0, 64, 0, 64) and snap["step"] == 5
        _equal(snap, want.snapshots[-1])

    def test_row_mesh_takes_the_one_dimensional_form(self):
        sim = _forecast(LocalMesh(4, 1, device="cpu"), backend="kernel")
        assert sim.stepper.name == "pe_stage_local"
        _equal(sim.snapshots[-1],
               _forecast(backend="kernel").snapshots[-1])

    def test_steps_in_chunks_equal_one_run(self):
        """A state the stepper returned is stepped in place; a state set
        from outside is loaded first."""
        mesh = LocalMesh(2, 2, device="cpu")
        a = _forecast(mesh, steps=6, backend="kernel")
        b = Simulation.from_config(SimConfig(**PE, backend="kernel"),
                                   "baroclinic", mesh=mesh, **IC)
        b.step(2)
        b.state = [s.map(torch.clone) for s in b.state]
        b.step(1)
        b.run(3, output_interval=3)
        _equal(b.snapshots[-1], a.snapshots[-1])


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_each_shard_is_its_slice_of_the_whole_state(shape):
    grid = GridSpec(nx=64, ny=48, levels=4)
    whole = pe_initial_state(grid, device="cpu", **IC)
    mesh = LocalMesh(*shape, device="cpu")
    sim = Simulation.from_config(
        SimConfig(**{**PE, "grid_height": 48}, backend="kernel"),
        "baroclinic", mesh=mesh, **IC)
    ly, lx = 48 // shape[0], 64 // shape[1]
    for (iy, ix), shard in zip(mesh.coords, sim.state):
        for name in FIELDS:
            got, want = getattr(shard, name), getattr(whole, name)
            assert torch.equal(
                got, want[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx])
            # built alone: no view into a whole-domain tensor
            assert got.untyped_storage().nbytes() == got.numel() * 4


def test_the_assembled_snapshot_is_the_reference_within_float32():
    """The parts of a ``ProcessMesh`` run are what a ``LocalMesh`` of one
    shard a part holds; ``shards_to_numpy`` puts them together and they
    agree with the plain reference to float32 rounding over 5 steps: 1e-4
    of each field's largest magnitude (the program reads 2.0e-5 on u; the
    float32 reference is itself 1.3-1.6e-5 from its float64 run here)."""
    from perfbench.reference import pe as ref

    mesh = LocalMesh(2, 2, device="cpu")
    sim = _forecast(mesh, backend="kernel")
    parts = []
    for j, (iy, ix) in enumerate(mesh.coords):
        part = {k: v[..., iy * 32:(iy + 1) * 32, ix * 32:(ix + 1) * 32]
                for k, v in sim.snapshots[-1].items()
                if isinstance(v, np.ndarray)}
        part["block"] = (iy * 32, (iy + 1) * 32, ix * 32, (ix + 1) * 32)
        parts.append(part)
    got = shards_to_numpy(parts[::-1])
    sim_cfg = {k: v for k, v in PE.items() if k != "device"}
    (step, want), = ref.snapshots(sim_cfg, "baroclinic", IC, 5, 5, "cpu")
    assert step == 5
    for name in FIELDS:
        w = want[name].numpy()
        gap = np.abs(got[name] - w).max() / np.abs(w).max()
        assert gap < 1e-4, (name, gap)
    with pytest.raises(ValueError, match="tile"):
        shards_to_numpy(parts[1:])


def test_without_a_mesh_the_one_card_path_is_unchanged():
    from njw_tpu_torch.ops.pe_stencil import make_pe_kernel_rk4_stepper

    cfg = SimConfig(**PE, backend="kernel")
    sim = Simulation.from_config(cfg, "baroclinic", **IC)
    assert sim.block is None and sim.stepper.name == "pe_rk4_kernel"
    sim.run(4, output_interval=4)
    assert "block" not in sim.snapshots[-1]
    s = pe_initial_state(cfg.grid_spec(), device="cpu", **IC)
    st = make_pe_kernel_rk4_stepper(cfg.grid_spec(), cfg.physics(), cfg.dt)
    carry = st.init(s)
    for _ in range(4):
        carry, s = st.step(carry, s, None)
    _equal(sim.snapshots[-1], s.to_numpy())


@pytest.mark.parametrize("cfg,ic,kw,match", [
    (dict(model="shallow_water"), "vortex", {}, "primitive"),
    (dict(grid_type="spherical_harmonic", grid_width=64, grid_height=32),
     "baroclinic", {}, "primitive"),
    (dict(boundary_condition="reflective", backend="kernel"), "baroclinic",
     {}, "periodic"),
    (dict(grid_width=63), "baroclinic", {}, "divisible"),
    (dict(integration_method="semi_implicit"), "baroclinic", {},
     "semi_implicit"),
    ({}, "baroclinic", {"orography": np.zeros((64, 64), np.float32)},
     "orography"),
])
def test_what_the_sharded_steppers_refuse_raises(cfg, ic, kw, match):
    with pytest.raises(ValueError, match=match):
        Simulation.from_config(SimConfig(**{**PE, **cfg}), ic,
                               mesh=LocalMesh(2, 2, device="cpu"), **kw)


# ---------------------------------------------------- ProcessMesh over gloo

_WORKER = textwrap.dedent('''
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from njw_tpu_torch.parallel import ProcessMesh
    from njw_tpu_torch.weather import SimConfig, Simulation
    torch.set_num_threads(1)
    rank, store, out, cfg, ic, shape = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], eval(sys.argv[4]),
        eval(sys.argv[5]), eval(sys.argv[6]))
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    sim = Simulation.from_config(SimConfig(**cfg), "baroclinic",
                                 mesh=ProcessMesh(*shape, device="cpu"), **ic)
    sim.run(5, output_interval=5)
    snap = sim.snapshots[-1]
    np.savez(out + f"{rank}.npz", block=np.array(snap["block"]),
             name=sim.stepper.name,
             **{k: v for k, v in snap.items() if isinstance(v, np.ndarray)})
    dist.destroy_process_group()
''')


@pytest.mark.parametrize("backend,shape,name", [
    ("kernel", (2, 2), "pe_stage_local2d"),
    ("kernel", (1, 4), "pe_stage_local2d"),
    ("auto", (2, 2), "sharded_pe_step")])
def test_process_mesh_over_gloo_equals_the_whole_domain(tmp_path, backend,
                                                        shape, name):
    """Four CPU processes, one shard each, over gloo (120 s each): the
    parts their snapshots hold, put together, equal the whole-domain
    ``Simulation`` bit for bit (rings of two and of four)."""
    cfg = {**PE, "backend": backend}
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO),
                                           os.environ.get("PYTHONPATH", "")]))
    out = str(tmp_path / "rank")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(tmp_path / "store"), out,
         repr(cfg), repr(IC), repr(shape)], env=env, cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
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
    parts = []
    for r in range(4):
        got = dict(np.load(f"{out}{r}.npz"))
        assert str(got.pop("name")) == name
        ly, lx = 64 // shape[0], 64 // shape[1]
        iy, ix = divmod(r, shape[1])
        assert tuple(got["block"]) == (iy * ly, iy * ly + ly, ix * lx,
                                       ix * lx + lx)
        got["block"] = tuple(int(b) for b in got["block"])
        parts.append(got)
    _equal(shards_to_numpy(parts), _forecast(backend=backend).snapshots[-1])
