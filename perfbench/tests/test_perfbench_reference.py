"""The frozen references against the port's plain path, on the CPU at
small sizes: the initial states, the tendencies, RK4 and the snapshots
(SWE's vorticity and divergence with them), and the shard's window of
the PE reference against the whole domain's."""
import numpy as np
import pytest
import torch

from njw_tpu_torch.weather import dynamics, grid as wgrid, ics, primitive
from njw_tpu_torch.weather.model import SimConfig, Simulation
from perfbench.reference import pe, rk4, swe

SWE = dict(model="shallow_water", grid_width=72, grid_height=56, dx=1.0,
           dy=1.0, dt=0.001, coriolis_f=1e-4, integration_method="rk4",
           boundary_condition="periodic")
PE = dict(model="primitive", grid_width=40, grid_height=32, num_levels=6,
          dx=1e5, dy=1e5, dt=240.0, coriolis_f=1e-4,
          integration_method="rk4", boundary_condition="periodic")


def rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("params", [
    dict(strength=0.5, x_center=0.3, y_center=0.7),
    dict(strength=1.0, x_center=0.55, y_center=0.45)])
def test_swe_vortex_is_the_ports(params):
    g = wgrid.GridSpec(nx=72, ny=56)
    port = ics.make_initial_state("vortex", g, device="cpu", **params)
    ref = swe.vortex(56, 72, "cpu", **params)
    for k in swe.FIELDS:
        assert torch.equal(getattr(port, k), ref[k]), k


def test_swe_tendencies_match_the_ports():
    g = wgrid.GridSpec(nx=72, ny=56)
    s = ics.make_initial_state("vortex", g, device="cpu", strength=1.0)
    p = wgrid.PhysicsParams(coriolis_f=1e-4)
    port = dynamics.swe_tendencies(s, g, p)
    padded = rk4.pad_periodic({"u": s.u, "v": s.v, "h": s.h}, 1)
    ref = swe.tendency_fn(SWE)(padded)
    for k in swe.FIELDS:
        assert rel(getattr(port, k), ref[k]) < 1e-6, k


@pytest.mark.parametrize("interval", [10, 30])
def test_swe_snapshots_match_the_ports_plain_path(interval):
    params = dict(strength=0.8, x_center=0.4, y_center=0.6)
    sim = Simulation.from_config(SimConfig(**SWE, device="cpu",
                                           backend="plain"),
                                 "vortex", **params)
    sim.run(30, output_interval=interval)
    ref = list(swe.snapshots(SWE, "vortex", params, 30, interval, "cpu"))
    assert [s for s, _ in ref] == [p["step"] for p in sim.snapshots]
    for (_, r), p in zip(ref, sim.snapshots):
        for k in ("u", "v", "h", "vorticity", "divergence"):
            assert rel(p[k], r[k]) < 1e-6, k


def test_pe_initial_state_is_the_ports():
    g = wgrid.GridSpec(nx=40, ny=32, levels=6, dx=1e5, dy=1e5)
    params = dict(u_jet=5.0, perturb=0.5, seed=2**31 - 5)
    port = primitive.pe_initial_state(g, device="cpu", **params)
    ref = pe.baroclinic(32, 40, 6, "cpu", **params)
    for k in pe.FIELDS:
        assert torch.equal(getattr(port, k), ref[k]), k


def test_pe_tendencies_match_the_ports():
    g = wgrid.GridSpec(nx=40, ny=32, levels=6, dx=1e5, dy=1e5)
    s = primitive.pe_initial_state(g, device="cpu", u_jet=5.0, perturb=0.5,
                                   seed=3)
    port = primitive.pe_tendencies(s, g, wgrid.PhysicsParams(coriolis_f=1e-4))
    padded = rk4.pad_periodic(dict(s.items()), 1)
    ref = pe.tendency_fn(PE, 6, "cpu", torch.float32)(padded)
    for k in pe.FIELDS:
        assert rel(getattr(port, k), ref[k]) < 1e-5, k


def test_pe_snapshot_matches_the_ports_plain_path():
    params = dict(u_jet=5.0, perturb=0.5, seed=77)
    sim = Simulation.from_config(SimConfig(**PE, device="cpu",
                                           backend="plain"),
                                 "baroclinic", **params)
    sim.run(12, output_interval=12)
    ((step, r),) = list(pe.snapshots(PE, "baroclinic", params, 12, 12,
                                     "cpu"))
    assert step == sim.snapshots[-1]["step"] == 12
    for k in pe.FIELDS:
        assert rel(sim.snapshots[-1][k], r[k]) < 1e-4, k


def test_references_refuse_what_they_do_not_model():
    with pytest.raises(ValueError):
        swe.check_config({**SWE, "beta": 1e-3})
    with pytest.raises(ValueError):
        pe.check_config({**PE, "viscosity": 1e-4})
