"""Scaling harness: sharded-SWE throughput over shard counts, the
halo-overlap efficiency and the config-5 mesh-shape sweep.

Counterpart of ``njw_tpu/bench/scaling.py``, with the same functions and
row keys:

  strong scaling:  fixed global grid, more shards
  weak scaling:    fixed per-shard grid, more shards
  efficiency(N) = throughput(N) / (N * throughput(1))
  halo overlap  = t_no_exchange / t_full_step (1.0 = exchange fully hidden)

Every mesh here is a ``LocalMesh``: all shards of a run live on the
caller's one device (CUDA unless ``device='cpu'``), and each row names
the mesh kind and the device. Shards of one card are not chips: these
rows time the sharded code's own cost on one device (its exchanges,
copies and launches), not the 1 -> N chip scaling of the JAX package's
pod runs, which one card cannot measure.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import torch

from njw_tpu_torch.parallel.mesh import LocalMesh, Ready
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.weather.grid import GridSpec, PhysicsParams, WeatherState

SWE_TOL = 1e-5   # rtol = atol: tests/test_parallel_halo.py:58-129


def _mesh_for(n: int, device="cuda") -> LocalMesh:
    """n shards as the squarest (n // a, a) mesh, a <= sqrt(n)."""
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    return LocalMesh(n // a, a, device=device)


def _label(mesh) -> dict:
    dev = mesh.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"mesh_kind": type(mesh).__name__, "device": f"{dev} ({name})"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_step_fn(step_fn, shards, device, n_repeats: int = 3):
    """(best seconds of ``n_repeats`` calls after a warm one, the warm
    call's output), each call synchronised."""
    first = step_fn(shards)
    _sync(device)
    out, best = first, float("inf")
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        out = step_fn(out)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, first


def _finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for _, t in state.items())


def _swe_state(grid: GridSpec, device) -> WeatherState:
    from njw_tpu_torch.weather.ics import make_initial_state

    s0 = make_initial_state("vortex", grid, device=device, strength=2.0)
    return WeatherState(u=s0.u, v=s0.v, h=s0.h)


def swe_scaling_sweep(global_grid: int = 256, *, dt: float = 0.005,
                      steps_per_call: int = 10,
                      device_counts: Optional[list[int]] = None,
                      mode: str = "strong", device="cuda") -> list[dict]:
    """Sharded-SWE (``sharded_swe_step``, overlap) throughput over shard
    counts (default 1, 2, 4, 8). mode='strong': the global grid is fixed;
    'weak': each shard's grid is fixed at ``global_grid`` (the domain grows
    with N). Each row also has ``ok``: the first call's result is finite
    and, in strong mode, within the JAX sharded tests' 1e-5 of the first
    row's (``max_abs_diff_vs_first``)."""
    from njw_tpu_torch.parallel.halo import sharded_swe_step

    device = require_device(device)
    counts = device_counts or [1, 2, 4, 8]
    params = PhysicsParams(coriolis_f=1e-4)
    rows, base_tp, first = [], None, None
    for n in counts:
        mesh = _mesh_for(n, device)
        py, px = mesh.shape
        if mode == "strong":
            ny = nx = global_grid
        else:
            ny, nx = global_grid * py, global_grid * px
        grid = GridSpec(nx=nx, ny=ny)
        step = sharded_swe_step(grid, params, mesh, dt=dt,
                                n_steps=steps_per_call)
        t, out = _time_step_fn(step, mesh.shard_state(_swe_state(grid,
                                                                 device)),
                               device)
        got = mesh.gather_state(out)
        ok, diff = _finite(got), None
        if mode == "strong":
            if first is None:
                first = got
            diff = max(float((a - b).abs().max()) for (_, a), (_, b) in
                       zip(got.items(), first.items()))
            ok = ok and all(bool(torch.allclose(a, b, rtol=SWE_TOL,
                                                atol=SWE_TOL))
                            for (_, a), (_, b) in zip(got.items(),
                                                      first.items()))
        tp = ny * nx * steps_per_call / t
        if base_tp is None:
            base_tp = tp
        rows.append({
            "devices": n, "mesh": [py, px], "grid": [ny, nx],
            "seconds_per_call": t, "grid_points_per_second": tp,
            "scaling_efficiency": tp / (base_tp * n),
            "max_abs_diff_vs_first": diff, "ok": ok, **_label(mesh)})
    return rows


class _NoExchange(LocalMesh):
    """A ``LocalMesh`` whose exchanges give each shard its own payload:
    the same arithmetic and copies with no data moved between shards (the
    physics at the shard seams is wrong), the counterpart of the JAX
    harness replacing ``_ring_shift`` by the identity."""

    def ring_shift_start(self, payloads, axis, shift) -> Ready:
        return Ready(list(payloads))


def halo_overlap_efficiency(grid_size: int = 256, n_devices: int = 4,
                            dt: float = 0.005, n_steps: int = 10,
                            overlap: bool = True, device="cuda") -> dict:
    """The full sharded SWE step (halo exchange + stencil) against the same
    step on a mesh whose exchange moves nothing: the difference is the
    exchange's exposed time. ``ok``: the full run is finite and the
    efficiency in (0, 1]."""
    from njw_tpu_torch.parallel.halo import sharded_swe_step

    device = require_device(device)
    mesh = _mesh_for(n_devices, device)
    grid = GridSpec(nx=grid_size, ny=grid_size, bc="periodic")
    params = PhysicsParams(coriolis_f=1e-4)
    s0 = _swe_state(grid, device)

    full = sharded_swe_step(grid, params, mesh, dt=dt, n_steps=n_steps,
                            overlap=overlap)
    t_full, out = _time_step_fn(full, mesh.shard_state(s0), device)
    quiet = _NoExchange(*mesh.shape, device=device)
    nocomm = sharded_swe_step(grid, params, quiet, dt=dt, n_steps=n_steps,
                              overlap=overlap)
    t_nocomm, _ = _time_step_fn(nocomm, quiet.shard_state(s0), device)
    eff = min(t_nocomm / t_full, 1.0)
    return {
        "devices": mesh.size, "overlap": overlap, "t_full_s": t_full,
        "t_compute_only_s": t_nocomm,
        "exposed_comm_s": max(t_full - t_nocomm, 0.0),
        "overlap_efficiency": eff,
        "ok": _finite(mesh.gather_state(out)) and 0.0 < eff <= 1.0,
        **_label(mesh)}


def pe_mesh_shape_sweep(n_devices: int = 8, *, ny: int = 64, nx: int = 1024,
                        L: int = 6, dt: float = 10.0,
                        shapes: Optional[list] = None,
                        device="cuda") -> list[dict]:
    """Config-5 mesh-shape check: for each (py, px) with py * px =
    ``n_devices`` (default: px = 1, 2, 4, 8 where it divides), one step of
    the fused sharded PE stepper (``sharded_pe_step_kernel_fused``: K4 per
    shard on the card, its plain version on the CPU) against the
    whole-domain plain RK4 step, normalised by each field's largest value
    (``ok`` below 2e-4). Shapes the grid does not divide are skipped.

    ``collective_permutes_per_step`` and ``ici_payload_bytes_per_step``
    keep the JAX keys but hold the port's own counts, not XLA's: the
    mesh's exchanges in one step (one a direction and axis, every field of
    every shard in it) and the payload bytes its shards send."""
    from njw_tpu_torch.parallel.halo import sharded_pe_step_kernel_fused
    from njw_tpu_torch.weather.dynamics import make_tendency_fn
    from njw_tpu_torch.weather.integrators import make_stepper
    from njw_tpu_torch.weather.primitive import pe_initial_state

    device = require_device(device)
    shapes = shapes or [(n_devices // a, a) for a in (1, 2, 4, 8)
                        if a <= n_devices and n_devices % a == 0]
    grid = GridSpec(nx=nx, ny=ny, levels=L, dx=1e5, dy=1e5)
    params = PhysicsParams(coriolis_f=1e-4)
    s0 = pe_initial_state(grid, device=device, u_jet=10.0, perturb=0.5)
    stepper = make_stepper("rk4", make_tendency_fn("primitive", grid,
                                                   params))
    _, ref = stepper.step((), s0, dt)
    rows = []
    for py, px in shapes:
        if ny % py or nx % px:
            continue
        mesh = LocalMesh(py, px, device=device)
        step = sharded_pe_step_kernel_fused(grid, params, mesh, dt=dt,
                                            n_steps=1)
        shards = mesh.shard_state(s0)
        step(shards)            # the first call makes the padded blocks
        mesh.exchanges = mesh.exchange_bytes = 0
        out = mesh.gather_state(step(shards))
        maxdiff = 0.0
        for (name, a), (_, b) in zip(ref.items(), out.items()):
            scale = float(a.abs().max()) + 1e-30
            maxdiff = max(maxdiff, float((b - a).abs().max()) / scale)
        rows.append({
            "mesh": [py, px], "local_block": [ny // py, nx // px],
            "normalized_maxdiff": maxdiff, "ok": maxdiff < 2e-4,
            "collective_permutes_per_step": mesh.exchanges,
            "ici_payload_bytes_per_step": mesh.exchange_bytes,
            **_label(mesh)})
    return rows
