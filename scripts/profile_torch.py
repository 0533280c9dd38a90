#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes, on one GPU.

    python scripts/profile_torch.py [--model swe|barotropic|primitive|
                                     swe_bf16|swe_multistep|swe_si|pe_si|
                                     fir|pe_stage|baro_stage|plain_sharded|
                                     analysis|particles|imaging|finance|
                                     all]
                                    [--steps 50]

Runs each core's main path (``njw_tpu_torch.weather.main_paths``, the
configurations ``chip_smoke.py`` drives) through ``Simulation.from_config``
with backend auto, or one of its ``VARIANT_PATHS`` (the bf16 and multistep
SWE kernels, the semi-implicit SWE and PE steppers: the counterpart of
``scripts/measure_swe.py --variants``), and prints JSON lines, each with
the card's name and power limit:
  * ``profile``: device time by kernel name from ``torch.profiler`` over a
    steady window, grouped into the hand-written kernels, cuFFT and the
    remaining PyTorch kernels (matmuls apart from the elementwise rest;
    the SWE kernel's bf16 and multistep instantiations apart from K1);
    the device's busy share of the window; and the host time that
    enqueueing one step takes (no synchronise). A step of swe_multistep
    is one launch, two RK4 steps;
  * swe ``steps``: ms/step of backend kernel and backend plain (CUDA
    events), and ``sweep``: the fused kernel alone at 512^2 to 4096^2,
    with the bandwidth its 24 B/point minimum traffic implies;
    ``swe_parts``: K1 and K2 alone at 2048^2, the region loads alone
    (stages 0) and the first 1, 2, ... 4N stages (stores only at 4N), a
    copy of u, v, h (the same 24 B/point) beside them, and the built
    kernel's registers, spill bytes, shared bytes, threads, blocks per SM
    and layout; ``--parent-swe FILE`` adds ``swe_parent``: an earlier
    swe_rk4.cu built with the same nvcc flags into a temporary directory
    and timed beside the current kernel for K1, K1-bf16 and K2 at each
    size of the sweep, in turns (parent, new, new, parent), with the parts
    of K1 and K2 of both (where the earlier entry takes a stage count), a
    copy of the same bytes, each build's registers, warps an SM and shared
    bytes, and whether the two give equal outputs bit for bit; and
    ``swe_parent_padded``: the padded forms the same way at the main
    path's shard shapes. Kernel-alone times (``sweep``, ``swe_parts``,
    ``swe_parent``)
    let the device spin first while the host queues the launches, so that
    a kernel faster than its wrapper's host cost is still timed on the
    device;
  * primitive ``layouts``: the whole-step kernel K4 alone at config 4
    (the main path's shape) and config 5 (2048^2 x 40): its parts (the
    first 1, 2, 3 and 4 stages run alone), every layout worth timing
    (blocks per cluster, tile) with its blocks per SM and clusters on the
    card, its shared memory and ptxas report, beside the four-stage
    path's ms/step (CUDA events); ``levels_sweep``: ms/step on K4 (the
    rule's layout) and on the stage path at 512^2 for L from 8 to 454;
    and ``levels_accuracy``: K4 against its plain version by L on
    chip_smoke.py's limit case (37 x 23, flat and with terrain), beside
    chip_smoke.py's gate;
  * pe_stage (no path profile) ``pe_stage_study``: the stage kernel K5
    alone at config 4 (512^2 x 20) and at the config-5 shard shapes (512 x
    2048 and 1024^2 x 40: whole domain, local and local2d as the sharded
    stepper holds them), one base and four, at each tile height that fits
    (the rule's as ``new``), its top-down and bottom-up walks alone
    (PE_STAGE_PROBE builds), an L sweep at 512^2, and the built kernels'
    registers, spills, shared bytes and blocks per SM; ``--parent-pe-stage
    DIR`` builds an earlier pe_stage.cu (with its pe_column.cuh) with the
    same flags outside the repository and times it beside the current one
    in turns (parent, new, new, parent), with its walks alone (the source
    cut by text edits that must each apply once) and whether the outputs
    are equal bit for bit, and (``pe_rk4_parent``) checks K4 built from
    that directory against the current K4 bit for bit;
  * baro_stage (no path profile) ``baro_stage_study``: K3 alone at 512^2,
    1024^2 and 2048^2 (rotating buffers past L2) and on odd and sub-strip
    grids, at each strip it builds; ``--parent-baro FILE`` times an earlier
    baro_stage.cu beside it in turns, with its tile loads alone and an
    empty launch of its grid, and compares the outputs bit for bit;
  * fir ``profile``: the fir_batch path of
    ``njw_tpu_torch.signal.main_paths`` (FIRFilter.apply on 1000 x 100000,
    101 taps) called ``--steps`` times: device time by kernel, busy share
    and host enqueue per call; then ``fir_forms`` (or ``fir_parent`` with
    ``--parent-fir DIR``): K7 and K8 alone at the three FIR main paths'
    shapes for every precision (passes 0-3, taps_passes 1-2) beside a
    device copy of x, the current build beside its parts
    (``FIR_VARIANTS``: the streamed copy without products, the products
    without loads, the loads alone) and an earlier fir_band.cuh / .cu /
    _bf16.cu built outside the repository, in turns (parent first each
    turn), with the largest difference from the parent; ``fir_built``:
    registers, spills, shared bytes and blocks per SM of every build;
  * analysis ``profile``: each ``ANALYSIS_PATHS`` entry of
    ``njw_tpu_torch.signal.main_paths`` (the rest of the signal package,
    ``chip_smoke.py`` phase 17) called min(``--steps``, 20) times: device
    time by kernel group, busy share and host enqueue per call;
  * particles ``profile``: one step of each ``NBODY_PATHS`` and
    ``MD_PATHS`` entry (``njw_tpu_torch.nbody.main_paths``,
    ``njw_tpu_torch.md.main_paths``; ``chip_smoke.py`` phase 18), and one
    force evaluation a method of the force-only paths, each after two
    warm-up calls in a torch.profiler session of its own: device ms by
    kernel group (matmul, sort and search, gather and scatter, cuFFT,
    reductions, elementwise), the kernels a step, the slowest kernels,
    the wall and the host's enqueue;
  * imaging ``profile``: each call of each ``IMAGING_PATHS`` and
    ``GEO_PATHS`` entry (``njw_tpu_torch.medical.main_paths``,
    ``njw_tpu_torch.geospatial.main_paths``; ``chip_smoke.py`` phase 19)
    the same way, its kernels grouped as cuFFT, convolutions, matmuls,
    sorts and scans, gathers and scatters, reductions and elementwise;
  * finance ``profile``: each call of each ``FINANCE_PATHS`` entry
    (``njw_tpu_torch.geofinancial.main_paths``; ``chip_smoke.py`` phase
    20) the same way, and the device part of each call that reads the
    host, with the random draw as a group of its own; and the pipeline's
    fill_sinks and flow_accumulation alone;
  * plain_sharded (no path profile) ``plain_sharded``: one step of each
    ``PLAIN_SHARDED_PATHS`` entry on a LocalMesh, and of the SWE and PE
    ones with overlap off too: device ms by kind of PyTorch kernel, the
    kernels a step and their mean time, beside the wall ms a step and
    the host's enqueue.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from njw_tpu_torch.weather import GridSpec, make_initial_state  # noqa: E402
from njw_tpu_torch.weather.primitive import pe_initial_state  # noqa: E402
from njw_tpu_torch.weather.main_paths import (  # noqa: E402
    MAIN_PATHS, VARIANT_PATHS,
)

SWEEP_LEVELS = (8, 16, 20, 21, 22, 30, 40, 42, 43, 64, 84, 85, 120, 128, 144,
                160, 168, 192, 227, 256, 300, 340, 454)
ACCURACY_LEVELS = (20, 40, 87, 120, 168, 200, 227, 300, 340, 400, 454, 560,
                   688)
SPIN_CYCLES = 100_000_000   # ~50 ms at the H100's clock: see device_ms
SWEEP_GRIDS = (512, 1024, 2048, 4096)
HAND_WRITTEN = ("swe_rk4_kernel", "baro_stage_kernel", "pe_stage_kernel",
                "pe_rk4_kernel", "band_kernel")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def events_ms(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls, by CUDA events, the device
    first spinning while the host queues all n calls (as chip_smoke.py's
    _events_ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def group(name: str) -> str:
    swe = re.search(r"swe_rk4_kernel<(\d), (true|false)", name)
    if swe:
        return {("1", "false"): "swe_rk4_kernel",
                ("1", "true"): "swe_rk4_kernel_bf16",
                ("2", "false"): "swe_rk4_kernel_multi"}[swe.groups()]
    for kernel in HAND_WRITTEN:
        if kernel in name:
            return kernel
    if "fft" in name.lower():
        return "cufft"
    return "matmul" if "gemm" in name.lower() else "other_torch"


def device_ms_by_kernel(prof) -> dict[str, float]:
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    return by_name


def summary(by_name: dict[str, float], count: int, wall_ms: float,
            per: str) -> dict:
    """Device ms per step or call, by kernel group, and the busy share."""
    groups: dict[str, float] = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms / count
    device_ms = sum(by_name.values())
    return {f"wall_ms_per_{per}": wall_ms / count,
            f"device_ms_per_{per}": device_ms / count,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            f"device_ms_per_{per}_by_group": groups,
            "device_ms_by_kernel": by_name}


def profile_path(model: str, steps: int, gpu: str) -> dict:
    paths = VARIANT_PATHS if model in VARIANT_PATHS else MAIN_PATHS
    sim = paths[model].simulation()
    sim.step(3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(steps)  # ends in torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(10, synchronize=False)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    return {"phase": "profile", "card": gpu, "model": model,
            "stepper": sim.stepper.name, "steps": steps,
            **summary(by_name, steps, wall_ms, "step"),
            "host_enqueue_ms_per_step": enqueue_ms}


def torch_group(name: str) -> str:
    """The kind of a PyTorch kernel, by its name."""
    low = name.lower()
    for kind, keys in (("cufft", ("fft",)), ("cat", ("catarray",)),
                       ("reduce_scan", ("reduce", "scan")),
                       ("copy", ("copy",)),
                       ("elementwise", ("elementwise", "vectorized"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def plain_sharded(gpu: str) -> None:
    """One step of each ``PLAIN_SHARDED_PATHS`` entry on a LocalMesh on
    the card under torch.profiler (CUDA activity alone), and for SWE and
    PE the same step with overlap off: the device ms a step by kind of
    kernel (elementwise, cat, copy, reduce and scan, cuFFT), the kernels a
    step and their mean time, beside the wall ms a step (CUDA events over
    a few steps) and the host's enqueue of one."""
    from njw_tpu_torch.parallel import LocalMesh
    from njw_tpu_torch.weather.main_paths import PLAIN_SHARDED_PATHS

    for name, p in PLAIN_SHARDED_PATHS.items():
        forms = [p.options] + ([{"overlap": False}] if p.options else [])
        s0 = p.initial_state()
        for opts in forms:
            path = dataclasses.replace(p, options=opts, steps=1)
            mesh = LocalMesh(*path.mesh)
            step = path.make_stepper(mesh)
            shards = mesh.shard_state(s0)
            step(shards)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(shards)
                torch.cuda.synchronize()
            by_kind: dict[str, float] = {}
            kernels = 0
            for evt in prof.key_averages():
                if evt.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(evt, "self_device_time_total", 0.0)
                kind = torch_group(evt.key)
                by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
                kernels += evt.count
            device = sum(by_kind.values())
            # no spin ahead: the host's pace is what a step takes here
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            step.n_steps = 3
            torch.cuda.synchronize()
            start.record()
            step(shards)
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end) / 3
            step.n_steps = 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(shards)
            enqueue = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            print(json.dumps({
                "phase": "plain_sharded", "card": gpu, "path": name,
                "mesh": list(p.mesh), "options": opts,
                "wall_ms_per_step": wall, "host_enqueue_ms_per_step": enqueue,
                "device_ms_per_step": device,
                "device_busy_share": device / wall,
                "kernels_per_step": kernels,
                "mean_kernel_us": device * 1e3 / max(kernels, 1),
                "device_ms_by_kind": by_kind}), flush=True)
            del step, shards
        torch.cuda.empty_cache()


def profile_calls(call, args, calls: int) -> dict:
    """``calls`` calls of a signal path under torch.profiler: device ms
    by kernel group, busy share and host enqueue per call."""
    for _ in range(3):
        call(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)

    t0 = time.perf_counter()
    for _ in range(10):
        call(*args)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    return {"calls": calls, **summary(by_name, calls, wall_ms, "call"),
            "host_enqueue_ms_per_call": enqueue_ms}


def profile_fir(calls: int, gpu: str) -> dict:
    from njw_tpu_torch.signal.main_paths import MAIN_PATHS as SIGNAL_PATHS

    path = SIGNAL_PATHS["fir_batch"]
    return {"phase": "profile", "card": gpu, "model": "fir",
            "path": "fir_batch", "shape": list(path.shape),
            "taps": path.num_taps,
            **profile_calls(path.call(), (path.signal(),), calls)}


def profile_analysis(calls: int, gpu: str) -> None:
    """Each ANALYSIS_PATHS entry (chip_smoke.py phase 17) by kernel group."""
    from njw_tpu_torch.signal.main_paths import ANALYSIS_PATHS

    for name, path in ANALYSIS_PATHS.items():
        print(json.dumps({
            "phase": "profile", "card": gpu, "model": "analysis",
            "path": name, "shapes": [list(s) for s in path.shapes],
            **profile_calls(path.call("cuda"), path.inputs(), calls)}),
            flush=True)
        torch.cuda.empty_cache()


def particle_group(name: str) -> str:
    """The kind of a PyTorch kernel on the particle paths, by its name."""
    low = name.lower()
    for kind, keys in (("matmul", ("gemm", "cutlass")),
                       ("sort_search", ("sort", "radix", "searchsorted")),
                       ("gather_scatter", ("index", "scatter", "gather"))):
        if any(k in low for k in keys):
            return kind
    return torch_group(name)


def _profile_once(fn, gpu: str, model: str = "particles",
                  kind=particle_group, **row) -> None:
    """One call of fn() (a step, a force evaluation or an imaging call)
    after two warm-up calls, in a profiler session of its own: device ms
    by kernel group (``kind`` names a kernel's group), the kernels it
    ran, the wall and the host's enqueue."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)
    groups: dict[str, float] = {}
    for name, ms in by_name.items():
        groups[kind(name)] = groups.get(kind(name), 0.0) + ms
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    print(json.dumps({"phase": "profile", "card": gpu, "model": model,
                      **row, "wall_ms": wall_ms,
                      "device_ms": sum(by_name.values()),
                      "device_ms_by_group": groups, "kernels": kernels,
                      "host_enqueue_ms": enqueue_ms,
                      "top_kernels_ms": top}), flush=True)


def profile_particles(gpu: str) -> None:
    """One step of each NBODY_PATHS and MD_PATHS entry (chip_smoke.py
    phase 18), and one force evaluation a method of the force paths, each
    in a profiler session of its own."""
    from njw_tpu_torch.md.main_paths import MD_PATHS
    from njw_tpu_torch.nbody.main_paths import NBODY_PATHS

    for name, p in NBODY_PATHS.items():
        sim = p.simulation()
        _profile_once(lambda: sim.step(1, synchronize=False), gpu,
                      path=name, n=p.n, force_method=p.force_method)
        del sim
        torch.cuda.empty_cache()
    for name, p in MD_PATHS.items():
        if p.steps:
            sim = p.simulation()
            _profile_once(lambda: sim.step(1, synchronize=False), gpu,
                          path=name, atoms=sim.state.n,
                          cell_list=sim._force_fn.uses_cell_list)
            del sim
        else:
            st, topo, lj = p.make_system()
            for method, fn in p.force_fns(st, topo, lj).items():
                _profile_once(lambda: fn(st), gpu, path=name, atoms=st.n,
                              force_method=method)
            del st
        torch.cuda.empty_cache()


def imaging_group(name: str) -> str:
    """The kind of a PyTorch kernel on the imaging and terrain paths."""
    low = name.lower()
    for kind, keys in (("cufft", ("fft",)),
                       ("conv", ("conv", "cudnn", "implicit_gemm")),
                       ("matmul", ("gemm", "cutlass")),
                       ("sort_scan", ("sort", "radix", "scan", "cum")),
                       ("gather_scatter", ("index", "scatter", "gather"))):
        if any(k in low for k in keys):
            return kind
    return torch_group(name)


def profile_imaging(gpu: str) -> None:
    """Each call of each IMAGING_PATHS and GEO_PATHS entry (chip_smoke.py
    phase 19), each in a profiler session of its own."""
    from njw_tpu_torch.geospatial.main_paths import GEO_PATHS
    from njw_tpu_torch.medical.main_paths import IMAGING_PATHS

    for name, p in {**IMAGING_PATHS, **GEO_PATHS}.items():
        d = p.setup(torch.device("cuda"))
        for call, c in p.calls.items():
            _profile_once(lambda: c.fn(d), gpu, model="imaging",
                          kind=imaging_group, path=name, call=call)
        del d
        torch.cuda.empty_cache()


def finance_group(name: str) -> str:
    """The kind of a PyTorch kernel on the geo-financial paths: the
    random draw apart, matrix-vector products with the matmuls."""
    low = name.lower()
    if any(k in low for k in ("distribution", "normal", "philox", "randn")):
        return "rng"
    if "gemv" in low or "dot_kernel" in low:
        return "matmul"
    return imaging_group(name)


def profile_finance(gpu: str) -> None:
    """Each call of each FINANCE_PATHS entry (chip_smoke.py phase 20),
    each in a profiler session of its own, and the pipeline's flood
    factor split into its fill_sinks and flow_accumulation."""
    from njw_tpu_torch.geofinancial.main_paths import FINANCE_PATHS
    from njw_tpu_torch.geospatial.dem import fill_sinks, flow_accumulation

    for name, p in FINANCE_PATHS.items():
        d = p.setup(torch.device("cuda"))
        for call, c in p.calls.items():
            _profile_once(lambda: c.fn(d), gpu, model="finance",
                          kind=finance_group, path=name, call=call)
            if c.device_fn is not None:
                _profile_once(lambda: c.device_fn(d), gpu, model="finance",
                              kind=finance_group, path=name,
                              call=f"{call}:device_part")
        if "dem" in d:
            dem = torch.from_numpy(d["dem"]).cuda()
            filled = fill_sinks(dem, 128)
            _profile_once(lambda: fill_sinks(dem, 128), gpu,
                          model="finance", kind=finance_group, path=name,
                          call="risk_model:fill_sinks")
            _profile_once(lambda: flow_accumulation(filled, 128), gpu,
                          model="finance", kind=finance_group, path=name,
                          call="risk_model:flow_accumulation")
        del d
        torch.cuda.empty_cache()


def swe_extras(steps: int, gpu: str) -> None:
    from njw_tpu_torch.ops.stencil import swe_rk4_step_cuda

    path = MAIN_PATHS["swe"]
    per_step = {}
    for backend, n in (("kernel", steps), ("plain", 5)):
        s = path.simulation(backend=backend)
        s.step(2)
        # one chunk of n steps (one synchronize at its end), as Simulation.run does
        per_step[backend] = events_ms(lambda: s.step(n), 1) / n
    print(json.dumps({"phase": "steps", "card": gpu, "model": "swe",
                      "grid": path.config["grid_width"],
                      "ms_per_step": per_step}), flush=True)

    sweep = []
    for n in SWEEP_GRIDS:
        grid = GridSpec(nx=n, ny=n)
        s0 = make_initial_state("vortex", grid, device="cuda", strength=1.0)
        bufs = [(s0.u, s0.v, s0.h),
                tuple(torch.empty_like(t) for t in (s0.u, s0.v, s0.h))]
        turn = [0]

        def launch():
            swe_rk4_step_cuda(*bufs[turn[0]], out=bufs[1 - turn[0]],
                              grid=grid, dt=0.001, coriolis_f=1e-4)
            turn[0] ^= 1

        events_ms(launch, 10)
        ms = device_ms(launch, 200)
        sweep.append({"grid": n, "ms": ms,
                      "gbps_at_24B_per_point": 24 * n * n / (ms * 1e6)})
    print(json.dumps({"phase": "sweep", "card": gpu, "kernel": "swe_rk4",
                      "sizes": sweep}), flush=True)


SWE_GRID = 2048


def _swe_fields(n: int):
    s = make_initial_state("vortex", GridSpec(nx=n, ny=n), device="cuda",
                           strength=1.0)
    return (s.u, s.v, s.h)


def _swe_constants(grid, n_steps: int, bf16: bool = False) -> dict:
    from njw_tpu_torch.ops import stencil as st

    k = st.rk4_constants(grid, 0.001, 9.81, 1e-4, 0.0, bf16)
    if n_steps == 2:
        k["fused"] = 2
    return k


def _ping_pong_ms(launch, fields, reps: int = 200) -> float:
    """ms per launch(src, dst), two buffer sets in turn as the steppers
    use them."""
    a = tuple(t.clone() for t in fields)
    b = tuple(torch.empty_like(t) for t in fields)
    return _rotating_ms(launch, [(a, b), (b, a)], reps)


def swe_kernel_extras(gpu: str) -> None:
    """K1 and K2 alone at 2048^2: the loads alone, the first stages, the
    whole launch, and a copy of the same bytes."""
    from njw_tpu_torch.ops import stencil as st

    n = SWE_GRID
    grid = GridSpec(nx=n, ny=n)
    fields = _swe_fields(n)
    for n_steps in (1, 2):
        k = _swe_constants(grid, n_steps)

        def timed(stages):
            kk = dict(k, stages=stages)
            return _ping_pong_ms(
                lambda src, dst: st._launch(src, dst, (0, 0), kk), fields)

        parts = {stages: timed(stages) for stages in range(4 * n_steps + 1)}
        print(json.dumps({
            "phase": "swe_parts", "card": gpu, "grid": n,
            "steps_per_launch": n_steps,
            **st.swe_kernel_attributes(n_steps),
            "ms_by_stages": parts,
            "ms_per_stage": {s: parts[s] - parts[s - 1]
                             for s in range(1, 4 * n_steps + 1)},
            "copy_ms": _ping_pong_ms(
                lambda src, dst: [d.copy_(x) for x, d in zip(src, dst)],
                fields),
        }), flush=True)


# the padded forms at the shard shapes of the main path's 2048^2 on
# LocalMesh (4, 1) (local, carry) and (2, 2) (local2d): (form, interior
# rows, columns, halo (rows, columns))
SWE_PADDED = (("local", 512, 2048, (4, 0)), ("carry", 512, 2048, (4, 0)),
              ("local2d", 1024, 1024, (4, 4)))
SWE_FORMS = (("swe_rk4", 1, False), ("swe_rk4_bf16", 1, True),
             ("swe_rk4_multi", 2, False))


def _swe_entry(lib, source: str):
    """call(ins, out, k, interior, halo, out_oy) of a built swe_rk4.cu's C
    entry: ``ins`` the (padded) input blocks, ``out`` the output arrays
    whose interior rows start at row ``out_oy``. A source without the
    one-call entry ``swe_rk4_launch`` goes through the wrapper's own
    prepared launch (``stencil._launch``) on ``lib``; an entry without
    the stage count runs whole steps only."""
    sig = re.search(r'extern "C" int swe_rk4_launch\((.*?)\)', source, re.S)
    if sig is None:
        from njw_tpu_torch.ops import _build, stencil

        def prepared(ins, out, k, interior, halo=(0, 0), out_oy=0):
            load, _build.load = _build.load, lambda name: lib
            try:
                stencil._launch(ins, tuple(o[out_oy:out_oy + interior[0]]
                                           for o in out), halo, k)
            finally:
                _build.load = load
        return prepared, True
    staged = "stages" in sig.group(1)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn = lib.swe_rk4_launch
    fn.argtypes = ([P] * 3 + [L, I, I] + [P] * 3 + [L, I, I] + [I] * 4
                   + [F] * 10 + [I] * 3 + [F] * 2 + [I] * staged + [P])
    fn.restype = ctypes.c_int

    def call(ins, out, k, interior, halo=(0, 0), out_oy=0):
        (ny, nx), (hy, hx) = interior, halo
        n = k.get("fused", 1)
        stages = [k.get("stages", 4 * n)] if staged else []
        err = fn(*(t.data_ptr() for t in ins), ins[0].stride(0), hy, hx,
                 *(t.data_ptr() for t in out), out[0].stride(0), out_oy, 0,
                 ny, nx, int(hy > 0), int(hx > 0), k["cx"], k["cy"], k["g"],
                 k["f"], k["half"], k["dt"], k["sixth"], k["third"],
                 k["ix2"], k["iy2"], int(k["nu"] != 0.0), n,
                 int(k.get("bf16", 0)), k.get("bcx", 0.0), k.get("bcy", 0.0),
                 *stages, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"swe_rk4 launch failed ({err})")
    return call, staged


def _swe_built(lib, n_steps: int, bf16: bool, padded=(0, 0)) -> dict:
    """Registers, spill bytes, shared bytes, threads and warps an SM of a
    built swe_rk4.cu's instantiation for a form."""
    fn = lib.swe_rk4_attributes
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 6)()
    if fn(n_steps, int(bf16), int(padded[0]), int(padded[1]), vals):
        raise RuntimeError("swe_rk4_attributes failed")
    regs, local, smem, threads, per_sm, _ = vals
    return {"registers": regs, "local_bytes": local, "smem_bytes": smem,
            "threads": threads, "blocks_per_sm": per_sm,
            "warps_per_sm": threads // 32 * per_sm}


def _rotating_ms(launch, sets: list, reps: int = 200) -> float:
    """ms per launch(*set), cycling through ``sets`` (together larger than
    the 50 MB L2), the device spinning while the host queues."""
    turn = [0]

    def call():
        launch(*sets[turn[0]])
        turn[0] = (turn[0] + 1) % len(sets)

    events_ms(call, 10)
    return device_ms(call, reps)


def swe_parent(path: str, gpu: str) -> None:
    """An earlier swe_rk4.cu beside the current one, in one process:
    built with the same flags outside the repository, timed in turns
    (parent, new, new, parent) for K1, K1-bf16 and K2 at each size of the
    sweep and for the padded forms at the main path's shard shapes, with
    the parts of K1 and K2 (the loads alone, the first 1 .. 4N stages, the
    last with the stores) and a copy of the same bytes, each build's
    registers, warps an SM and shared bytes, and the outputs compared bit
    for bit."""
    from njw_tpu_torch.ops import _build

    text = Path(path).read_text()
    lib, log = _variant_lib(Path(path).parent, Path(path).stem, "parent")
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    old, staged = _swe_entry(lib, text)
    new, _ = _swe_entry(_build.load("swe_rk4"),
                        (_build.CSRC / "swe_rk4.cu").read_text())
    libs = {"parent": lib, "new": _build.load("swe_rk4")}
    calls = {"parent": old, "new": new}

    def compare(args_of, make_out):
        """Both builds on one input; equal bits and the largest gap."""
        outs = {}
        for who, call in calls.items():
            out = make_out()
            call(*args_of(out))
            outs[who] = out
        torch.cuda.synchronize()
        return {"equal_bit_for_bit": all(torch.equal(x, y) for x, y in
                                         zip(outs["parent"], outs["new"])),
                "max_abs_diff": max(float((x - y).abs().max()) for x, y in
                                    zip(outs["parent"], outs["new"]))}

    for n in SWEEP_GRIDS:
        grid = GridSpec(nx=n, ny=n)
        fields = _swe_fields(n)
        rows = {}
        for name, n_steps, bf16 in SWE_FORMS:
            k = _swe_constants(grid, n_steps, bf16)
            runs = {who: (lambda src, dst, call=call, k=k:
                          call(src, dst, k, (n, n)))
                    for who, call in calls.items()}
            times = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                times[who].append(_ping_pong_ms(runs[who], fields))
            row = {"parent_ms": times["parent"], "new_ms": times["new"],
                   "parent_ms_mean": sum(times["parent"]) / 2,
                   "new_ms_mean": sum(times["new"]) / 2,
                   **compare(lambda out, k=k: (fields, out, k, (n, n)),
                             lambda: tuple(torch.empty_like(t)
                                           for t in fields)),
                   "built": {who: _swe_built(lib_, n_steps, bf16)
                             for who, lib_ in libs.items()}}
            if not bf16:     # the parts: loads alone, then 1 .. 4N stages
                row["ms_by_stages"] = {
                    who: {s: _ping_pong_ms(
                        lambda src, dst, call=calls[who], s=s, k=k:
                        call(src, dst, dict(k, stages=s), (n, n)), fields)
                        for s in range(4 * n_steps + 1)}
                    for who in calls if who == "new" or staged}
            rows[name] = row
        copy_ms = _ping_pong_ms(
            lambda src, dst: [d.copy_(x) for x, d in zip(src, dst)], fields)
        print(json.dumps({"phase": "swe_parent", "card": gpu, "grid": n,
                          "parent_source": path, "parent_ptxas": regs,
                          "copy_ms": copy_ms, "rows": rows}), flush=True)
        del fields
    swe_parent_padded(calls, libs, gpu, path)


def swe_parent_padded(calls: dict, libs: dict, gpu: str, path: str) -> None:
    """The padded forms (halo-read blocks, one step of their interior) at
    the main path's shard shapes, parent and new in turns, on eight
    rotating sets of blocks, with the outputs compared bit for bit."""
    from njw_tpu_torch.ops.stencil import HALO

    grid_f = _swe_fields(SWE_GRID)
    for form, ly, lx, (hy, hx) in SWE_PADDED:
        k = _swe_constants(GridSpec(nx=lx, ny=ly), 1)
        cols = lx + 2 * hx

        def block(i, t):
            b = torch.full((ly + 2 * hy, cols), float("nan"), device="cuda")
            src = torch.roll(t, shifts=(i * 97, i * 31), dims=(0, 1))
            rows = torch.arange(-HALO, ly + HALO,
                                device="cuda") % SWE_GRID
            part = src.index_select(0, rows)
            if hx:
                part = part.index_select(1, torch.arange(
                    -HALO, lx + HALO, device="cuda") % SWE_GRID)
                b[hy - HALO:hy + ly + HALO,
                  hx - HALO:hx + lx + HALO] = part
            else:
                b[hy - HALO:hy + ly + HALO] = part[:, :lx]
            return b

        def out_of(i=0):
            shape = (ly + 2 * hy, lx) if form == "carry" else (ly, lx)
            return tuple(torch.empty(shape, device="cuda") for _ in range(3))

        sets = [(tuple(block(i, t) for t in grid_f), out_of())
                for i in range(8)]
        oy = hy if form == "carry" else 0
        runs = {who: (lambda ins, out, call=call:
                      call(ins, out, k, (ly, lx), (hy, hx), oy))
                for who, call in calls.items()}
        times = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            times[who].append(_rotating_ms(runs[who], sets))
        outs = {}
        for who, call in calls.items():
            out = out_of()
            call(sets[0][0], out, k, (ly, lx), (hy, hx), oy)
            outs[who] = tuple(o[oy:oy + ly] for o in out)
        torch.cuda.synchronize()
        print(json.dumps({
            "phase": "swe_parent_padded", "card": gpu, "form": form,
            "interior": [ly, lx], "halo": [hy, hx], "parent_source": path,
            "parent_ms": times["parent"], "new_ms": times["new"],
            "parent_ms_mean": sum(times["parent"]) / 2,
            "new_ms_mean": sum(times["new"]) / 2,
            "equal_bit_for_bit": all(torch.equal(x, y) for x, y in
                                     zip(outs["parent"], outs["new"])),
            "finite": all(bool(torch.isfinite(x).all())
                          for x in outs["new"]),
            "built": {who: _swe_built(lib, 1, False, (1, int(hx > 0)))
                      for who, lib in libs.items()}}), flush=True)
        del sets


def _k4_layouts(levels: int) -> list:
    """The whole-step kernel's layouts worth timing at ``levels``: each
    cluster size with the largest tile that fits."""
    from njw_tpu_torch.ops import pe_stencil as ps

    out = []
    for ncta in ps.RK4_CLUSTERS:
        if ncta > levels:
            continue
        tile = next((t for t in range(ps.RK4_TILE_MAX, 0, -1)
                     if ps.rk4_smem_bytes(levels, t, ncta)
                     <= ps.SMEM_PER_BLOCK), None)
        if tile is None:
            continue
        out.append(ps.Rk4Layout(ncta, tile))
    return out


def primitive_extras(gpu: str) -> None:
    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.ops import pe_stencil as ps
    from njw_tpu_torch.weather.main_paths import SHARDED_PATHS

    path = MAIN_PATHS["primitive"]
    config5 = SHARDED_PATHS["pe5_fused_2x2"].sim_config()
    ptxas = [ln.strip() for ln in _build.build_log("pe_rk4").splitlines()
             if "registers" in ln or "spill" in ln]
    for cfg in (path.sim_config(device="cuda"),
                dataclasses.replace(config5, device="cuda")):
        grid, params = cfg.grid_spec(), cfg.physics()
        s = pe_initial_state(grid, device="cuda", **path.ic_params)
        k = ps.column_constants(grid, float(params.coriolis_f))
        r = ps.rk4_constants(cfg.dt)
        levc = ps.level_constants(grid.levels, "cuda")
        out = s.map(torch.empty_like)
        reps = max(2, int(2e7 / (grid.levels * grid.ny * grid.nx)))

        def timed(layout, stages):
            def launch():
                ps._launch_rk4(s, out, None, grid, k, r, levc, layout,
                               stages=stages)

            events_ms(launch, 2)
            return events_ms(launch, reps)

        default = ps.rk4_layout(grid.levels)
        # the parts: the first n stages alone (no output written), so
        # stage n costs parts[n] - parts[n - 1]
        parts = {n: timed(default, n) for n in (1, 2, 3, 4)}
        by_layout = []
        for lay in _k4_layouts(grid.levels):
            blocks, clusters = ps.rk4_occupancy(grid.levels, lay, 0)
            by_layout.append({**lay._asdict(), "blocks_per_sm": blocks,
                              "clusters_on_card": clusters,
                              "ms": timed(lay, 4)})
        stages = ps.make_pe_kernel_rk4_stepper(grid, params, cfg.dt,
                                               whole_step=False)
        carry, state = stages.init(s), s.map(torch.clone)

        def stage_step():
            nonlocal carry, state
            carry, state = stages.step(carry, state, None)

        events_ms(stage_step, 2)
        blocks, clusters = ps.rk4_occupancy(grid.levels, default, 0)
        print(json.dumps({
            "phase": "layouts", "card": gpu, "model": "primitive",
            "shape": [grid.levels, grid.ny, grid.nx],
            "layout": default._asdict(),
            "smem_bytes": ps.rk4_smem_bytes(grid.levels, default.tile,
                                            default.ncta),
            "blocks_per_sm": blocks, "clusters_on_card": clusters,
            "ptxas": ptxas,
            "whole_step_ms_by_stages_run": parts,
            "whole_step_ms_by_layout": by_layout,
            "stage_path_ms_per_step": events_ms(stage_step, reps)}),
            flush=True)
        del s, out, carry, state
        torch.cuda.empty_cache()

    # the auto choice's evidence: K4 against the stage path over L at the
    # main path's grid
    sweep = []
    for levels in SWEEP_LEVELS:
        cfg = path.sim_config(device="cuda", num_levels=levels)
        grid, params = cfg.grid_spec(), cfg.physics()
        s = pe_initial_state(grid, device="cuda", **path.ic_params)
        times = {}
        for whole_step in (True, False):
            st = ps.make_pe_kernel_rk4_stepper(grid, params, cfg.dt,
                                               whole_step=whole_step)
            carry, state = st.init(s), s.map(torch.clone)

            def step():
                nonlocal carry, state
                carry, state = st.step(carry, state, None)

            events_ms(step, 2)
            times[st.name] = events_ms(step, 10)
        sweep.append({"levels": levels,
                      "layout": ps.rk4_layout(levels)._asdict(),
                      "ms_per_step": times,
                      "whole_step_over_stages":
                          times["pe_rk4_kernel_fused"]
                          / times["pe_rk4_kernel"]})
        del s, carry, state
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "levels_sweep", "card": gpu,
                      "model": "primitive", "grid": [grid.ny, grid.nx],
                      "rows": sweep}), flush=True)

    # where K4 holds chip_smoke.py's gate (rtol 1e-5, atol 1e-4 and 2e-4
    # with terrain) against its plain version: one step of chip_smoke.py's
    # limit case (37 x 23, its seeded noisy state and mountain) by L
    rows = []
    for levels in ACCURACY_LEVELS:
        cfg = path.sim_config(device="cuda", num_levels=levels,
                              grid_width=23, grid_height=37)
        grid = cfg.grid_spec()
        row = {"levels": levels, "layout": ps.rk4_layout(levels)._asdict()}
        for terrain, atol in ((False, 1e-4), (True, 2e-4)):
            phi_s = _mountain(grid) if terrain else None
            s = _noisy_state(grid, 1, phi_s, path.ic_params)
            kw = dict(grid=grid, dt=cfg.dt, coriolis_f=cfg.coriolis_f,
                      phi_s=phi_s)
            got = ps.pe_rk4_step_cuda(s, **kw)
            want = ps.pe_rk4_step_plain(s, **kw)
            err = max(float((a - b).abs().max())
                      for (_, a), (_, b) in zip(got.items(), want.items()))
            ok = all(bool(((a - b).abs() <= atol + 1e-5 * b.abs()).all())
                     for (_, a), (_, b) in zip(got.items(), want.items()))
            key = "terrain" if terrain else "flat"
            row[f"max_abs_err_{key}"], row[f"gate_{key}"] = err, ok
        rows.append(row)
    print(json.dumps({"phase": "levels_accuracy", "card": gpu,
                      "model": "primitive", "grid": [37, 23],
                      "rows": rows}), flush=True)


def _noisy_state(grid, seed, phi_s, ic_params):
    """chip_smoke.py's PE kernel state: the initial state with noise on the
    winds and T, from ``seed``."""
    s = pe_initial_state(grid, device="cuda", seed=seed, phi_s=phi_s,
                         **ic_params)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noise(t, amp):
        return t + amp * torch.randn(t.shape, device="cuda", generator=gen)

    return dataclasses.replace(s, u=noise(s.u, 1.0), v=noise(s.v, 1.0),
                               T=noise(s.T, 0.5))


def _mountain(grid, height=1500.0):
    """chip_smoke.py's mountain: a Gaussian of ``height`` m at the centre."""
    y = torch.arange(grid.ny, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(grid.nx, device="cuda", dtype=torch.float32)[None, :]
    cy, cx = (grid.ny - 1) / 2, (grid.nx - 1) / 2
    sy, sx = max(grid.ny / 8, 1), max(grid.nx / 8, 1)
    return (height * torch.exp(-(((y - cy) / sy) ** 2
                                 + ((x - cx) / sx) ** 2))).contiguous()


# ------------------------------------------------ K5 and K3 beside a parent

def _variant_lib(src_dir, name: str, tag: str, edits=(), defines=()):
    """Build ``<src_dir>/<name>.cu`` (with the ``*.cuh`` beside it) with the
    kernels' nvcc flags into a temporary directory, after ``edits`` ((file,
    old text, new text), each old text occurring exactly once) and with
    ``defines`` (-D flags). Returns (library, ptxas report)."""
    import shutil
    import tempfile

    from njw_tpu_torch.ops import _build

    tmp = Path(tempfile.mkdtemp(prefix=f"{name}_{tag}_"))
    for f in Path(src_dir).iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp / f.name)
    for fname, old, new in edits:
        text = (tmp / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} occurs {text.count(old)} "
                               f"times in {fname}, not once")
        (tmp / fname).write_text(text.replace(old, new))
    so = tmp / f"lib{name}_{tag}.so"
    build = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                            *defines, "-o", str(so), str(tmp / f"{name}.cu")],
                           capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"{tag} build failed:\n{build.stderr}")
    return ctypes.CDLL(str(so)), build.stdout + build.stderr


def ptxas_entries(log: str) -> dict:
    """{entry: registers, spill bytes, static shared bytes} of a ptxas
    report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def blocks_per_sm(registers: int, threads: int, smem_bytes: int) -> int:
    """Resident blocks an SM of the H100 takes, from a kernel's registers
    a thread, threads a block and shared bytes a block (65,536 registers
    allocated 256 a warp, 233,472 shared bytes with 1 KB reserved a block,
    2048 threads, 32 blocks)."""
    warps = -(-threads // 32)
    regs_warp = -(-registers * 32 // 256) * 256
    by_regs = 65536 // (warps * regs_warp) if registers else 32
    by_smem = 233472 // (smem_bytes + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


@contextlib.contextmanager
def _bound_to(name: str, lib, argtypes: list, drop: int = None):
    """Route ``_build.bind(name, ...)`` (the wrappers' launch) to ``lib``
    while the block runs; ``drop``: the index of an argument the wrappers
    pass and ``lib``'s entry does not take."""
    from njw_tpu_torch.ops import _build

    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    if drop is None:
        fn.argtypes, launch = argtypes, fn
    else:
        fn.argtypes = argtypes[:drop] + argtypes[drop + 1:]

        def launch(*a):
            return fn(*a[:drop], *a[drop + 1:])
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    before = _build._bound.get(name)
    _build._bound[name] = (launch, err)
    try:
        yield
    finally:
        if before is None:
            _build._bound.pop(name, None)
        else:
            _build._bound[name] = before


def _in_turns(runs: dict, reps: int) -> dict:
    """ms a call of each of ``runs`` ({who: fn}), timed in turns (a, b, b,
    a for two), the device spinning while the host queues."""
    order = list(runs) + list(runs)[::-1]
    times = {who: [] for who in runs}
    for fn in runs.values():
        device_ms(fn, 2)
    for who in order:
        times[who].append(device_ms(runs[who], reps))
    return {who: {"ms": t, "ms_mean": sum(t) / len(t)}
            for who, t in times.items()}


def _same(a: list, b: list) -> dict:
    torch.cuda.synchronize()
    return {"equal_bit_for_bit": all(torch.equal(x, y) for x, y in zip(a, b)),
            "max_abs_diff": max(float((x - y).abs().max())
                                for x, y in zip(a, b))}


# parts of the parent pe_stage.cu (one thread a column walking device
# memory, 32 x 4 threads a block): the bottom-up walk cut to no level
# leaves the top-down one and the stores of out.ps; the top-down walk cut
# to no level leaves the bottom-up one (cum unset)
PE_PARENT_PARTS = {
    "top_down": [("pe_column.cuh", "for (int kk = L - 1; kk >= 0; --kk) {",
                  "for (int kk = L - 1; kk >= L; --kk) {")],
    "bottom_up": [("pe_column.cuh", "for (int kk = 0; kk < L; ++kk) {",
                   "for (int kk = 0; kk < 0; ++kk) {")],
}
# the current source's probe (PE_STAGE_PROBE: 1 the top-down walk alone,
# 2 the bottom-up walk alone)
PE_PARTS = {"top_down": ["-DPE_STAGE_PROBE=1"],
            "bottom_up": ["-DPE_STAGE_PROBE=2"]}
PE_LEVELS = (20, 40, 80, 454)
PE_SHAPES = (  # form, (L, ly, lx), halo
    ("whole", (20, 512, 512), (0, 0)),
    ("whole", (40, 512, 2048), (0, 0)),
    ("whole", (40, 1024, 1024), (0, 0)),
    ("local", (40, 512, 2048), (1, 0)),
    ("local2d", (40, 1024, 1024), (1, 1)),
)


def _pe_padded_case(L: int, ly: int, lx: int, halo: tuple, nbase: int):
    """cur: a padded (L, ly + 2 hy, lx + 2 hx) block of the noisy config-4
    state; bases and out: interiors of padded blocks of the same shape, as
    the sharded stage stepper holds them (whole domain: plain states)."""
    from njw_tpu_torch.ops import pe_stencil as ps

    path = MAIN_PATHS["primitive"]
    hy, hx = halo
    cfg = path.sim_config(device="cuda", num_levels=L,
                          grid_width=lx + 2 * hx, grid_height=ly + 2 * hy)
    grid = cfg.grid_spec()
    cur = _noisy_state(grid, 1, None, path.ic_params)
    bases = [ps.interior(_noisy_state(grid, 2 + g, None, path.ic_params),
                         halo) for g in range(nbase)]
    out = ps.interior(cur.map(torch.empty_like), halo)
    return cfg, cur, bases, out


def _pe_stage_args(cfg, cur, bases, out, halo) -> tuple:
    """The arguments of ``pe_stencil._launch_stage`` for one stage of the
    case (one base: stages 1-3; four: the RK4 combine)."""
    from njw_tpu_torch.ops import pe_stencil as ps

    third = 1.0 / 3.0
    nbase = len(bases)
    kw = dict(c_dt=0.5 * cfg.dt if nbase == 1 else cfg.dt / 6.0,
              base_coeffs=(1.0,) if nbase == 1 else
              (-third, third, 2.0 * third, third),
              coriolis_f=float(cfg.coriolis_f), out=out)
    if halo != (0, 0):
        return ps._stage_padded_args(cur, bases, halo=halo, dx=cfg.dx,
                                     dy=cfg.dy, **kw)
    grid = cfg.grid_spec()
    return (cur, tuple(bases), tuple(ps._f32(c) for c in kw["base_coeffs"]),
            out, None, grid, ps.column_constants(grid, kw["coriolis_f"]),
            ps._f32(kw["c_dt"]), ps.level_constants(grid.levels, "cuda"),
            ps.NO_HALO)


def pe_stage_study(gpu: str, parent: str = None) -> None:
    """K5 alone: each form at its path's shape and at the config-5 shard
    shapes (1 and 4 bases), at each tile height that fits (the rule's as
    ``new``), the parent's source beside it in turns with the outputs
    compared bit for bit; the top-down and bottom-up walks alone; an L
    sweep at 512^2; the built kernels' registers, spills, shared bytes and
    blocks per SM."""
    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.ops import pe_stencil as ps

    csrc = _build.CSRC
    has_probe = "PE_STAGE_PROBE" in (csrc / "pe_stage.cu").read_text()
    # the one-thread-a-column kernel's entry has no tile_rows (the
    # argument before the stream)
    tiled = "tile_rows" in inspect.signature(ps._launch_stage).parameters
    binds = {"new": (ps._STAGE_ARGTYPES, None),
             "parent": (ps._STAGE_ARGTYPES,
                        len(ps._STAGE_ARGTYPES) - 2 if tiled else None)}
    # every build at once (one nvcc each)
    jobs = {}
    if parent:
        jobs[("parent", "all")] = (parent, "parent", (), ())
        for part, edits in PE_PARENT_PARTS.items():
            jobs[("parent", part)] = (parent, f"parent_{part}", edits, ())
    if has_probe:
        for part, defines in PE_PARTS.items():
            jobs[("new", part)] = (csrc, f"new_{part}", (), defines)
    with concurrent.futures.ThreadPoolExecutor(len(jobs) or 1) as pool:
        futures = {key: pool.submit(_variant_lib, src, "pe_stage", tag,
                                    edits, defines)
                   for key, (src, tag, edits, defines) in jobs.items()}
        done = {key: f.result() for key, f in futures.items()}
    libs = {}   # who -> {part: (lib, log)}
    for (who, part), lib in done.items():
        libs.setdefault(who, {})[part] = lib
    libs["new"] = {"all": (_build.load("pe_stage"),
                           _build.build_log("pe_stage")),
                   **libs.get("new", {})}
    if "parent" in libs:   # the parent first in every turn
        libs = {"parent": libs["parent"], "new": libs["new"]}
    print(json.dumps({"phase": "pe_stage_ptxas", "card": gpu, **{
        who: ptxas_entries(v["all"][1]) for who, v in libs.items()}}),
        flush=True)

    def attrs(who, L, halo, nbase, rows=0):
        if who == "new" and tiled:
            return ps.stage_kernel_attributes(L, rows, nbase)
        ent = ptxas_entries(libs[who]["all"][1])
        mode = {(0, 0): "Lb0ELb0E", (1, 0): "Lb1ELb0E",
                (1, 1): "Lb1ELb1E"}[(min(halo[0], 1), min(halo[1], 1))]
        e = next(v for k, v in ent.items() if mode in k)
        smem = L * 128 * 4 + e["static_smem_bytes"]
        return {**e, "smem_bytes": smem, "threads": 128,
                "blocks_per_sm": blocks_per_sm(e["registers"], 128, smem),
                "tile": [4, 32], "from": "ptxas"}

    def runner(who, lib, args, rows=0):
        def run():
            with _bound_to("pe_stage", lib, *binds[who]):
                if tiled:
                    ps._launch_stage(*args, tile_rows=rows)
                else:
                    ps._launch_stage(*args)
        return run

    def timed(form, shape, halo, nbase, parts):
        L, ly, lx = shape
        cfg, cur, bases, out = _pe_padded_case(L, ly, lx, halo, nbase)
        args = _pe_stage_args(cfg, cur, bases, out, halo)
        reps = max(10, int(2e10 / (L * ly * lx * 4 * (2 + nbase))))
        runs, outs = {}, {}
        for who, v in libs.items():
            heights = [0] if who == "parent" or not tiled else [0] + [
                r for r in ps.STAGE_TILE_ROWS
                if r != ps.stage_tile_rows(L)
                and ps.stage_smem_bytes(r, L) <= ps.SMEM_PER_BLOCK]
            for rows in heights:
                name = who if rows == 0 else f"{who}_{rows}_rows"
                runs[name] = runner(who, v["all"][0], args, rows)
                runs[name]()
                outs[name] = [t.clone() for _, t in out.items()]
        row = {"form": form, "shape": list(shape), "halo": list(halo),
               "bases": nbase, "times": _in_turns(runs, reps)}
        if "parent" in outs:
            row.update(_same(outs["new"], outs["parent"]))
        row["heights_equal_rule"] = {
            name: _same(o, outs["new"])["equal_bit_for_bit"]
            for name, o in outs.items() if name.startswith("new_")}
        row["attributes"] = {who: attrs(who, L, halo, nbase)
                             for who in libs}
        if tiled:
            row["attributes"].update({
                name: attrs("new", L, halo, nbase, int(name.split("_")[1]))
                for name in runs if name.startswith("new_")})
        if parts:
            row["parts_ms"] = {}
            for who, v in libs.items():
                for part, (lib, _) in v.items():
                    if part == "all":
                        continue
                    run = runner(who, lib, args)
                    device_ms(run, 2)
                    row["parts_ms"][f"{who}_{part}"] = device_ms(run, reps)
        print(json.dumps({"phase": "pe_stage_study", "card": gpu, **row}),
              flush=True)
        del cur, bases, out, outs, args
        torch.cuda.empty_cache()

    for form, shape, halo in PE_SHAPES:
        for nbase in (1, 4):
            timed(form, shape, halo, nbase, parts=nbase == 1)
    for L in PE_LEVELS:
        timed("whole", (L, 512, 512), (0, 0), 1, parts=False)
    if "parent" in libs:
        pe_stage_paths(gpu, {who: (v["all"][0], binds[who])
                             for who, v in libs.items()})


def pe_stage_paths(gpu: str, libs: dict) -> None:
    """The paths K5 carries, with each kernel of ``libs`` ({who: (library,
    binding)}) in turns (parent, new, new, parent): PE config 4 on the
    auto (stage) path, 20 steps a run (a warm-up and four runs stay inside
    the 150 steps validated for it), and the config-5 stage paths on a
    LocalMesh, 10 steps from the same shards each run; ms/step by CUDA
    events around each run."""
    from njw_tpu_torch.parallel import LocalMesh
    from njw_tpu_torch.weather.main_paths import SHARDED_PATHS

    def timed(run, steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps

    rows = {}
    sim = MAIN_PATHS["primitive"].simulation()
    paths = {"primitive": (lambda: sim.step(20), 20)}
    for name in ("pe5_stage_4x1", "pe5_stage_2x2"):
        path = SHARDED_PATHS[name]
        mesh = LocalMesh(*path.mesh)
        stepper = path.make_stepper(mesh)
        shards = mesh.shard_state(path.initial_state())
        paths[name] = (lambda st=stepper, sh=shards: st(sh), path.steps)
    for name, (run, steps) in paths.items():
        def with_lib(who):
            lib, bind = libs[who]

            def go():
                with _bound_to("pe_stage", lib, *bind):
                    run()
            return go

        for who in libs:
            with_lib(who)()   # warm-up
        times = {who: [] for who in libs}
        for who in ("parent", "new", "new", "parent"):
            times[who].append(timed(with_lib(who), steps))
        rows[name] = {who: {"ms_per_step": t, "mean": sum(t) / len(t)}
                      for who, t in times.items()}
    print(json.dumps({"phase": "pe_stage_paths", "card": gpu, **rows}),
          flush=True)


# parts of the parent baro_stage.cu (32 x 32 shared-memory tiles): the tile
# loads alone (a store no value reaches keeps them), and an empty body
BARO_PARENT_PARTS = {
    "tile_load": [("baro_stage.cu",
                   "    const int gx = blockIdx.x * TX + threadIdx.x;\n"
                   "    if (gx >= nx) return;",
                   "    if (sp[tid] == -1.25e-38f) out[0] = sz[tid];\n"
                   "    return;\n"
                   "    const int gx = blockIdx.x * TX + threadIdx.x;\n"
                   "    if (gx >= nx) return;")],
    "empty": [("baro_stage.cu", "    __shared__ float sp[PY * PX];",
               "    if (ny > 0) return;\n    __shared__ float sp[PY * PX];")],
}
BARO_GRIDS = (512, 1024, 2048)


def baro_stage_study(gpu: str, parent: str = None) -> None:
    """K3 alone at 512^2, 1024^2 and 2048^2 (rotating buffers past L2),
    at each strip it builds (the rule's as ``new``), the parent's source
    beside it in turns with the outputs compared bit for bit, the parent's
    tile loads alone and its empty launch; and the same on odd and
    sub-tile grids."""
    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.ops import baro_stencil as bs
    from njw_tpu_torch.weather import GridSpec

    # the tile kernel's entry has no strip (the argument before the
    # stream)
    striped = "strip" in inspect.signature(bs._launch).parameters
    drop = len(bs._ARGTYPES) - 2 if striped else None
    libs = {"new": (_build.load("baro_stage"), _build.build_log("baro_stage"))}
    parts = {}
    if parent:
        pdir = str(Path(parent).parent)
        libs["parent"] = _variant_lib(pdir, "baro_stage", "parent")
        for part, edits in BARO_PARENT_PARTS.items():
            parts[part] = _variant_lib(pdir, "baro_stage", f"parent_{part}",
                                       edits)
    print(json.dumps({"phase": "baro_stage_ptxas", "card": gpu, **{
        who: ptxas_entries(log) for who, (_, log) in libs.items()}}),
        flush=True)
    cfg = MAIN_PATHS["barotropic"].config
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n in (*BARO_GRIDS, (3, 5), (33, 65), (1000, 1024), (37, 131)):
        ny, nx = (n, n) if isinstance(n, int) else n
        grid = GridSpec(nx=nx, ny=ny)
        nsets = max(1, -(-150_000_000 // (16 * ny * nx)))
        sets = [tuple(torch.rand(ny, nx, device="cuda", generator=gen)
                      for _ in range(4)) for _ in range(nsets)]
        k = bs.baro_constants(grid, 0.5 * cfg["dt"], cfg["beta"],
                              cfg["viscosity"])

        def runner(lib, who, strip=-1):
            turn = [0]

            def run():
                p, z, b, o = sets[turn[0]]
                with _bound_to("baro_stage", lib, bs._ARGTYPES,
                               drop if who == "parent" else None):
                    if striped:
                        bs._launch(p, z, b, o, grid, k, strip)
                    else:
                        bs._launch(p, z, b, o, grid, k)
                turn[0] = (turn[0] + 1) % nsets
            return run

        runs = {}
        for who, (lib, _) in libs.items():
            runs[who] = runner(lib, who)
            if who == "new" and striped:
                rule = bs.baro_strip(nx)
                for i, (v, h) in enumerate(bs.BARO_STRIPS):
                    if i != rule and (v == 1 or nx % 4 == 0):
                        runs[f"new_strip_{v}x{h}"] = runner(lib, who, i)
        outs = {}
        for name, run in runs.items():
            sets[0][3].fill_(float("nan"))
            run()
            outs[name] = [sets[0][3].clone()]
            for _ in range(nsets - 1):
                run()
        row = {"grid": [ny, nx], "rotating_sets": nsets,
               "times": _in_turns(runs, 400)}
        if n == 1024:   # chip_smoke.py's timing: the wrapper, four sets
            turn4 = [0]

            def wrapped():
                p_, z_, b_, o_ = sets[turn4[0]]
                bs.baro_stage_cuda(p_, z_, b_, out=o_, grid=grid,
                                   c_dt=0.5 * cfg["dt"], beta=cfg["beta"],
                                   nu=cfg["viscosity"])
                turn4[0] = (turn4[0] + 1) % 4

            device_ms(wrapped, 20)
            row["wrapper_four_sets_ms"] = [device_ms(wrapped, 200)
                                           for _ in range(2)]
        if "parent" in outs:
            row.update(_same(outs["new"], outs["parent"]))
        row["strips_equal_rule"] = {
            name: _same(o, outs["new"])["equal_bit_for_bit"]
            for name, o in outs.items() if name.startswith("new_")}
        row["plain_vs_new"] = _same(outs["new"], [bs.baro_stage_plain(
            *sets[0][:3], grid=grid, c_dt=0.5 * cfg["dt"], beta=cfg["beta"],
            nu=cfg["viscosity"])])
        if striped:
            row["attributes"] = {
                f"{v}x{h}": bs.baro_kernel_attributes(i)
                for i, (v, h) in enumerate(bs.BARO_STRIPS)}
        if isinstance(n, int):
            row["parts_ms"] = {}
            for part, (lib, _) in parts.items():
                run = runner(lib, "parent")
                device_ms(run, 2)
                row["parts_ms"][f"parent_{part}"] = device_ms(run, 400)
        print(json.dumps({"phase": "baro_stage_study", "card": gpu, **row}),
              flush=True)
        del sets, outs
        torch.cuda.empty_cache()
    baro_main_data(gpu, libs, drop)


def baro_main_data(gpu: str, libs: dict, drop) -> None:
    """K3 on the barotropic main path's own fields (psi and zeta of its
    initial vortex at 1024^2, as chip_smoke.py times it; four rotating
    sets), each library in turns, with the share of zeta values that are
    subnormal or zero (a division by dx^2 or dy^2 of a subnormal takes
    the slow path)."""
    from njw_tpu_torch.ops import baro_stencil as bs
    from njw_tpu_torch.ops.spectral import poisson_solve
    from njw_tpu_torch.weather import GridSpec, diagnostics, make_initial_state

    path = MAIN_PATHS["barotropic"]
    cfg = path.config
    n = cfg["grid_width"]
    grid = GridSpec(nx=n, ny=n)
    s0 = make_initial_state(path.ic, grid, device="cuda", **path.ic_params)
    zeta = diagnostics(s0, grid)["vorticity"].contiguous()
    psi = poisson_solve(zeta, grid.dx, grid.dy)
    sets = [(psi.clone(), zeta.clone(), zeta + 0.1, torch.empty_like(zeta))
            for _ in range(4)]
    k = bs.baro_constants(grid, 0.5 * cfg["dt"], cfg["beta"],
                          cfg["viscosity"])
    runs = {}
    for who, (lib, _) in libs.items():
        turn = [0]

        def run(lib=lib, who=who, turn=turn):
            p_, z_, b_, o_ = sets[turn[0]]
            with _bound_to("baro_stage", lib, bs._ARGTYPES,
                           drop if who == "parent" else None):
                bs._launch(p_, z_, b_, o_, grid, k)
            turn[0] = (turn[0] + 1) % len(sets)
        runs[who] = run
    tiny = float(((zeta.abs() < torch.finfo(torch.float32).tiny)
                  .float().mean()))
    row = {"grid": [n, n], "zeta_subnormal_or_zero_share": tiny,
           "times": _in_turns(runs, 200)}
    if "parent" in runs:   # the stage as the stepper runs it: base = zeta
        outs = {}
        for who, (lib, _) in libs.items():
            with _bound_to("baro_stage", lib, bs._ARGTYPES,
                           drop if who == "parent" else None):
                outs[who] = [bs._launch(psi, zeta, zeta,
                                        torch.empty_like(zeta), grid, k)]
        row.update(_same(outs["new"], outs["parent"]))
    print(json.dumps({"phase": "baro_main_data", "card": gpu, **row}),
          flush=True)


def pe_rk4_parent_check(gpu: str, parent: str) -> None:
    """K4 built from the parent's pe_rk4.cu and pe_column.cuh beside the
    current one at config 4 (flat and with terrain): equal bit for bit?"""
    from njw_tpu_torch.ops import pe_stencil as ps

    lib, _ = _variant_lib(parent, "pe_rk4", "parent")
    path = MAIN_PATHS["primitive"]
    cfg = path.sim_config(device="cuda")
    grid = cfg.grid_spec()
    rows = {}
    for terrain in (False, True):
        phi_s = _mountain(grid) if terrain else None
        s = _noisy_state(grid, 1, phi_s, path.ic_params)
        kw = dict(grid=grid, dt=cfg.dt, coriolis_f=cfg.coriolis_f,
                  phi_s=phi_s)
        new = ps.pe_rk4_step_cuda(s, **kw)
        with _bound_to("pe_rk4", lib, ps._RK4_ARGTYPES):
            old = ps.pe_rk4_step_cuda(s, **kw)
        rows["terrain" if terrain else "flat"] = _same(
            [t for _, t in new.items()], [t for _, t in old.items()])
    print(json.dumps({"phase": "pe_rk4_parent", "card": gpu,
                      "shape": [grid.levels, grid.ny, grid.nx], **rows}),
          flush=True)


# builds of the current fir_band sources timed beside it: its parts (no
# products: the streamed copy, splits and stores; no loads: the products
# and stores on whatever the planes hold; loads alone: the streamed loads
# and splits, nothing stored)
FIR_VARIANTS = {"no_products": ("-DFIR_PROBE=1",),
                "no_loads": ("-DFIR_PROBE=2",),
                "loads_alone": ("-DFIR_PROBE=3",)}


def _band_entries(log: str) -> dict:
    """ptxas's report of each band_kernel instantiation, keyed by its
    template arguments as mangled (In, Out, PLAN, NPROD, NA, NB)."""
    out = {}
    for name, v in ptxas_entries(log).items():
        m = re.search(r"band_kernelI(\w+?)EEv", name)
        out[m.group(1) if m else name] = v
    return out


def fir_study(gpu: str, parent: str = None) -> None:
    """K7 and K8 alone at the three FIR main paths' shapes (passes 0-3 on
    float32, taps_passes 1-2 on bf16), the current build beside its parts
    and other geometries (FIR_VARIANTS) and, with ``parent``, the parent's
    fir_band.cu / fir_band_bf16.cu (with its fir_band.cuh) built outside
    the repository, in turns (parent first each turn); the largest
    difference from the parent; the built kernels' registers, spills,
    shared bytes and blocks per SM."""
    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.signal import fir_cuda as fc
    from njw_tpu_torch.signal.main_paths import MAIN_PATHS as SIGNAL_PATHS

    names = ("fir_band", "fir_band_bf16")
    jobs = {(tag, name): (str(_build.CSRC), name, tag, defines)
            for tag, defines in FIR_VARIANTS.items() for name in names}
    if parent:
        jobs.update({("parent", name): (parent, name, "parent", ())
                     for name in names})
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 2) as ex:
        futs = {key: ex.submit(_variant_lib, src, name, tag, (), d)
                for key, (src, name, tag, d) in jobs.items()}
        for name in names:
            ex.submit(_build.load, name).result()
        libs = {key: f.result() for key, f in futs.items()}
    for name in names:
        libs[("new", name)] = (_build.load(name), _build.build_log(name))
    order = (["parent"] if parent else []) + ["new", *FIR_VARIANTS]
    argtypes = {"fir_band": fc._ARGTYPES, "fir_band_bf16": fc._ARGTYPES_BF16}

    built = {who: {name: _band_entries(libs[(who, name)][1])
                   for name in names} for who in order}
    attrs = {f"passes={p}": fc.fir_kernel_attributes(torch.float32, p)
             for p in (0, 1, 2, 3)}
    attrs.update({f"bf16 taps_passes={p}": fc.fir_kernel_attributes(
        torch.bfloat16, p) for p in (1, 2)})
    if parent:   # the parent's blocks an SM: 256 threads, its smem rule
        for key, v in built["parent"]["fir_band"].items():
            na = int(re.findall(r"Li(\d+)E", key)[2]) if key.count("Li") > 2 \
                else 1
            v["blocks_per_sm"] = blocks_per_sm(
                v["registers"], 256, na * 65 * 144 * 2 + 8 * 256 * 4)
        for v in built["parent"]["fir_band_bf16"].values():
            v["blocks_per_sm"] = blocks_per_sm(v["registers"], 256,
                                               65 * 144 * 2 + 8 * 256 * 4)
    print(json.dumps({"phase": "fir_built", "card": gpu, "ptxas": built,
                      "new_attributes": attrs}), flush=True)

    def runner(who, name, call):
        lib = libs[(who, name)][0]

        def run():
            with _bound_to(name, lib, argtypes[name]):
                return call()
        return run

    for path_name in ("fir_batch", "fir_suite", "fir_bf16"):
        path = SIGNAL_PATHS[path_name]
        x, taps = path.signal(seed=1), path.taps()
        bf16 = path.dtype == torch.bfloat16
        name = "fir_band_bf16" if bf16 else "fir_band"
        copy = torch.empty_like(x)
        print(json.dumps({"phase": "fir_copy", "card": gpu,
                          "path": path_name, "shape": list(x.shape),
                          "copy_ms": device_ms(lambda: copy.copy_(x), 20)}),
              flush=True)
        del copy
        for p in ((1, 2) if bf16 else (3, 1, 2, 0)):
            if bf16:
                def call(p=p):
                    return fc.fir_band_bf16_cuda(x, taps, taps_passes=p)
            else:
                def call(p=p):
                    return fc.fir_band_cuda(x, taps, passes=p)
            runs, failed = {}, {}
            for who in order:
                run = runner(who, name, call)
                try:
                    run()
                    torch.cuda.synchronize()
                    runs[who] = run
                except RuntimeError as e:
                    failed[who] = str(e)
            times = _in_turns(runs, 20)
            row = {"phase": "fir_parent" if parent else "fir_forms",
                   "card": gpu, "path": path_name, "shape": list(x.shape),
                   "dtype": str(path.dtype), "taps": len(taps),
                   ("taps_passes" if bf16 else "passes"): p,
                   "ms": {who: t["ms_mean"] for who, t in times.items()},
                   "ms_turns": {who: t["ms"] for who, t in times.items()},
                   "failed": failed}
            if "parent" in runs:
                row.update(_same([runs["new"]().float()],
                                 [runs["parent"]().float()]))
            print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="all",
                    choices=[*MAIN_PATHS, *VARIANT_PATHS, "fir", "pe_stage",
                             "baro_stage", "plain_sharded", "analysis",
                             "particles", "imaging", "finance", "all"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--parent-swe", metavar="FILE",
                    help="an earlier swe_rk4.cu to time beside the current "
                    "kernel (--model swe)")
    ap.add_argument("--parent-pe-stage", metavar="DIR",
                    help="a directory with an earlier pe_stage.cu, "
                    "pe_rk4.cu and pe_column.cuh to time and compare beside "
                    "the current K5 and K4 (--model pe_stage)")
    ap.add_argument("--parent-baro", metavar="FILE",
                    help="an earlier baro_stage.cu to time and compare "
                    "beside the current K3 (--model baro_stage)")
    ap.add_argument("--parent-fir", metavar="DIR",
                    help="a directory with an earlier fir_band.cuh, "
                    "fir_band.cu and fir_band_bf16.cu to time and compare "
                    "beside the current K7 and K8 (--model fir)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = card()
    models = [*MAIN_PATHS, *VARIANT_PATHS, "fir"] if args.model == "all" \
        else [args.model]
    for model in models:
        if model == "pe_stage":
            pe_stage_study(gpu, args.parent_pe_stage)
            if args.parent_pe_stage:
                pe_rk4_parent_check(gpu, args.parent_pe_stage)
            continue
        if model == "baro_stage":
            baro_stage_study(gpu, args.parent_baro)
            continue
        if model == "plain_sharded":
            plain_sharded(gpu)
            continue
        if model == "analysis":
            profile_analysis(min(args.steps, 20), gpu)
            continue
        if model == "particles":
            profile_particles(gpu)
            continue
        if model == "imaging":
            profile_imaging(gpu)
            continue
        if model == "finance":
            profile_finance(gpu)
            continue
        if model == "fir":
            print(json.dumps(profile_fir(args.steps, gpu)), flush=True)
            fir_study(gpu, args.parent_fir)
            continue
        print(json.dumps(profile_path(model, args.steps, gpu)), flush=True)
        if model == "swe":
            swe_extras(args.steps, gpu)
            swe_kernel_extras(gpu)
            if args.parent_swe:
                swe_parent(args.parent_swe, gpu)
        elif model == "primitive":
            primitive_extras(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
