#!/usr/bin/env python3
"""Where the time of the PyTorch port's main paths goes, on one GPU.

    python scripts/profile_torch.py [--model swe|barotropic|primitive|
                                     swe_bf16|swe_multistep|swe_si|pe_si|
                                     fir|all] [--steps 50]

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
    events), and ``sweep``: the fused kernel alone at several grid sizes,
    with the bandwidth its 24 B/point minimum traffic implies;
  * primitive ``layouts``: the whole-step kernel alone at the main path's
    shape for several output tiles, beside the four-stage path's ms/step
    (CUDA events);
  * fir ``profile``: the fir_batch path of
    ``njw_tpu_torch.signal.main_paths`` (FIRFilter.apply on 1000 x 100000,
    101 taps) called ``--steps`` times: device time by kernel, busy share
    and host enqueue per call; and ``fir_passes``: each FIR kernel alone at
    that shape for every precision it offers (CUDA events).
"""
from __future__ import annotations

import argparse
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
from njw_tpu_torch.weather.main_paths import (  # noqa: E402
    MAIN_PATHS, VARIANT_PATHS,
)

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


def profile_fir(calls: int, gpu: str) -> dict:
    from njw_tpu_torch.signal.main_paths import MAIN_PATHS as SIGNAL_PATHS

    path = SIGNAL_PATHS["fir_batch"]
    x = path.signal()
    call = path.call()
    for _ in range(path.warm):
        call(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)

    t0 = time.perf_counter()
    for _ in range(10):
        call(x)
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    return {"phase": "profile", "card": gpu, "model": "fir",
            "path": "fir_batch", "shape": list(path.shape),
            "taps": path.num_taps, "calls": calls,
            **summary(by_name, calls, wall_ms, "call"),
            "host_enqueue_ms_per_call": enqueue_ms}


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
    for n in (512, 1024, 2048, 4096):
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
        ms = events_ms(launch, 200)
        sweep.append({"grid": n, "ms": ms,
                      "gbps_at_24B_per_point": 24 * n * n / (ms * 1e6)})
    print(json.dumps({"phase": "sweep", "card": gpu, "kernel": "swe_rk4",
                      "sizes": sweep}), flush=True)


def primitive_extras(gpu: str) -> None:
    from njw_tpu_torch.ops import pe_stencil as ps

    path = MAIN_PATHS["primitive"]
    sim = path.simulation()
    grid, s = sim.grid, sim.state
    kw = dict(grid=grid, dt=path.config["dt"],
              coriolis_f=path.config["coriolis_f"])
    bufs = [s.map(torch.clone), s.map(torch.empty_like)]
    rows = []
    for tile in (8, 12, 16, 24):
        # every layout starts from the initial state
        for (_, a), (_, b) in zip(bufs[0].items(), s.items()):
            a.copy_(b)
        scratch = ps.rk4_scratch(grid.levels, s.ps.device, tile)
        turn = [0]

        def launch():
            ps.pe_rk4_step_cuda(bufs[turn[0]], out=bufs[1 - turn[0]],
                                tile=tile, **kw)
            turn[0] ^= 1

        events_ms(launch, 4)
        rows.append({"tile": tile, "slots": scratch.slots,
                     "scratch_mb": scratch.buf.numel() * 4 / 2**20,
                     "ms": events_ms(launch, 40)})
        del scratch
    stages = ps.make_pe_kernel_rk4_stepper(grid, path.sim_config().physics(),
                                           kw["dt"],
                                           whole_step=False)
    carry, state = stages.init(s), s.map(torch.clone)

    def stage_step():
        nonlocal carry, state
        carry, state = stages.step(carry, state, None)

    events_ms(stage_step, 4)
    print(json.dumps({"phase": "layouts", "card": gpu, "model": "primitive",
                      "shape": [grid.levels, grid.ny, grid.nx],
                      "whole_step_kernel": rows,
                      "stage_path_ms_per_step": events_ms(stage_step, 40)}),
          flush=True)


def fir_extras(gpu: str) -> None:
    from njw_tpu_torch.signal import fir_cuda as fc
    from njw_tpu_torch.signal.main_paths import MAIN_PATHS as SIGNAL_PATHS

    path = SIGNAL_PATHS["fir_batch"]
    x, taps = path.signal(), path.taps()
    rows = {}
    for passes in (1, 2, 3, 0):
        def launch():
            fc.fir_band_cuda(x, taps, passes=passes)

        events_ms(launch, 3)
        rows[f"fir_band passes={passes}"] = events_ms(launch, 20)
    xb = x.to(torch.bfloat16)
    del x
    for taps_passes in (1, 2):
        def launch():
            fc.fir_band_bf16_cuda(xb, taps, taps_passes=taps_passes)

        events_ms(launch, 3)
        rows[f"fir_band_bf16 taps_passes={taps_passes}"] = events_ms(launch,
                                                                    20)
    print(json.dumps({"phase": "fir_passes", "card": gpu,
                      "shape": list(path.shape), "taps": path.num_taps,
                      "ms": rows}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="all",
                    choices=[*MAIN_PATHS, *VARIANT_PATHS, "fir", "all"])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = card()
    models = [*MAIN_PATHS, *VARIANT_PATHS, "fir"] if args.model == "all" \
        else [args.model]
    for model in models:
        if model == "fir":
            print(json.dumps(profile_fir(args.steps, gpu)), flush=True)
            fir_extras(gpu)
            continue
        print(json.dumps(profile_path(model, args.steps, gpu)), flush=True)
        if model == "swe":
            swe_extras(args.steps, gpu)
        elif model == "primitive":
            primitive_extras(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
