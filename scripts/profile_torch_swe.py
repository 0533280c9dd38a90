#!/usr/bin/env python3
"""Where the time of the PyTorch port's SWE main path goes, on one GPU.

    python scripts/profile_torch_swe.py [--grid 2048] [--steps 200]

Runs ``Simulation.from_config`` (SWE RK4, vortex strength 1.0, dt 0.001,
f 1e-4: the headline configuration) and prints JSON lines:
  * ``profile``: device time by kernel name from ``torch.profiler`` over a
    steady window, and the device's busy share of that window;
  * ``steps``: ms/step of the same window without the profiler (CUDA events)
    for backend kernel and backend plain;
  * ``sweep``: the fused kernel alone at several grid sizes (CUDA events),
    with the bandwidth its 24 B/point minimum traffic implies.
Each line carries the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from njw_tpu_torch.ops.stencil import swe_rk4_step_cuda  # noqa: E402
from njw_tpu_torch.weather import (  # noqa: E402
    GridSpec, SimConfig, Simulation, make_initial_state,
)


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


def make_sim(grid: int, backend: str) -> Simulation:
    cfg = SimConfig(grid_width=grid, grid_height=grid, dt=0.001,
                    coriolis_f=1e-4, backend=backend, device="cuda")
    return Simulation.from_config(cfg, "vortex", strength=1.0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_swe: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = card()

    sim = make_sim(args.grid, "auto")
    sim.step(10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(args.steps)  # ends in torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    print(json.dumps({
        "phase": "profile", "card": gpu, "grid": args.grid,
        "steps": args.steps, "stepper": sim.stepper.name,
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "device_ms_by_kernel": by_name}), flush=True)

    steps = {}
    for backend, n in (("kernel", args.steps), ("plain", 5)):
        s = make_sim(args.grid, backend)
        s.step(2)
        # one chunk of n steps (one synchronize at its end), as Simulation.run does
        steps[backend] = events_ms(lambda: s.step(n), 1) / n
    print(json.dumps({"phase": "steps", "card": gpu, "grid": args.grid,
                      "ms_per_step": steps}), flush=True)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
