#!/usr/bin/env python3
"""Drive the PyTorch port (njw_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, one JSON line each; any failure exits nonzero before the last line:
  1 toolchain   card name and power limit, torch / CUDA / nvcc / triton
  2 build       every kernel under njw_tpu_torch/ops/csrc/, with build time
  3 kernels     each kernel against its plain PyTorch version on the card
                (per step rtol 1e-5 / atol 1e-6), and its time beside the
                plain version's and the card's bound
  4 parity      512^2, 12 steps: backend kernel vs backend plain, 1e-3
  5 main path   SWE 2048^2 RK4 vortex through Simulation.from_config, 1000
                steps after a warm-up; launch counts reset just before and
                read just after
  6 cli         the CLI's --json run and its --validate against the oracle
Then the kernel table ({"kernels": [...]}), the card line, and as the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

GRID = 2048          # the headline configuration: SWE 2048^2 RK4
DT = 0.001
CORIOLIS = 1e-4
STRENGTH = 1.0       # vortex strength
MAIN_STEPS = 1000
WARM_STEPS = 10
PARITY_GRID, PARITY_STEPS = 512, 12
RTOL, ATOL = 1e-5, 1e-6   # kernel vs plain version, per step
FLOP_PER_POINT = 4 * 33 + 24          # four tendencies + the combines
VISC_FLOP_PER_POINT = 4 * 2 * 10      # 5-point Laplacian on u and v per stage
BYTES_PER_POINT = 24                  # read u, v, h once, write them once


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    raise SystemExit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def toolchain() -> str:
    import torch

    card = nvidia_smi_line()
    print(card, flush=True)
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                          text=True, timeout=60)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("toolchain", ok=True, card=card, torch=torch.__version__,
         torch_cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=(nvcc.stdout.strip().splitlines() or ["missing"])[-1],
         triton=triton_version)
    return card


def build() -> None:
    from njw_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libs}
    emit("build", ok=True, seconds=seconds, libraries=sorted(libs),
         ptxas=ptxas)


def _events_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _compare(kern, plain) -> tuple[float, float, bool]:
    import torch

    max_abs, max_rel, ok = 0.0, 0.0, True
    for a, b in zip(kern, plain):
        if not bool(torch.isfinite(a).all()):
            return float("inf"), float("inf"), False
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / b.abs().clamp_min(1e-30)).max()))
        ok &= bool((d <= ATOL + RTOL * b.abs()).all())
    return max_abs, max_rel, ok


def bound_ms(points: int, viscous: bool) -> tuple[float, str]:
    """Least time for one fused step on this card, and what bounds it."""
    import torch
    from njw_tpu_torch.platform.device import spec_for

    bw_gbps, fp32_tflops = spec_for(torch.cuda.get_device_name(0))
    if bw_gbps is None:
        fail("kernels", "card not in the spec table of platform/device.py")
    t_bytes = BYTES_PER_POINT * points / (bw_gbps * 1e9) * 1e3
    flop = FLOP_PER_POINT + (VISC_FLOP_PER_POINT if viscous else 0)
    t_ops = flop * points / (fp32_tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_vs_plain() -> dict:
    import torch
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.weather import GridSpec, make_initial_state

    cases = [
        # name, ny, nx, ic, ic kwargs, dt, f, nu
        ("main_2048", GRID, GRID, "vortex", {"strength": STRENGTH}, DT,
         CORIOLIS, 0.0),
        ("viscous_512", 512, 512, "vortex", {"strength": 2.0}, 0.01,
         CORIOLIS, 0.02),
        ("ragged_200x328", 200, 328, "breaking_wave", {"amplitude": 0.3},
         0.005, CORIOLIS, 0.0),
        ("tiny_3x5", 3, 5, "random", {"amplitude": 0.1, "seed": 1}, 0.001,
         CORIOLIS, 0.0),
    ]
    results = {}
    for name, ny, nx, ic, ic_kw, dt, f, nu in cases:
        grid = GridSpec(nx=nx, ny=ny)
        s = make_initial_state(ic, grid, device="cuda", **ic_kw)
        kw = dict(grid=grid, dt=dt, coriolis_f=f, viscosity=nu)
        kern = stencil.swe_rk4_step_cuda(s.u, s.v, s.h, **kw)
        plain = stencil.swe_rk4_step_plain(s.u, s.v, s.h, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = _compare(kern, plain)
        emit("kernel_vs_plain", ok=ok, kernel="swe_rk4", case=name,
             shape=[ny, nx], viscosity=nu, max_abs_err=max_abs,
             max_rel_err=max_rel, rtol=RTOL, atol=ATOL)
        if not ok:
            fail("kernel_vs_plain", f"swe_rk4 disagrees with its plain "
                 f"version on {name}")
        results[name] = (max_abs, s, kw)

    # times at the main path's shape: the kernel ping-ponging two buffers
    # (the stepper's pattern), the plain version over a few calls
    max_abs, s, kw = results["main_2048"]
    bufs = [(s.u, s.v, s.h),
            tuple(torch.empty_like(t) for t in (s.u, s.v, s.h))]
    turn = [0]

    def kernel_step():
        src, dst = bufs[turn[0]], bufs[1 - turn[0]]
        stencil.swe_rk4_step_cuda(*src, out=dst, **kw)
        turn[0] ^= 1

    _events_ms(kernel_step, 20)
    ms = _events_ms(kernel_step, 500)
    plain_call = lambda: stencil.swe_rk4_step_plain(s.u, s.v, s.h, **kw)
    _events_ms(plain_call, 2)
    plain_ms = _events_ms(plain_call, 10)
    b_ms, b_by = bound_ms(GRID * GRID, viscous=False)
    emit("kernel_time", ok=True, kernel="swe_rk4", shape=[GRID, GRID],
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         fraction_of_bound=b_ms / ms, library_ms=None)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def parity_gate() -> None:
    import dataclasses

    import torch
    from njw_tpu_torch.weather import SimConfig, Simulation

    cfg = SimConfig(grid_width=PARITY_GRID, grid_height=PARITY_GRID, dt=DT,
                    integration_method="rk4", coriolis_f=CORIOLIS,
                    backend="kernel", device="cuda")
    ker = Simulation.from_config(cfg, "vortex", strength=STRENGTH)
    ref = Simulation.from_config(dataclasses.replace(cfg, backend="plain"),
                                 "vortex", strength=STRENGTH)
    if ker.stepper.name != "rk4_kernel" or ref.stepper.name != "rk4":
        fail("parity", f"wrong steppers {ker.stepper.name}/{ref.stepper.name}")
    ker.step(PARITY_STEPS)
    ref.step(PARITY_STEPS)
    worst, ok = 0.0, True
    for name in ("u", "v", "h"):
        a, b = getattr(ker.state, name), getattr(ref.state, name)
        worst = max(worst, float((a - b).abs().max()))
        ok &= bool(torch.allclose(a, b, rtol=1e-3, atol=1e-3))
    emit("parity", ok=ok, grid=PARITY_GRID, steps=PARITY_STEPS,
         max_abs_diff=worst, tol=1e-3)
    if not ok:
        fail("parity", "kernel path diverged from the plain integrators")


def main_path() -> dict:
    import torch
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.platform.device import spec_for
    from njw_tpu_torch.weather import SimConfig, Simulation

    cfg = SimConfig(grid_width=GRID, grid_height=GRID, dt=DT,
                    integration_method="rk4", coriolis_f=CORIOLIS,
                    device="cuda")
    sim = Simulation.from_config(cfg, "vortex", strength=STRENGTH)
    if sim.stepper.name != "rk4_kernel":
        fail("main_path", f"auto backend picked {sim.stepper.name}")

    stencil.swe_rk4_step_cuda.launches = 0
    sim.step(WARM_STEPS)
    sim.metrics.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.step(MAIN_STEPS)
    end.record()
    end.synchronize()
    launches = stencil.swe_rk4_step_cuda.launches

    finite = all(bool(torch.isfinite(t).all()) for _, t in sim.state.items())
    ms_step = start.elapsed_time(end) / MAIN_STEPS
    b_ms, b_by = bound_ms(GRID * GRID, viscous=False)
    bw, _ = spec_for(torch.cuda.get_device_name(0))
    emit("main_path", ok=finite and launches == WARM_STEPS + MAIN_STEPS,
         grid=GRID, steps=MAIN_STEPS, warm_steps=WARM_STEPS,
         stepper=sim.stepper.name, finite=finite, launches=launches,
         ms_per_step=ms_step, host_ms_per_step=(
             sim.metrics.compute_time_ms / MAIN_STEPS),
         grid_points_per_s=GRID * GRID / (ms_step / 1e3),
         bound_us=b_ms * 1e3, bound_by=b_by, hbm_gbps_assumed=bw,
         fraction_of_bound=b_ms / ms_step,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    if not finite:
        fail("main_path", "non-finite fields")
    if launches != WARM_STEPS + MAIN_STEPS:
        fail("main_path", f"swe_rk4 launched {launches} times for "
             f"{WARM_STEPS + MAIN_STEPS} steps")
    return {"launches": launches, "ms_per_step": ms_step}


def cli() -> None:
    from njw_tpu_torch.weather.__main__ import main as cli_main

    runs = {
        "json": ["--width", "512", "--height", "512", "--steps", "200",
                 "--coriolis", "1e-4", "--json"],
        "validate": ["--validate", "--width", "128", "--height", "128",
                     "--steps", "200", "--method", "rk4"],
    }
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        ok = rc == 0 and (name != "validate" or line.get("allclose") is True)
        emit("cli", ok=ok, run=name, rc=rc, result=line)
        if not ok:
            fail("cli", f"CLI {name} run failed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import njw_tpu_torch  # noqa: F401  (fails outside the repository)

    card = toolchain()
    build()
    k = kernels_vs_plain()
    parity_gate()
    m = main_path()
    cli()
    kernel = {
        "name": "swe_rk4", "route": "cuda",
        "source": "njw_tpu_torch/ops/csrc/swe_rk4.cu",
        "replaces": "njw_tpu/ops/stencil.py:60",
        "replaces_function": "swe_rk4_kernel",
        "launches": m["launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "max_err": k["max_abs_err"], "us_per_step": m["ms_per_step"] * 1e3,
        "bound_us": k["bound_ms"] * 1e3,
    }
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
