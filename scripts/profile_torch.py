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
    events), and ``sweep``: the fused kernel alone at 512^2 to 4096^2,
    with the bandwidth its 24 B/point minimum traffic implies;
    ``swe_parts``: K1 and K2 alone at 2048^2, the region loads alone
    (stages 0) and the first 1, 2, ... 4N stages (stores only at 4N), a
    copy of u, v, h (the same 24 B/point) beside them, and the built
    kernel's registers, spill bytes, shared bytes, threads, blocks per SM
    and layout; ``--parent-swe FILE`` adds ``swe_parent``: an earlier
    swe_rk4.cu (a C entry with no stage count) built with the same nvcc
    flags into a temporary directory and timed beside the current kernel
    for K1, K1-bf16 and K2 at each size of the sweep, in turns (parent,
    new, new, parent), with whether the two give equal outputs bit for
    bit. Kernel-alone times (``sweep``, ``swe_parts``, ``swe_parent``)
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
  * fir ``profile``: the fir_batch path of
    ``njw_tpu_torch.signal.main_paths`` (FIRFilter.apply on 1000 x 100000,
    101 taps) called ``--steps`` times: device time by kernel, busy share
    and host enqueue per call; and ``fir_passes``: each FIR kernel alone at
    that shape for every precision it offers (CUDA events).
"""
from __future__ import annotations

import argparse
import dataclasses
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
    bufs = [tuple(t.clone() for t in fields),
            tuple(torch.empty_like(t) for t in fields)]
    turn = [0]

    def call():
        launch(bufs[turn[0]], bufs[1 - turn[0]])
        turn[0] ^= 1

    events_ms(call, 10)
    return device_ms(call, reps)


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


def swe_parent(path: str, gpu: str) -> None:
    """An earlier swe_rk4.cu beside the current one, in one process:
    built with the same flags outside the repository, timed in turns for
    K1, K1-bf16 and K2 at each size of the sweep, outputs compared bit for
    bit."""
    import ctypes
    import tempfile

    from njw_tpu_torch.ops import _build
    from njw_tpu_torch.ops import stencil as st

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    argtypes = ([P] * 3 + [L, I, I] + [P] * 3 + [L, I, I] + [I] * 4
                + [F] * 10 + [I] * 3 + [F] * 2 + [P])
    tmp = tempfile.mkdtemp(prefix="swe_parent_")
    so = Path(tmp) / "libswe_parent.so"
    build = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            str(so), path], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"parent build failed:\n{build.stderr}")
    regs = [ln.strip() for ln in (build.stdout + build.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    fn = ctypes.CDLL(str(so)).swe_rk4_launch
    fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def parent(ins, out, k):
        ny, nx = out[0].shape
        err = fn(*(t.data_ptr() for t in ins), ins[0].stride(0), 0, 0,
                 *(t.data_ptr() for t in out), out[0].stride(0), 0, 0, ny,
                 nx, 0, 0, k["cx"], k["cy"], k["g"], k["f"], k["half"],
                 k["dt"], k["sixth"], k["third"], k["ix2"], k["iy2"], 0,
                 k.get("fused", 1), int(k.get("bf16", 0)), k.get("bcx", 0.0),
                 k.get("bcy", 0.0), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed ({err})")

    for n in SWEEP_GRIDS:
        grid = GridSpec(nx=n, ny=n)
        fields = _swe_fields(n)
        rows = {}
        for name, n_steps, bf16 in (("swe_rk4", 1, False),
                                    ("swe_rk4_bf16", 1, True),
                                    ("swe_rk4_multi", 2, False)):
            k = _swe_constants(grid, n_steps, bf16)

            def new(src, dst, k=k):
                st._launch(src, dst, (0, 0), k)

            def old(src, dst, k=k):
                parent(src, dst, k)

            times = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                times[who].append(_ping_pong_ms(
                    new if who == "new" else old, fields))
            a = tuple(torch.empty_like(t) for t in fields)
            b = tuple(torch.empty_like(t) for t in fields)
            old(fields, a)
            new(fields, b)
            torch.cuda.synchronize()
            rows[name] = {
                "parent_ms": times["parent"], "new_ms": times["new"],
                "parent_ms_mean": sum(times["parent"]) / 2,
                "new_ms_mean": sum(times["new"]) / 2,
                "equal_bit_for_bit": all(torch.equal(x, y)
                                         for x, y in zip(a, b)),
                "max_abs_diff": max(float((x - y).abs().max())
                                    for x, y in zip(a, b)),
                "new_layout": st.swe_kernel_attributes(n_steps, bf16=bf16)}
            del a, b
        print(json.dumps({"phase": "swe_parent", "card": gpu, "grid": n,
                          "parent_source": path, "parent_ptxas": regs,
                          "rows": rows}), flush=True)
        del fields


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
    ap.add_argument("--parent-swe", metavar="FILE",
                    help="an earlier swe_rk4.cu to time beside the current "
                    "kernel (--model swe)")
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
            swe_kernel_extras(gpu)
            if args.parent_swe:
                swe_parent(args.parent_swe, gpu)
        elif model == "primitive":
            primitive_extras(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
