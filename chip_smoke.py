#!/usr/bin/env python3
"""Drive the PyTorch port (njw_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA device

Phases, one JSON line each; any failure exits nonzero before the last line:
  1 toolchain   card name and power limit, torch / CUDA / nvcc / triton
  2 build       every kernel under njw_tpu_torch/ops/csrc/ (one nvcc per
                source, all in parallel), with ptxas registers and spills
  3 kernels     each kernel against its plain PyTorch version on the card
                (swe_rk4: rtol 1e-5 / atol 1e-6 per step, at 2048^2 and on
                grids one point over and under its tile in each axis,
                3 x 3, 3 x 5, 200 x 328 and 1000 x 1500, with and without
                viscosity; baro_stage:
                rtol 1e-5 / atol 1e-5, also on grids under one strip and
                ragged against it (3 x 5, 33 x 65, 37 x 131, 1000 x 1024);
                pe_stage and pe_rk4: rtol 1e-5 /
                atol 1e-4, and 2e-4 with terrain, the JAX kernel tests'
                tolerances; pe_stage also at L = 40 on a grid ragged
                against its tile and at its reach, L = 454; pe_rk4 also at
                L = 40 on a ragged grid and at
                the largest L pe_rk4_kernel_fits admits), and its time
                beside the plain version's, the card's bound and the
                wrapper's host cost per launch (every kernel of these: with
                the built kernel's registers, spill bytes, shared memory,
                blocks per SM and tile; pe_rk4 also clusters on the card
                and blocks per cluster)
  4 parity      kernel steppers vs backend plain: SWE 512^2 (1e-3),
                barotropic 256^2 (normalised 1e-3), PE 128^2 x 8 on the
                auto choice (the stage kernel) and on the whole-step kernel
                (the JAX multi-step tolerances), 12 steps each
  5 oracle      the barotropic kernel path against its NumPy oracle over
                200 steps (normalised 5e-3), the PE core over BASELINE's
                1000 steps on the whole-step kernel and on the auto choice
                (normalised 1e-3)
  6 main paths  the main paths of njw_tpu_torch.weather.main_paths through
                Simulation.from_config with backend auto: SWE 2048^2 (1000
                steps), barotropic 1024^2 (BASELINE config 3, 1000 steps),
                PE 512^2 x 20 (config 4, 100 steps, the four-stage path
                auto takes); then config 4 on the whole-step kernel
                (whole_step=True); every launch count is set to 0 just
                before each and read just after
  7 cli         the CLI's --json runs of the three cores and its --validate
  8 fir kernels fir_band (K7, also serving K9 and K10) against its plain
                version for passes 0, 1, 2, 3 and 6 at the fir_batch shape,
                the fir_suite shape (16 x 10^6) and at (3, 1000), (9, 4096),
                (2, 300), (3, 1000) with NaN in memory past the last row,
                and (5, 1280) through the flat wrapper; the design's edges:
                rows the staging branch takes ((7, 777), (3, 65537), a view
                4 bytes into a NaN buffer), fewer tiles than SMs ((1, 10^6),
                (2, 8192)), rows ending on a tile and ring boundary and one
                frame past it ((2, 16384), (2, 16512), NaN behind), and 1,
                16 and 128 taps (rtol 1e-5 /
                atol 1e-5, or the float32
                summation spread measured against a float64 evaluation of
                the same products, whichever is larger), and against the
                NumPy oracle (np.convolve, a few rows; atol 2e-4 at passes
                0, 3, 6, and 5e-3 of max|ref| at passes 1 and 2, the JAX
                tests' bands); fir_band_bf16 (K8) against its plain version
                within one bf16 ulp (+ that spread) and against the oracle
                within 1.5e-2 of max|ref|, on the same kinds of edges (NaN
                behind the rows; a view 2 bytes in); each kernel's time beside its
                plain version's, the bound (bytes, or tensor-core
                operations at the bf16 peak), the wrapper's host cost and
                the one PyTorch call that computes the same function
                (F.conv1d: float32 with cuDNN's TF32 off, and bf16)
  9 fir paths   the main paths of njw_tpu_torch.signal.main_paths: fir_batch
                (FIRFilter on 1000 x 100000), fir_suite (16 x 10^6) and
                fir_bf16 (fir_batch_bf16 on 1000 x 100000); each launch
                count is set to 0 just before each and must read one launch
                per call just after; the last call's output is held against
                the kernel's plain version on the same input (the
                tolerances of phase 8)
  10 sharded kernels  the padded launches of K1 (local, carry, local2d),
                K5 (local, local2d; one base and four) and K4 (local, carry,
                local2d, carry2d: the last serves K6) on the card against
                their plain versions at the full-width shard shapes of
                njw_tpu_torch.weather.main_paths.SHARDED_PATHS (the
                tolerances of phase 3), again with NaN around the block and
                in each of its cells no interior output depends on; each
                form's time per launch, plain time, bytes bound (interior
                read and written once plus the halo band read) and host
                cost per launch (K1 and K5: with the padded
                instantiation's registers, spill bytes, shared memory,
                blocks per SM and tile)
  11 sharded paths  every SHARDED_PATHS entry on a LocalMesh on cuda:0: SWE
                2048^2 on (4, 1) and (2, 2), PE config 5 (2048^2 x 40) fused
                on (2, 2), (2, 2) with carry=True, (4, 1), and on the stage
                path on (4, 1) and (2, 2); each held against the
                whole-domain path from the same state over the same steps
                (Simulation, backend auto, at the JAX sharded tests'
                tolerances; and the whole-domain run of the same kernel,
                which K4's runs must equal exactly); launch
                counts exactly shards x steps (x 4 on the stage path); ms
                and grid-points/s per step by CUDA events beside the
                whole-domain path's in this call, the host's and the
                device's time per step (which of the two sets the pace),
                the device time of the halo exchanges, and the card's clock,
                power and temperature beside the timed window
  12 variant kernels  the bf16 kernel (K1-bf16) against its plain version
                at 2048^2, a ragged 1000 x 1500 and 5 x 7, with and without
                viscosity (within 1e-3 of max|h| per step, 1/20 of the JAX
                band; its RMS distance from the plain version at most 3e-4
                of the float32 kernel's, which fails a kernel that rounds
                some operations otherwise, such as one fma.bf16; and
                different from the float32 kernel); the multistep
                kernel (K2) with N = 2 bit-equal to two K1 launches (N = 1
                to one) and within rtol 1e-5 / atol 1e-6 per step of its
                plain version; each one's time per launch at 2048^2 beside
                K1's in this call, plain time, bytes bound (24 B/point per
                launch: 12 per step for K2), host cost per launch and the
                built kernel's registers, spill bytes, shared memory,
                blocks per SM and tile
  13 variant paths  VARIANT_PATHS swe_bf16 (1000 steps, 1000 bf16 launches)
                and swe_multistep (1000 steps as 500 K2 launches) at the SWE
                main path's configuration, launch counts exact, ms per RK4
                step beside the float32 main path's; swe_multistep equal to
                the K1 run of the same steps bit for bit, swe_bf16 within the
                JAX band (2e-2 of max|h|) of it
  14 semi-implicit  VARIANT_PATHS swe_si (SWE 512^2) and pe_si (PE 512^2 x
                20), 100 steps each, finite, every launch count 0 (no kernel
                of the port), ms/step and simulated seconds per wall second
                beside their RK4 partners (dt 0.05 on K1, 240 s on the PE
                auto choice); the
                same SI runs on the card against the port on the CPU (SWE
                512^2, PE 128^2 x 20, 20 steps, normalised 1e-4, the winds
                sharing one scale); PE SI against the K4 path at dt 5 s, 40
                steps (ps rtol 2e-4, u atol 2e-2:
                tests/test_weather_primitive.py:470-484), K4 forced
  15 plain sharded paths  every PLAIN_SHARDED_PATHS entry (the plain
                sharded steppers: SWE 2048^2 with overlap on (4, 1), (2, 2)
                and (2, 2) with reflective walls and beta 1e-3, PE config
                4 with overlap on (2, 2) and (4, 1), barotropic config 3 on
                (4, 1) and (2, 2)) on a LocalMesh on cuda:0, held against
                the whole-domain run of the same configuration with
                backend plain on the card over the same steps (SWE rtol /
                atol 1e-5, PE 2e-5, barotropic rtol 5e-4 / atol 5e-5: the
                JAX sharded tests'), its largest difference ("bit-equal"
                where 0), every launch count 0; ms and grid-points/s per
                step by CUDA events, the host's enqueue per step,
                paced_by, the device ms of one step's exchanges (halo pads,
                and the all-to-alls of the barotropic Poisson solves) and
                the mesh's exchange count and bytes per step; SWE 2048^2
                on (2, 2) with overlap equal to the padded form bit for
                bit; SWE 256^2 with winds across reflective walls on (2, 2)
                against the whole-domain plain run (1e-5); then
                njw_tpu_torch.bench.scaling on the card:
                swe_scaling_sweep(2048, 10 steps a call, 1, 2, 4 shards),
                halo_overlap_efficiency(2048, 4 shards, 10 steps) with
                overlap on and off, pe_mesh_shape_sweep(4 shards, 512^2 x
                20, dt 240: K4 per shard, its launches exact), every row
                ok
  16 global paths  the C-grid, nested, spectral and icosahedral cores and
                their sharded forms (GLOBAL_PATHS): each core at a small
                size, 20 steps on the card against the port on the CPU
                (staggered 256^2, nested 128^2, nlat 64 with the fold on
                and off, icosa n = 32; normalised by field group, 1e-4);
                the C-grid tendency against a float64 NumPy evaluation of
                its formulas (1e-4); the whole-domain paths at full width
                through Simulation (staggered 2048^2, nested 512^2, T341
                SWE and BVE, T170 SI order 2 beside RK4, icosa 256) with the
                JAX tests' invariants (the C-grid's mass tendency, the
                Rossby-Haurwitz BVE's phase speed, TC2 on the T341
                transform and on the icosahedron), every launch count 0;
                ms/step and grid-points/s by CUDA events, host enqueue,
                device work (torch.profiler), paced_by, peak memory and, on
                the spectral paths, the Legendre table bytes a step and
                their time at the card's memory rate, and one step under
                torch.profiler in which no op but the products touches a
                table-shaped tensor (no table copy), beside the bytes the
                step allocates; T341 unfolded on
                LocalMesh(4, 1) and icosa 256 on (5, 1) against the
                whole-domain run of the same RK4 arithmetic (the JAX
                sharded tests' tolerances) with the mesh's exchanges a
                step; the folded T341 transform against the unfolded one
                (the stacked contractions 1e-5, 50 steps 1e-4); the CLI on
                each new grid type, --nest-patch, and an --output-format
                netcdf run read back with read_netcdf
  17 analysis paths  the rest of the signal package: every ported
                function on the card against the port on the CPU on the
                same seeded input (normalised 1e-4: sos_apply both ways,
                StreamingIIR, median_filter, LMS and NLMS on both
                engines, block LMS and RLS at 4096 samples, RLS over its
                first 512 samples and its final weights, the PSD, CSD,
                coherence, spectrogram, cepstrum, pitch, the STFT and its
                inverse (the interior), CWT, the DWT and WPT round trips,
                MODWT, Wigner-Ville at n = 1024, mel and MFCC); every
                ANALYSIS_PATHS entry of njw_tpu_torch.signal.main_paths at
                its size (iir_8th_1m, lms_64_50k, blms_64_50k,
                upsample_4x_1m, downsample_4x_1m, median_11_1m,
                fft_1024_x1k, spectrogram_10s, modwt_16x1m), 20 calls
                after 3 by CUDA events, every launch count set to 0 just
                before and read just after (modwt_16x1m: fir_band 8 times
                a call, also read over one call, and each of a call's 8
                launches held against fir_band_plain on its own input,
                rtol 1e-5, atol 1e-5 or the float32 summation spread;
                every other path: no kernel of the port), ms/call, GB/s over
                the inputs read and the outputs written once, host
                enqueue, the device's time for one call (the call captured
                in a CUDA graph and replayed, CUDA events; null where it
                cannot be captured) beside the kernels' sum under
                torch.profiler, paced_by and peak memory; the JAX
                tests' invariants at full width: lms_64_50k's parallel
                engine against the scan engine (2e-4 of max|y|, w 5e-4),
                DWT("db4") and WPT round trips on the modwt_16x1m input
                and the STFT's on two of its rows (atol 1e-3), iir_8th_1m's doubling scan against the
                per-sample scan on its 2^20 samples (rtol / atol 1e-4) and
                StreamingIIR over 1024-sample chunks of all of them
                against that scan (atol 1e-5), both timed;
                and the per-sample engines' cost at 4096 samples (the IIR
                scan and stream, LMS, NLMS and RLS with 64 taps)
  18 particle paths  the N-body and MD packages: every ported function
                on the card against the port on the CPU on the same
                seeded input (normalised 1e-4; the Gram form at its 2e-3
                band: direct, Gram and blocked accelerations, the
                potential and diagnostics, the four integrators over 20
                steps, PM and P3M at mesh 32, the MD forces by all pairs
                and by the cell list, with exclusions on a water box,
                every integrator with no thermostat, Berendsen and
                Nose-Hoover over 20 steps, Ewald; the cell table, its
                coordinates and candidates exactly equal); every
                NBODY_PATHS and MD_PATHS entry at full width (N-body
                4096 Gram, 8192 direct, the 10 000-body galaxy, PM at
                2^20 bodies and mesh 128, P3M at 20 000; MD 1000 and 4096
                atoms, one force evaluation by each method at 5000 and
                20 000, the 3000-atom water box on the cell list): ms/step
                by CUDA events, interactions/s or atom-steps/s, host
                enqueue, the device's work for one step (captured in a
                CUDA graph and replayed; else the profiler), paced_by,
                peak memory, every launch count 0; the JAX tests'
                invariants there (momentum on nbody_direct_8192 within
                1e-3 of sum m |v|, the net PM force within 1e-4 of its
                scale, Gram against direct at 2e-3 on
                nbody_suite_4096's first step, reported as a reference
                fault where it misses, with the card's Gram form held
                to the CPU's; NVE drift under 0.05, the cell list
                against all pairs at rtol / atol 1e-3, on the water box
                with the exclusions at 1e-3 / 1e-2, the water finite with
                bonded energy >= 0, P3M against the Ewald sum at 3%);
                the all-pairs / cell-list crossover at 2000, 5000 and
                20 000 atoms; both CLIs on the card
  19 imaging paths  the medical and geospatial packages: every ported
                function on the card against the port on the CPU on the
                same seeded small input (64^2 images, a 32^3 volume, 48^2
                DEMs, 20 000 points; normalised 1e-4; exactly equal:
                threshold, region_growing, watershed, mrf_segment,
                flow_direction, both flow accumulations, hydrology, the
                min and max rasters; masks and labels (viewshed, adaptive,
                ground and building classes) within a share of 1e-3 of
                differing cells, chan_vese within the larger of 1e-3 and
                twice the CPU's own spread under a one-ulp change of its
                input); every IMAGING_PATHS and GEO_PATHS entry at full
                width (CT 256^2 x 180 and 512^2 x 360, SIRT 30, cone-beam
                FDK 128^3 x 90 views, CG-SENSE 256^2 x 8 coils, TV
                primal-dual, FISTA, radial KB gridding of 102 912
                samples, the filters at 512^2 and a 64 x 256^2 volume,
                the segmentations at 512^2, rigid and B-spline
                registration at 256^2, the suite's 512^2 DEM, the 2048^2
                DEM through every DEM function, a 10^6-point cloud): each
                call's ms by CUDA events, its rate, host enqueue, the
                device's work (a CUDA-graph replay of one call where it
                captures, else torch.profiler's kernel sum), paced_by,
                peak memory, every launch count 0; the JAX tests'
                invariants there (FBP correlation above 0.9, SIRT 30 under
                SIRT 5, fully sampled CG within 1e-3, CG-SENSE on the
                noise-free k-space under 0.5 of zero-filled, primal-dual
                0.7, FISTA 0.8, KB gridding above bilinear and 0.93, the
                rigid shift within 0.7 px and 0.03 rad, flow push equal
                to doubling at 2048^2, cost_distance against scipy's
                Dijkstra at rtol 2e-5 / atol 1e-4 and fill_sinks against
                the Jacobi fixed point at 5e-3 on the 512^2 DEM); where the
                JAX package itself misses a bound at a path's settings
                (CG-SENSE on the noisy k-space, the deformable stage) the
                value is reported against it as a reference behaviour and
                the card is held to the port on the CPU
  20 finance paths  the geo-financial package: every ported function that
                computes on a device on the card against the port on the
                CPU on the same seeded small input (a 48^2 DEM for the
                factors, 200 assets and a 256^2 DEM for the pipeline, 50
                assets x 20 000 normals for the Monte-Carlo functions,
                drawn once and moved, a 4 x 4 option chain; normalised
                1e-4, the flood factors exactly equal, the region ranking
                identical); every FINANCE_PATHS entry at full width (the
                Monte-Carlo VaR of 500 assets at 10^6 and 10^4 samples,
                the wealth of 100 assets over 10 000 paths x 252 days, a
                32 x 32 option chain through Black-Scholes, the Greeks and
                the American tree at 300 steps, a barrier and an Asian
                option on 100 000 paths x 252 steps, the example's
                pipeline on a 2048^2 DEM and 10 000 assets): each call's ms
                by CUDA events, its rate, host enqueue, the device's work
                (a CUDA-graph replay of one call, or of its device part
                where the call reads the host, else torch.profiler's
                kernel sum), paced_by, peak memory, the bytes bound, every
                launch count 0; the JAX tests' invariants there (the 0.95
                VaR within 1% of the Gaussian closed form, CVaR >= VaR,
                the mean wealth within 4 standard errors of (1 + w.mu)^252,
                put-call parity within 1e-3, delta within 2e-3 of N(d1),
                the American put at or above the European, the tree at
                400 steps within 5e-3 and the Monte-Carlo price within 4
                standard errors + 0.05 of Black-Scholes, barrier and Asian
                between 0 and the vanilla, risks in [0, 1], the expected
                loss at most the total value, each scenario VaR monotone
                in its confidence)
  21 suite      python -m njw_tpu_torch.bench --all --device cuda
                --cost-config configs/cloud_gpu_h100.yaml --report, in
                this process, at the suite's defaults (SWE 512^2 through
                Simulation, N-body 4096, MD 1000, FIR 101 taps on 16 x
                10^6 samples, FBP 256^2 x 180, DEM 512^2), each result on
                a line of its own: its keys the JAX package's
                BenchmarkResult fields, its throughput finite and above 0,
                the H100's hourly rate attached, K1 launched 6 x the
                weather repeat's steps and K7 6 x the signal repeat's
                applications (warm-ups included), nothing else anywhere;
                the weather workload's state after execute(repeats=1)
                against the same run on the CPU (normalised 1e-4); one
                application of the signal workload's filter against K7's
                plain version (phase 8's tolerances); chunked_device_put
                and DeviceMemoryManager (to_device, copy, to_host, free)
                bit for bit on cuda, with torch.cuda.memory_stats;
                time_jitted on one K1 step; the native host library's SWE
                RK4 on 256^2 against the port's plain RK4 on the CPU
                (tests/test_native.py's tolerances), or its load_error();
                the phase's seconds by part and the script's total
  22 examples   the eleven examples of njw_tpu_torch.examples at their
                defaults on cuda in this process (the financial one at 10
                assets: its frontier is host NumPy), and
                geofinancial_example --dem-size 2048 --assets 10000, each
                on an example_result line with its seconds and launches:
                K1 exactly 500 in the shallow-water run and 0 elsewhere,
                its h at 50 steps against the CPU's (normalised 1e-4); the
                JAX tests' invariants on what each prints (energy drifts,
                a thermostat's band, TC2 drifts, FBP's correlation, the
                Monte-Carlo VaR against the Gaussian closed form, option
                prices and bounds, VaR monotone in confidence, the chirp's
                ridge); the dashboard on 127.0.0.1, port 0, on cuda with
                phase 21's rows and --demo-geofin's views: every endpoint,
                the four pages, a 404 and an SSE event after a publish,
                each with its ms, /api/cluster naming the card (cuda,
                sm_90), the risk grid within 1e-4 of the CPU's; the views:
                hillshade on the card's DEM against the CPU (1e-6), both
                reports' tables equal to the CPU's, and a view drawing
                with matplotlib or raising its named ImportError without it
Phases 6, 13 and 14 also read the device's work over one step (the
profiler) into paced_by. Then the kernel table ({"kernels": [...]}), the
card line, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time

PARITY_GRID, PARITY_STEPS = 512, 12
RTOL, ATOL = 1e-5, 1e-6   # kernel vs plain version, per step
FLOP_PER_POINT = 4 * 33 + 24          # four tendencies + the combines
VISC_FLOP_PER_POINT = 4 * 2 * 10      # 5-point Laplacian on u and v per stage
BYTES_PER_POINT = 24                  # read u, v, h once, write them once

K3_RTOL, K3_ATOL = 1e-5, 1e-5          # tests/test_weather_barotropic.py
# K5 and K4: tests/test_weather_primitive.py (stage and fused RK4 kernels)
PE_RTOL, PE_ATOL, PE_ATOL_TERRAIN = 1e-5, 1e-4, 2e-4
BARO_FLOP = 34 + 4 + 11       # per point: Arakawa J + combine, beta, nu
PE_FLOP = {1: 116, 4: 140}    # per column and level, by number of bases
# a whole RK4 step: three one-base stages and the fused four-base one
PE_STEP_FLOP = 3 * PE_FLOP[1] + PE_FLOP[4]
HOST_LAUNCHES = 200           # launches timed on the host clock
FIR_RTOL, FIR_ATOL = 1e-5, 1e-5       # fir_band vs its plain version
FIR_ORACLE_ATOL = 2e-4                # tests/test_signal.py:158
FIR_ORACLE_REL_1PASS = 5e-3           # passes 1, 2: tests/test_signal.py:225
FIR_BF16_ORACLE_REL = 1.5e-2          # tests/test_signal.py:206
FIR_ORACLE_ROWS = 4                   # rows held against np.convolve
FIR_SPREAD_ROWS = 16                  # rows of the float64 evaluation
FIR_FRAME_FLOP = 2 * 256 * 128        # one pass of one frame's product
SPIN_CYCLES = 100_000_000     # ~50 ms at the H100's clock: see _events_ms
SCRIPT_T0 = time.perf_counter()  # main() sets it again at its start


def path(model: str):
    """The main path of ``model`` (njw_tpu_torch.weather.main_paths)."""
    from njw_tpu_torch.weather.main_paths import MAIN_PATHS

    return MAIN_PATHS[model]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase, ok=False, error=msg)
    raise SystemExit(1)


def card_state() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi),
    to read beside a timed window."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


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


def _ptxas_registers(source: str, kernel: str) -> dict:
    """{instantiation: registers} of ``kernel`` in ``source``'s ptxas
    report (the build log): one entry per template instantiation."""
    from njw_tpu_torch.ops import _build

    regs, current = {}, None
    for line in _build.build_log(source).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            current = name if kernel in name else None
        elif current is not None and "registers" in line:
            regs[current] = int(line.split("Used ")[1].split()[0])
            current = None
    return regs


def _events_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls, by CUDA events. The device
    first spins for ~50 ms while the host queues all n calls, so that the
    events time the device's work and not the host's pace (a wrapper's
    host cost can exceed a small kernel's time)."""
    import torch

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


def _compare(kern, plain, rtol=RTOL, atol=ATOL) -> tuple[float, float, bool]:
    import torch

    max_abs, max_rel, ok = 0.0, 0.0, True
    for a, b in zip(kern, plain):
        if not bool(torch.isfinite(a).all()):
            return float("inf"), float("inf"), False
        d = (a - b).abs()
        max_abs = max(max_abs, float(d.max()))
        max_rel = max(max_rel, float((d / b.abs().clamp_min(1e-30)).max()))
        ok &= bool((d <= atol + rtol * b.abs()).all())
    return max_abs, max_rel, ok


def roofline_ms(n_bytes: float, n_flop: float,
                tensor_cores: bool = False) -> tuple[float, str]:
    """The least time this card can take to move n_bytes and do n_flop
    operations (float32 outside the tensor cores, or bf16 on them with
    ``tensor_cores``), and which of the two sets it."""
    import torch
    from njw_tpu_torch.platform.device import spec_for

    bw_gbps, fp32_tflops, bf16_tc_tflops = spec_for(
        torch.cuda.get_device_name(0))
    if bw_gbps is None:
        fail("kernels", "card not in the spec table of platform/device.py")
    t_bytes = n_bytes / (bw_gbps * 1e9) * 1e3
    peak = bf16_tc_tflops if tensor_cores else fp32_tflops
    t_ops = n_flop / (peak * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(points: int, viscous: bool) -> tuple[float, str]:
    """Least time for one fused SWE step on this card, and what bounds it."""
    flop = FLOP_PER_POINT + (VISC_FLOP_PER_POINT if viscous else 0)
    return roofline_ms(BYTES_PER_POINT * points, flop * points)


def distinct_bytes(*tensors) -> int:
    """Bytes of the distinct buffers among ``tensors``: each input read
    once and each output written once."""
    seen = {}
    for t in tensors:
        if t is not None:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def reset_counts() -> None:
    from njw_tpu_torch.ops import launch_counters

    for wrapper, attr in launch_counters().values():
        setattr(wrapper, attr, 0)


def counts() -> dict:
    from njw_tpu_torch.ops import launch_counts

    return launch_counts()


def host_us_per_launch(launch) -> float:
    """Host time of one call of a kernel's wrapper: HOST_LAUNCHES calls on
    the host clock with no synchronise inside (the device runs behind)."""
    import torch

    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_LAUNCHES):
        launch()
    us = (time.perf_counter() - t0) * 1e6 / HOST_LAUNCHES
    torch.cuda.synchronize()
    return us


def swe_layout_info(**form) -> dict:
    """The built SWE kernel instantiation of a form (the rule's layout):
    registers, spill (local) bytes, shared bytes, threads, blocks per SM,
    tile (stencil.swe_kernel_attributes); fails if the wrapper's
    shared-memory or thread rule disagrees with the built kernel."""
    import torch
    from njw_tpu_torch.ops import stencil

    info = stencil.swe_kernel_attributes(
        index=torch.cuda.current_device(), **form)
    n = form.get("n_steps", 1)
    lay = stencil.SweLayout(**info["layout"])
    if (info["smem_bytes"], info["threads"]) != (lay.smem_bytes(n),
                                                 lay.threads(n)):
        fail("kernel_time", f"swe_rk4 {form}: the wrapper's layout rule "
             "disagrees with the built kernel's")
    return info


def kernels_vs_plain() -> dict:
    import torch
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.weather import GridSpec, make_initial_state

    swe = path("swe")
    GRID, DT = swe.config["grid_width"], swe.config["dt"]
    CORIOLIS = swe.config["coriolis_f"]
    rule = stencil.swe_layout(1)
    noise = {"amplitude": 0.1, "seed": 3}
    cases = [
        # name, ny, nx, ic, ic kwargs, dt, f, nu
        ("main_2048", GRID, GRID, swe.ic, swe.ic_params, DT, CORIOLIS, 0.0),
        ("viscous_512", 512, 512, "vortex", {"strength": 2.0}, 0.01,
         CORIOLIS, 0.02),
        ("ragged_200x328", 200, 328, "breaking_wave", {"amplitude": 0.3},
         0.005, CORIOLIS, 0.0),
        ("ragged_1000x1500", 1000, 1500, "breaking_wave",
         {"amplitude": 0.3}, 0.005, CORIOLIS, 0.02),
        ("tiny_3x5", 3, 5, "random", {"amplitude": 0.1, "seed": 1}, 0.001,
         CORIOLIS, 0.0),
        ("tiny_3x3", 3, 3, "random", noise, 0.001, CORIOLIS, 0.02),
        # one point over and under the rule's tile in each axis
        (f"tile_over_under_{rule.ty + 1}x{rule.tx - 1}", rule.ty + 1,
         rule.tx - 1, "random", noise, 0.01, CORIOLIS, 0.0),
        (f"tile_under_over_{rule.ty - 1}x{rule.tx + 1}", rule.ty - 1,
         rule.tx + 1, "random", noise, 0.01, CORIOLIS, 0.02),
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
    ms = _events_ms(kernel_step, 200)
    plain_call = lambda: stencil.swe_rk4_step_plain(s.u, s.v, s.h, **kw)
    _events_ms(plain_call, 2)
    plain_ms = _events_ms(plain_call, 10)
    b_ms, b_by = bound_ms(GRID * GRID, viscous=False)
    host_us = host_us_per_launch(kernel_step)
    layout = swe_layout_info()
    emit("kernel_time", ok=True, kernel="swe_rk4", shape=[GRID, GRID],
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         fraction_of_bound=b_ms / ms, library_ms=None,
         host_us_per_launch=host_us, **layout)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "host_us": host_us,
            "layout": layout}


def parity_gate() -> None:
    import torch

    swe = path("swe")
    size = dict(grid_width=PARITY_GRID, grid_height=PARITY_GRID)
    ker = swe.simulation(backend="kernel", **size)
    ref = swe.simulation(backend="plain", **size)
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
    """SWE 2048^2 (the headline configuration) through the auto backend."""
    import torch
    from njw_tpu_torch.platform.device import spec_for

    swe = path("swe")
    sim = swe.simulation()
    if sim.stepper.name != "rk4_kernel":
        fail("main_path", f"auto backend picked {sim.stepper.name}")
    r = _drive(sim, swe.warm, swe.steps)
    n = swe.config["grid_width"] * swe.config["grid_height"]
    b_ms, b_by = bound_ms(n, viscous=False)
    bw = spec_for(torch.cuda.get_device_name(0))[0]
    emit("main_path", ok=r["finite"] and r["launches"]["swe_rk4"] == swe.steps,
         grid=swe.config["grid_width"], steps=swe.steps, warm_steps=swe.warm,
         stepper=sim.stepper.name, grid_points_per_s=n / (r["ms_per_step"]
                                                          / 1e3),
         bound_us=b_ms * 1e3, bound_by=b_by, hbm_gbps_assumed=bw,
         fraction_of_bound=b_ms / r["ms_per_step"], **r)
    _check_main("main_path", r, {"swe_rk4": swe.steps})
    return r


def _baro_main_fields(grid):
    """psi and zeta of the barotropic main path's initial state."""
    from njw_tpu_torch.ops.spectral import poisson_solve
    from njw_tpu_torch.weather import diagnostics, make_initial_state

    baro = path("barotropic")
    s = make_initial_state(baro.ic, grid, device="cuda", **baro.ic_params)
    zeta = diagnostics(s, grid)["vorticity"].contiguous()
    return poisson_solve(zeta, grid.dx, grid.dy), zeta


def baro_kernel() -> dict:
    """K3 against its plain version, its time and its host cost."""
    import torch
    from njw_tpu_torch.ops import baro_stencil as bs
    from njw_tpu_torch.weather import GridSpec

    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(ny, nx):
        return torch.rand(ny, nx, device="cuda", generator=gen) * 2.0 - 1.0

    cfg = path("barotropic").config
    n, dt = cfg["grid_width"], cfg["dt"]
    main_grid = GridSpec(nx=n, ny=n)
    psi, zeta = _baro_main_fields(main_grid)
    cases = [  # name, grid, psi, zeta, base, c_dt, beta, nu
        ("main_1024", main_grid, psi, zeta, zeta, 0.5 * dt, cfg["beta"],
         cfg["viscosity"]),
        ("beta_nu_256", GridSpec(nx=256, ny=256, dy=1.3), rand(256, 256),
         rand(256, 256), rand(256, 256), 0.7, 0.3, 0.02),
        ("ragged_200x328", GridSpec(nx=328, ny=200), rand(200, 328),
         rand(200, 328), rand(200, 328), 0.7, 0.1, 0.01),
        ("tiny_3x5", GridSpec(nx=5, ny=3), rand(3, 5), rand(3, 5),
         rand(3, 5), 0.7, 0.0, 0.0),
        # under one strip, ragged against the strip in both axes, odd
        ("sub_strip_33x65", GridSpec(nx=65, ny=33), rand(33, 65),
         rand(33, 65), rand(33, 65), 0.7, 0.1, 0.01),
        ("ragged_37x131", GridSpec(nx=131, ny=37), rand(37, 131),
         rand(37, 131), rand(37, 131), 0.7, 0.1, 0.01),
        ("ragged_1000x1024", GridSpec(nx=1024, ny=1000), rand(1000, 1024),
         rand(1000, 1024), rand(1000, 1024), 0.7, 0.1, 0.01),
    ]
    worst = 0.0
    for name, grid, p, z, b, c_dt, beta, nu in cases:
        kw = dict(grid=grid, c_dt=c_dt, beta=beta, nu=nu)
        kern = bs.baro_stage_cuda(p, z, b, **kw)
        plain = bs.baro_stage_plain(p, z, b, **kw)
        torch.cuda.synchronize()
        max_abs, max_rel, ok = _compare([kern], [plain], K3_RTOL, K3_ATOL)
        worst = max(worst, max_abs)
        emit("kernel_vs_plain", ok=ok, kernel="baro_stage", case=name,
             shape=list(grid.shape), beta=beta, nu=nu, max_abs_err=max_abs,
             max_rel_err=max_rel, rtol=K3_RTOL, atol=K3_ATOL)
        if not ok:
            fail("kernel_vs_plain", f"baro_stage disagrees with its plain "
                 f"version on {name}")
        if name == "main_1024":
            main_err = max_abs

    # time at the main path's shape: psi, zeta, base and out distinct, as
    # in stages 2-4; four rotating sets (67 MB) so that L2 (50 MB) does
    # not hold the inputs of the next launch
    kw = dict(grid=main_grid, c_dt=0.5 * dt, beta=cfg["beta"],
              nu=cfg["viscosity"])
    sets = [(psi.clone(), zeta.clone(), zeta + 0.1, torch.empty_like(zeta))
            for _ in range(4)]
    turn = [0]

    def launch():
        p, z, b, o = sets[turn[0]]
        bs.baro_stage_cuda(p, z, b, out=o, **kw)
        turn[0] = (turn[0] + 1) % len(sets)

    _events_ms(launch, 20)
    ms = _events_ms(launch, 200)
    ms_l2 = _events_ms(lambda: bs.baro_stage_cuda(*sets[0][:3],
                                                  out=sets[0][3], **kw), 200)
    plain = lambda: bs.baro_stage_plain(*sets[0][:3], **kw)  # noqa: E731
    _events_ms(plain, 2)
    plain_ms = _events_ms(plain, 20)
    b_ms, b_by = roofline_ms(distinct_bytes(*sets[0]), BARO_FLOP * n * n)
    host_us = host_us_per_launch(launch)
    strip = bs.baro_strip(n)
    unit = main_grid.dx == 1.0 and main_grid.dy == 1.0
    built = dict(bs.baro_kernel_attributes(
        strip, unit=unit, index=torch.cuda.current_device()),
        strip=list(bs.BARO_STRIPS[strip]), unit_spacing=unit)
    emit("kernel_time", ok=True, kernel="baro_stage", shape=[n, n], ms=ms,
         ms_inputs_in_l2=ms_l2, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, fraction_of_bound=b_ms / ms, library_ms=None,
         host_us_per_launch=host_us, built=built)
    return {"max_abs_err": main_err, "max_abs_err_all_cases": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "host_us": host_us, "built": built}


def _pe_grid(L, ny, nx):
    from njw_tpu_torch.weather import GridSpec

    cfg = path("primitive").config
    return GridSpec(nx=nx, ny=ny, levels=L, dx=cfg["dx"], dy=cfg["dy"])


def _pe_state(grid, seed, phi_s=None):
    """The baroclinic initial state with a seeded ps perturbation, and
    seeded noise on the winds and T so that every term is live."""
    import dataclasses

    import torch
    from njw_tpu_torch.weather.primitive import pe_initial_state

    s = pe_initial_state(grid, device="cuda", seed=seed, phi_s=phi_s,
                         **path("primitive").ic_params)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def noise(t, amp):
        return t + amp * torch.randn(t.shape, device="cuda", generator=gen)

    return dataclasses.replace(s, u=noise(s.u, 1.0), v=noise(s.v, 1.0),
                               T=noise(s.T, 0.5))


def _mountain(grid, height=1500.0):
    import torch

    y = torch.arange(grid.ny, device="cuda", dtype=torch.float32)[:, None]
    x = torch.arange(grid.nx, device="cuda", dtype=torch.float32)[None, :]
    cy, cx = (grid.ny - 1) / 2, (grid.nx - 1) / 2
    sy, sx = max(grid.ny / 8, 1), max(grid.nx / 8, 1)
    return (height * torch.exp(-(((y - cy) / sy) ** 2
                                 + ((x - cx) / sx) ** 2))).contiguous()


def pe_kernel() -> dict:
    """K5 against its plain version, its time and its host cost."""
    import torch
    from njw_tpu_torch.ops import pe_stencil as ps

    third = 1.0 / 3.0
    rk4 = (-third, third, 2.0 * third, third)
    cfg = path("primitive").config
    L, n, dt = cfg["num_levels"], cfg["grid_width"], cfg["dt"]
    main_grid = _pe_grid(L, n, n)
    cases = [  # name, grid, number of bases, terrain
        ("main_512x512x20", main_grid, 1, False),
        ("main_4_bases", main_grid, 4, False),
        ("terrain_512x512x20", main_grid, 1, True),
        ("ragged_200x328x5", _pe_grid(5, 200, 328), 4, True),
        ("tiny_3x5x2", _pe_grid(2, 3, 5), 1, False),
        # ragged against the 64-column tile and the rule's rows at L = 40
        ("ragged_37x50x40", _pe_grid(40, 37, 50), 4, True),
        ("ragged_13x200x40", _pe_grid(40, 13, 200), 1, False),
        # the reach: the largest L the stage kernel takes (1-row tiles)
        (f"reach_5x37x{ps.STAGE_MAX_LEVELS}",
         _pe_grid(ps.STAGE_MAX_LEVELS, 5, 37), 4, True),
    ]
    worst, main_err = 0.0, None
    for name, grid, nbase, terrain in cases:
        phi_s = _mountain(grid) if terrain else None
        cur = _pe_state(grid, 1, phi_s)
        bases = [_pe_state(grid, 2 + g) for g in range(nbase - 1)] + [cur]
        kw = dict(grid=grid, c_dt=0.5 * dt if nbase == 1 else dt / 6.0,
                  coriolis_f=cfg["coriolis_f"],
                  base_coeffs=(1.0,) if nbase == 1 else rk4, phi_s=phi_s)
        kern = ps.pe_stage_cuda(cur, bases, **kw)
        plain = ps.pe_stage_plain(cur, bases, **kw)
        torch.cuda.synchronize()
        atol = PE_ATOL_TERRAIN if terrain else PE_ATOL
        max_abs, max_rel, ok = _compare([t for _, t in kern.items()],
                                        [t for _, t in plain.items()],
                                        PE_RTOL, atol)
        worst = max(worst, max_abs)
        emit("kernel_vs_plain", ok=ok, kernel="pe_stage", case=name,
             shape=[grid.levels, grid.ny, grid.nx], bases=nbase,
             terrain=terrain, max_abs_err=max_abs, max_rel_err=max_rel,
             rtol=PE_RTOL, atol=atol)
        if not ok:
            fail("kernel_vs_plain", f"pe_stage disagrees with its plain "
                 f"version on {name}")
        if name == "main_512x512x20":
            main_err = max_abs
        del kern, plain, cur, bases

    # time at the main path's shape, in its two forms: one base distinct
    # from cur (stages 2 and 3) and the fused last stage, whose bases are
    # (s, s1, s2, cur)
    s, s1, s2, cur = (_pe_state(main_grid, 10 + g) for g in range(4))
    out = cur.map(torch.empty_like)
    kw = dict(grid=main_grid, coriolis_f=cfg["coriolis_f"])
    forms = {1: ((s,), (1.0,), 0.5 * dt), 4: ((s, s1, s2, cur), rk4, dt / 6)}
    res = {}
    for nbase, (bases, coeffs, c_dt) in forms.items():
        def launch():
            ps.pe_stage_cuda(cur, bases, out=out, c_dt=c_dt,
                             base_coeffs=coeffs, **kw)

        _events_ms(launch, 3)
        ms = _events_ms(launch, 50)
        plain = lambda: ps.pe_stage_plain(  # noqa: E731
            cur, bases, c_dt=c_dt, base_coeffs=coeffs, **kw)
        _events_ms(plain, 1)
        plain_ms = _events_ms(plain, 3)
        tensors = [t for st in (cur, *bases, out) for _, t in st.items()]
        b_ms, b_by = roofline_ms(distinct_bytes(*tensors),
                                 PE_FLOP[nbase] * L * n * n)
        host_us = host_us_per_launch(launch)
        emit("kernel_time", ok=True, kernel="pe_stage", bases=nbase,
             shape=[L, n, n], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, fraction_of_bound=b_ms / ms, library_ms=None,
             host_us_per_launch=host_us, built=pe_stage_built(L))
        res[nbase] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "host_us": host_us}
    out = dict(res[1])
    out.update({"built": pe_stage_built(L),
                "max_abs_err": main_err, "max_abs_err_all_cases": worst,
                "ms_4_bases": res[4]["ms"],
                "plain_ms_4_bases": res[4]["plain_ms"],
                "bound_ms_4_bases": res[4]["bound_ms"],
                "host_us_4_bases": res[4]["host_us"]})
    return out


def pe_stage_built(levels: int) -> dict:
    """The built stage kernel the rule takes at ``levels``: registers,
    spill bytes, shared bytes, threads, blocks per SM and tile
    (pe_stencil.stage_kernel_attributes); fails if the wrapper's rule
    disagrees with the built kernel's."""
    import torch
    from njw_tpu_torch.ops import pe_stencil as ps

    rows = ps.stage_tile_rows(levels)
    one, four = (ps.stage_kernel_attributes(
        levels, nbase=nbase, index=torch.cuda.current_device())
        for nbase in (1, 4))
    for a in (one, four):
        if (a["tile"], a["smem_bytes"]) != (
                [rows, ps.STAGE_TILE_COLUMNS],
                ps.stage_smem_bytes(rows, levels)):
            fail("kernel_time", f"pe_stage at L = {levels}: the wrapper's "
                 "tile rule disagrees with the built kernel's")
    return dict(one, registers_4_bases=four["registers"],
                local_bytes_4_bases=four["local_bytes"],
                blocks_per_sm_4_bases=four["blocks_per_sm"])


def pe_rk4_kernel() -> dict:
    """K4 against its plain version, its time and its host cost."""
    import torch
    from njw_tpu_torch.ops import pe_stencil as ps

    cfg = path("primitive").config
    L, n, dt = cfg["num_levels"], cfg["grid_width"], cfg["dt"]
    main_grid = _pe_grid(L, n, n)
    limit = max(n for n in range(1, 1024) if ps.pe_rk4_kernel_fits(n))
    cases = [  # name, grid, terrain
        ("main_512x512x20", main_grid, False),
        ("terrain_512x512x20", main_grid, True),
        ("ragged_200x328x5", _pe_grid(5, 200, 328), True),
        ("tiny_3x5x2", _pe_grid(2, 3, 5), False),
        # the design's limits: config 5's L at a ragged shape (a cluster
        # of two blocks, tile 8) and the largest L a cluster holds (eight
        # blocks, tile 1)
        ("ragged_203x141x40", _pe_grid(40, 203, 141), True),
        (f"limit_37x23x{limit}", _pe_grid(limit, 37, 23), False),
    ]
    worst, main_err = 0.0, None
    for name, grid, terrain in cases:
        phi_s = _mountain(grid) if terrain else None
        s = _pe_state(grid, 1, phi_s)
        kw = dict(grid=grid, dt=dt, coriolis_f=cfg["coriolis_f"], phi_s=phi_s)
        kern = ps.pe_rk4_step_cuda(s, **kw)
        plain = ps.pe_rk4_step_plain(s, **kw)
        torch.cuda.synchronize()
        atol = PE_ATOL_TERRAIN if terrain else PE_ATOL
        max_abs, max_rel, ok = _compare([t for _, t in kern.items()],
                                        [t for _, t in plain.items()],
                                        PE_RTOL, atol)
        worst = max(worst, max_abs)
        emit("kernel_vs_plain", ok=ok, kernel="pe_rk4", case=name,
             shape=[grid.levels, grid.ny, grid.nx], terrain=terrain,
             layout=ps.rk4_layout(grid.levels)._asdict(),
             max_abs_err=max_abs,
             max_rel_err=max_rel, rtol=PE_RTOL, atol=atol)
        if not ok:
            fail("kernel_vs_plain", f"pe_rk4 disagrees with its plain "
                 f"version on {name}")
        if name == "main_512x512x20":
            main_err = max_abs
        del kern, plain, s

    # time at the main path's shape, ping-ponging two states as the stepper
    # does
    s = _pe_state(main_grid, 10)
    bufs = [s, s.map(torch.empty_like)]
    kw = dict(grid=main_grid, dt=dt, coriolis_f=cfg["coriolis_f"])
    turn = [0]

    def launch():
        ps.pe_rk4_step_cuda(bufs[turn[0]], out=bufs[1 - turn[0]], **kw)
        turn[0] ^= 1

    _events_ms(launch, 3)
    ms = _events_ms(launch, 50)
    for (_, a), (_, b) in zip(bufs[0].items(), _pe_state(main_grid, 10).items()):
        a.copy_(b)
    plain = lambda: ps.pe_rk4_step_plain(bufs[0], **kw)  # noqa: E731
    _events_ms(plain, 1)
    plain_ms = _events_ms(plain, 3)
    tensors = [t for st in bufs for _, t in st.items()]
    b_ms, b_by = roofline_ms(distinct_bytes(*tensors),
                             PE_STEP_FLOP * L * n * n)
    host_us = host_us_per_launch(launch)
    lay = ps.rk4_layout(L)
    blocks, clusters = ps.rk4_occupancy(L, lay, torch.cuda.current_device())
    layout = {"registers": _ptxas_registers("pe_rk4", "pe_rk4_kernel"),
              "smem_bytes": ps.rk4_smem_bytes_built(L, lay.tile, lay.ncta),
              "blocks_per_sm": blocks, "clusters_on_card": clusters,
              "blocks_per_cluster": lay.ncta, "tile": lay.tile,
              "threads_per_block": ps.RK4_THREADS}
    if layout["smem_bytes"] != ps.rk4_smem_bytes(L, lay.tile, lay.ncta):
        fail("kernel_time", "pe_rk4: the wrapper's shared-memory rule "
             "disagrees with the built kernel's")
    emit("kernel_time", ok=True, kernel="pe_rk4", shape=[L, n, n], ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         fraction_of_bound=b_ms / ms, library_ms=None,
         host_us_per_launch=host_us, **layout)
    return {"max_abs_err": main_err, "max_abs_err_all_cases": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "host_us": host_us, **layout}


def _normalised_diff(a, b) -> float:
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def _pe_simulation(whole_step: bool, ic_params=None, **overrides):
    """The PE main path (or ``overrides`` of it) on one forced stepper: a
    ``Simulation`` built with the stepper factory
    ``make_pe_kernel_rk4_stepper(..., whole_step=)``: the whole-step
    kernel K4 (True) or the four K5 stages (False)."""
    from njw_tpu_torch.ops.pe_stencil import make_pe_kernel_rk4_stepper
    from njw_tpu_torch.weather import Simulation
    from njw_tpu_torch.weather.primitive import (
        pe_initial_state, pe_tendencies,
    )

    pe = path("primitive")
    cfg = pe.sim_config(device="cuda", **overrides)
    grid, params = cfg.grid_spec(), cfg.physics()
    sim = Simulation(
        pe_initial_state(grid, device="cuda",
                         **(pe.ic_params if ic_params is None
                            else ic_params)),
        lambda s: pe_tendencies(s, grid, params), dt=cfg.dt, grid=grid,
        stepper_factory=lambda _tendency: make_pe_kernel_rk4_stepper(
            grid, params, cfg.dt, whole_step=whole_step))
    sim.config = cfg
    return sim


def parity_cores() -> None:
    """The kernel steppers against backend plain on the card, 12 steps."""
    import torch

    baro, pe = path("barotropic"), path("primitive")
    small_pe = dict(grid_width=128, grid_height=128, num_levels=8)
    runs = [  # kernel run, plain run, expected stepper name
        (baro.simulation(backend="kernel", grid_width=256, grid_height=256),
         baro.simulation(backend="plain", grid_width=256, grid_height=256),
         "baro_rk4_kernel"),
        (pe.simulation(backend="kernel", **small_pe),
         pe.simulation(backend="plain", **small_pe), "pe_rk4_kernel"),
        (_pe_simulation(True, **small_pe),
         pe.simulation(backend="plain", **small_pe), "pe_rk4_kernel_fused"),
    ]
    for ker, ref, name in runs:
        cfg = ker.config
        if ker.stepper.name != name or ref.stepper.name != "rk4":
            fail("parity", f"wrong steppers {ker.stepper.name}/"
                 f"{ref.stepper.name}")
        ker.step(PARITY_STEPS)
        ref.step(PARITY_STEPS)
        diffs, ok = {}, True
        for (field, a), (_, b) in zip(ker.state.items(), ref.state.items()):
            diffs[field] = _normalised_diff(a, b)
            if cfg.model == "barotropic":
                ok &= diffs[field] <= 1e-3
            elif field == "ps":     # tests/test_weather_primitive.py:215-218
                ok &= bool(torch.allclose(a, b, rtol=1e-4, atol=1e-3))
            else:
                ok &= bool(torch.allclose(a, b, rtol=1e-3, atol=1e-3))
        emit("parity", ok=ok, model=cfg.model, stepper=name,
             shape=[cfg.num_levels, cfg.grid_height, cfg.grid_width]
             if cfg.model == "primitive" else [cfg.grid_height,
                                                cfg.grid_width],
             steps=PARITY_STEPS, normalised_max_diff=diffs)
        if not ok:
            fail("parity", f"{cfg.model} {name}: kernel path diverged from "
                 "the plain integrators")


def oracle_cores() -> None:
    """The kernel paths on the card against the port's NumPy oracles."""
    import numpy as np
    from njw_tpu_torch.weather import SimConfig, Simulation
    from njw_tpu_torch.weather.oracle import BarotropicOracle, PEOracle

    steps = 200
    baro = SimConfig(model="barotropic", grid_width=64, grid_height=64,
                     dt=0.05, beta=1e-3, viscosity=1e-3, backend="kernel",
                     device="cuda")
    sim = Simulation.from_config(baro, "vortex", strength=2.0)
    z0 = sim.state.zeta.cpu().numpy()
    sim.step(steps)
    ref = {"zeta": BarotropicOracle(dx=1.0, dy=1.0, beta=1e-3,
                                    viscosity=1e-3).run(z0, 0.05, steps)}
    runs = [("barotropic", sim, ref, 5e-3, steps)]

    # the PE core over BASELINE's 1000 steps (tests/test_weather_primitive.py
    # :73-97), on K4 (whole_step=True) and on the auto backend's choice
    pe_steps = 1000
    small = dict(grid_width=48, grid_height=48, num_levels=4, dx=1e5,
                 dy=1e5, dt=30.0, coriolis_f=1e-4)
    names = ("u", "v", "T", "q", "ps")
    pe_ref, pe_s0 = None, None
    for sim in (_pe_simulation(True, {"u_jet": 10.0, "perturb": 0.5},
                               **small),
                Simulation.from_config(SimConfig(
                    model="primitive", backend="kernel", device="cuda",
                    **small), "baroclinic", u_jet=10.0, perturb=0.5)):
        s0 = sim.state.to_numpy()
        sim.step(pe_steps)
        if pe_ref is None or any(not np.array_equal(s0[k], pe_s0[k])
                                 for k in names):
            pe_s0 = s0
            pe_ref = dict(zip(names, PEOracle(
                dx=1e5, dy=1e5, coriolis_f=1e-4).run(
                    tuple(s0[k] for k in names), 30.0, pe_steps)))
        runs.append(("primitive", sim, pe_ref, 1e-3, pe_steps))
    if runs[-1][1].stepper.name != "pe_rk4_kernel" or \
            runs[-2][1].stepper.name != "pe_rk4_kernel_fused":
        fail("oracle", "PE oracle runs on the wrong steppers")

    for model, sim, ref, tol, n in runs:
        got = sim.state.to_numpy()
        diffs = {k: float(np.abs(got[k] - r).max()
                          / (np.abs(r).max() + 1e-30)) for k, r in ref.items()}
        ok = all(np.isfinite(got[k]).all() for k in ref) and \
            max(diffs.values()) <= tol
        emit("oracle", ok=ok, model=model, stepper=sim.stepper.name,
             steps=n, normalised_max_diff=diffs, tol=tol)
        if not ok:
            fail("oracle", f"{model} kernel path disagrees with its oracle")


def _drive(sim, warm: int, steps: int) -> dict:
    """Warm up, set every launch count to 0, run ``steps`` steps timed by
    CUDA events and the host clock, and read the counts."""
    import torch

    sim.step(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sim.metrics.reset()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.step(steps)
    end.record()
    end.synchronize()
    launched = counts()
    finite = all(bool(torch.isfinite(t).all()) for _, t in sim.state.items())
    ms_step = start.elapsed_time(end) / steps
    host_ms = sim.metrics.compute_time_ms / steps
    peak = torch.cuda.max_memory_allocated()
    # host cost of one step: enqueued with no synchronise inside
    n_host = 20
    t0 = time.perf_counter()
    sim.step(n_host, synchronize=False)
    host_enqueue_ms = (time.perf_counter() - t0) * 1e3 / n_host
    torch.cuda.synchronize()
    # None where the profiler recorded no kernel of the step (it saw none
    # of the bf16 and two-step SWE kernels' steps in phase 13)
    device_ms = _device_ms(lambda: sim.step(1, synchronize=False)) or None
    return {"launches": launched, "finite": finite, "ms_per_step": ms_step,
            "host_ms_per_step": host_ms,
            "host_enqueue_ms_per_step": host_enqueue_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms and device_ms / ms_step,
            "paced_by": paced_by(ms_step, host_enqueue_ms, device_ms),
            "peak_mem_bytes": peak}


def _device_ms(fn) -> float:
    """The device's own work in one call of fn(): the summed time of the
    kernels it ran, under torch.profiler (CUDA activity alone: tracing the
    host side of thousands of calls costs seconds). CUDA events cannot
    time it where a step enqueues more calls than the launch queue holds:
    a spin ahead of them ends before the host has queued them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def paced_by(ms: float, host_ms: float, device_ms: float = None) -> str:
    """Which clock set the pace of a timed run, one rule for every phase:
    "host" when the run took more than 1.1x the device's own work per step
    (``device_ms``, where measured: the device waited), or when the host
    took at least 0.9 of the run's time per step or call to enqueue it;
    else "device"."""
    if device_ms is not None and ms > 1.1 * device_ms:
        return "host"
    return "host" if host_ms >= 0.9 * ms else "device"


def _check_main(phase: str, r: dict, want: dict) -> None:
    """Fail on non-finite fields or launch counts other than ``want``
    (kernels not named there: 0)."""
    want = {k: want.get(k, 0) for k in r["launches"]}
    if not r["finite"]:
        fail(phase, "non-finite fields")
    if r["launches"] != want:
        fail(phase, f"launch counts {r['launches']}, expected {want}")


def main_path_baro() -> dict:
    """Barotropic 1024^2 (BASELINE config 3) through the auto backend."""
    import math

    baro = path("barotropic")
    sim = baro.simulation()
    if sim.stepper.name != "baro_rk4_kernel":
        fail("main_path_baro", f"auto backend picked {sim.stepper.name}")
    r = _drive(sim, baro.warm, baro.steps)
    n = baro.config["grid_width"] * baro.config["grid_height"]
    # the step's function: zeta read and written once; four K3 stages, two
    # complex FFTs (5 N log2 N each) and a spectral divide per stage, and
    # the accumulator pass
    fft_flop = 5.0 * n * math.log2(n)
    b_ms, b_by = roofline_ms(8 * n, 4 * (BARO_FLOP * n + 2 * fft_flop + 2 * n)
                             + 5 * n)
    want = {"baro_stage": 4 * baro.steps}
    emit("main_path_baro", ok=r["finite"] and r["launches"]["baro_stage"]
         == want["baro_stage"],
         grid=[baro.config["grid_height"], baro.config["grid_width"]],
         steps=baro.steps, warm_steps=baro.warm, stepper=sim.stepper.name,
         grid_points_per_s=n / (r["ms_per_step"] / 1e3),
         step_bound_ms=b_ms, step_bound_by=b_by,
         fraction_of_bound=b_ms / r["ms_per_step"], **r)
    _check_main("main_path_baro", r, want)
    return r


def _pe_step_bound(cfg) -> tuple:
    """(bound of the step's function, bound of the four-stage path), ms."""
    L = cfg["num_levels"]
    n = cfg["grid_width"] * cfg["grid_height"]
    state_bytes = (4 * L + 1) * n * 4
    flop = PE_STEP_FLOP * L * n
    # the step's function: the state read and written once
    step_ms, step_by = roofline_ms(2 * state_bytes, flop)
    # the stage path: stage 1 reads s and writes s1, stages 2-3 read
    # (s_k, s) and write, the fused last stage reads (s3, s, s1, s2)
    stages_ms, _ = roofline_ms((2 + 3 + 3 + 5) * state_bytes, flop)
    return step_ms, step_by, stages_ms


def main_path_pe(whole_step: bool = False) -> dict:
    """PE 512^2 x 20 (BASELINE config 4): through the auto backend (four
    K5 stage launches per step), or with ``whole_step`` on the whole-step
    kernel K4 (one launch per step, ``_pe_simulation``)."""
    pe = path("primitive")
    cfg = pe.config
    if whole_step:
        phase, sim = "main_path_pe_whole_step", _pe_simulation(True)
        name = "pe_rk4_kernel_fused"
    else:
        phase, sim = "main_path_pe", pe.simulation()
        name = "pe_rk4_kernel"
    if sim.stepper.name != name:
        fail(phase, f"stepper {sim.stepper.name}, expected {name}")
    r = _drive(sim, pe.warm, pe.steps)
    n = cfg["grid_width"] * cfg["grid_height"]
    b_ms, b_by, stages_ms = _pe_step_bound(cfg)
    want = ({"pe_rk4": pe.steps} if name == "pe_rk4_kernel_fused"
            else {"pe_stage": 4 * pe.steps})
    emit(phase, ok=r["finite"] and r["launches"] == {
        **{k: 0 for k in r["launches"]}, **want},
         grid=[cfg["num_levels"], cfg["grid_height"], cfg["grid_width"]],
         steps=pe.steps, warm_steps=pe.warm, stepper=sim.stepper.name,
         grid_points_per_s=n / (r["ms_per_step"] / 1e3),
         step_bound_ms=b_ms, step_bound_by=b_by,
         fraction_of_bound=b_ms / r["ms_per_step"],
         stage_path_bound_ms=stages_ms,
         fraction_of_stage_path_bound=stages_ms / r["ms_per_step"], **r)
    _check_main(phase, r, want)
    return r


def cli() -> None:
    from njw_tpu_torch.weather.__main__ import main as cli_main

    runs = {
        "json": ["--width", "512", "--height", "512", "--steps", "200",
                 "--coriolis", "1e-4", "--json"],
        "validate": ["--validate", "--width", "128", "--height", "128",
                     "--steps", "200", "--method", "rk4"],
        "barotropic": ["--model", "barotropic", "--width", "256", "--height",
                       "256", "--steps", "100", "--json"],
        "primitive": ["--model", "primitive", "--levels", "8", "--width",
                      "128", "--height", "128", "--dx", "1e5", "--dy", "1e5",
                      "--dt", "30", "--coriolis", "1e-4", "--steps", "50",
                      "--json"],
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


def _fir_path(name: str):
    """A main path of njw_tpu_torch.signal.main_paths."""
    from njw_tpu_torch.signal.main_paths import MAIN_PATHS

    return MAIN_PATHS[name]


def _fir_signal(shape, seed: int):
    """Standard normal float32 samples on the card."""
    import numpy as np
    import torch

    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).cuda()


def _nan_after(t):
    """``t`` at the start of a buffer whose rest is NaN (a view of it), so
    that a kernel that reads past the last sample (the ragged last frame)
    turns valid outputs NaN."""
    import torch

    buf = torch.full((t.numel() + 4096,), float("nan"), dtype=t.dtype,
                     device=t.device)
    buf[:t.numel()] = t.flatten()
    return buf[:t.numel()].view(t.shape)


def _nan_around(t, offset: int):
    """``t`` as a view ``offset`` elements into a NaN buffer: rows that
    are not 16-byte aligned, with NaN on both sides."""
    import torch

    buf = torch.full((t.numel() + offset + 4096,), float("nan"),
                     dtype=t.dtype, device=t.device)
    buf[offset:offset + t.numel()] = t.flatten()
    return buf[offset:offset + t.numel()].view(t.shape)


def _fir_spread(x, taps, plan) -> float:
    """The float32 summation spread of the plain version: twice its
    largest distance from a float64 evaluation of the same bf16 products,
    on the first FIR_SPREAD_ROWS rows."""
    import torch
    from njw_tpu_torch.signal import fir_cuda as fc
    from njw_tpu_torch.signal.filters import fir_bands, split_terms

    xs = x[:FIR_SPREAD_ROWS]
    na = 1 + max(a for a, _ in plan)
    nb = 1 + max(b for _, b in plan)
    terms_x = split_terms(xs.float(), na) if xs.dtype == torch.float32 \
        else [xs.float()]
    terms_h = fir_bands(taps, x.device).terms[:nb].float()
    f32 = fc._product(terms_x, terms_h, plan, x.shape[1])
    f64 = fc._product([t.double() for t in terms_x], terms_h.double(), plan,
                      x.shape[1])
    return 2.0 * float((f32.double() - f64).abs().max())


def _fir_oracle(x, taps, rows: int = FIR_ORACLE_ROWS):
    """np.convolve of the first ``rows`` rows of x, in float64."""
    import numpy as np

    xr = x[:rows].float().cpu().numpy().astype(np.float64)
    ref = np.stack([np.convolve(r, taps.astype(np.float64))[:x.shape[1]]
                    for r in xr])
    return ref


def _fir_vs_plain(kern, x, taps, passes) -> tuple[dict, bool]:
    """fir_band's output ``kern`` against its plain version on the same x:
    rtol FIR_RTOL and atol FIR_ATOL or the float32 summation spread,
    whichever is larger. Returns the fields to emit and whether it agrees."""
    from njw_tpu_torch.signal import fir_cuda as fc

    plain = fc.fir_band_plain(x, taps, passes=passes)
    spread = _fir_spread(x, taps, fc.PLANS[passes])
    atol = max(FIR_ATOL, spread)
    max_abs, max_rel, ok = _compare([kern], [plain], FIR_RTOL, atol)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "rtol": FIR_RTOL,
            "atol": atol, "f32_sum_spread": spread}, ok


def _fir_bf16_vs_plain(kern, x, taps, taps_passes, out_dtype
                       ) -> tuple[dict, bool]:
    """fir_band_bf16's output ``kern`` against its plain version on the same
    x: one bf16 ulp (+ the float32 summation spread) for bf16 output, rtol
    FIR_RTOL and that atol for float32 output."""
    import torch
    from njw_tpu_torch.signal import fir_cuda as fc

    plain = fc.fir_band_bf16_plain(x, taps, taps_passes=taps_passes,
                                   out_dtype=out_dtype)
    spread = _fir_spread(x, taps, fc.TAPS_PLANS[taps_passes])
    d = (kern.float() - plain.float()).abs()
    if out_dtype == torch.bfloat16:
        _, e = torch.frexp(plain.float())
        ulp = torch.ldexp(torch.ones_like(d), e - 8)
        ok = bool((d <= ulp + spread).all())
        tol = {"bf16_ulps": 1, "plus_f32_sum_spread": spread}
    else:
        ok = bool((d <= max(FIR_ATOL, spread)
                   + FIR_RTOL * plain.abs()).all())
        tol = {"rtol": FIR_RTOL, "atol": max(FIR_ATOL, spread)}
    ok &= bool(torch.isfinite(kern).all())
    return {"max_abs_err": float(d.max()), "tol": tol}, ok


def _fir_time(kernel, x, taps, launch, plain, products, library_call,
              **fields) -> dict:
    """One FIR kernel at a main path's shape: ms per launch by events, its
    plain version's ms, the bound (x read once, an output of x's type
    written once; ``products`` band products per frame on the tensor
    cores),
    the wrapper's host cost and F.conv1d in x's type, the one PyTorch call
    that computes the same function."""
    import torch
    import torch.nn.functional as F

    _events_ms(launch, 3)
    ms = _events_ms(launch, 20)
    _events_ms(plain, 1)
    plain_ms = _events_ms(plain, 3)
    k = len(taps)
    w = torch.from_numpy(taps[::-1].copy()).to(x.device, x.dtype)
    w = w.view(1, 1, k)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = lambda: F.conv1d(x[:, None], w, padding=k - 1)[..., :x.shape[1]]  # noqa: E731,E501
        _events_ms(conv, 2)
        library_ms = _events_ms(conv, 10)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rows, n = x.shape
    frames = -(-n // 128)
    n_bytes = distinct_bytes(x) * 2
    b_ms, b_by = roofline_ms(n_bytes,
                             rows * frames * FIR_FRAME_FLOP * products,
                             tensor_cores=True)
    host_us = host_us_per_launch(launch)
    emit("kernel_time", ok=True, kernel=kernel, shape=[rows, n], taps=k,
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         fraction_of_bound=b_ms / ms, gbps=n_bytes / (ms * 1e6),
         library_ms=library_ms, library_call=library_call,
         host_us_per_launch=host_us, **fields)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "host_us": host_us, "library_ms": library_ms}


def fir_kernel() -> dict:
    """fir_band (K7, serving K9 and K10) against its plain version and the
    NumPy oracle on the card, at the shapes of the fir_batch and fir_suite
    paths and at small ragged ones; its time, bound, host cost and library
    time."""
    import numpy as np
    import torch
    from njw_tpu_torch.signal import fir_cuda as fc

    torch.backends.cuda.matmul.allow_tf32 = False  # plain: float32 products
    path_, suite = _fir_path("fir_batch"), _fir_path("fir_suite")
    taps_main = path_.taps()
    rnd_taps = (np.random.default_rng(7).standard_normal(101)
                .astype(np.float32) * 0.1)        # tests/test_signal.py:154
    cases = [  # name, x, taps, wrapper
        ("main_1000x100000", _fir_signal(path_.shape, 1), taps_main,
         fc.fir_batch_lanes),
        ("suite_16x1000000", _fir_signal(suite.shape, 8), suite.taps(),
         fc.fir_batch_lanes),
        ("3x1000", _fir_signal((3, 1000), 2), rnd_taps, fc.fir_batch_lanes),
        ("9x4096", _fir_signal((9, 4096), 3), rnd_taps, fc.fir_batch_lanes),
        ("2x300", _fir_signal((2, 300), 4), rnd_taps, fc.fir_batch_lanes),
        ("nan_after_3x1000", _nan_after(_fir_signal((3, 1000), 6)),
         rnd_taps, fc.fir_batch_lanes),
        ("flat_5x1280", _fir_signal((5, 1280), 5), rnd_taps,
         fc.fir_batch_flat),
        # the design's edges (fir_band.cuh): the staging branch, fewer
        # tiles than SMs, a tile and ring boundary, the band's extremes
        ("staged_7x777", _fir_signal((7, 777), 9), rnd_taps,
         fc.fir_batch_lanes),
        ("staged_3x65537", _fir_signal((3, 65537), 10), rnd_taps,
         fc.fir_batch_lanes),
        ("staged_view_4B_in_3x1000", _nan_around(_fir_signal((3, 1000), 11),
                                                 1), rnd_taps,
         fc.fir_batch_lanes),
        ("1x1000000", _fir_signal((1, 10**6), 12), rnd_taps,
         fc.fir_batch_lanes),
        ("2x8192", _fir_signal((2, 8192), 13), rnd_taps, fc.fir_batch_lanes),
        ("ring_end_2x16384", _nan_after(_fir_signal((2, 16384), 14)),
         rnd_taps, fc.fir_batch_lanes),
        ("ring_end_plus_frame_2x16512",
         _nan_after(_fir_signal((2, 16512), 15)), rnd_taps,
         fc.fir_batch_lanes),
        *((f"taps{k}_3x20000", _fir_signal((3, 20000), 16 + k),
           np.random.default_rng(k).standard_normal(k).astype(np.float32)
           * 0.1, fc.fir_batch_lanes) for k in (1, 16, 128)),
    ]
    main_err, worst = None, 0.0
    for name, x, taps, wrapper in cases:
        oracle = _fir_oracle(x, taps)
        scale = float(np.abs(oracle).max())
        for passes in (fc.PLANS if wrapper is fc.fir_batch_lanes
                       else (1, 2, 3)):
            kern = wrapper(x, taps, passes=passes)
            torch.cuda.synchronize()
            check, ok = _fir_vs_plain(kern, x, taps, passes)
            got = kern[:FIR_ORACLE_ROWS].cpu().numpy()
            oracle_err = float(np.abs(got - oracle).max())
            if passes in (0, 3, 6):
                oracle_ok = oracle_err <= FIR_ORACLE_ATOL
                oracle_tol = {"atol": FIR_ORACLE_ATOL}
            else:
                oracle_ok = oracle_err <= FIR_ORACLE_REL_1PASS * scale
                oracle_tol = {"rel_to_max_ref": FIR_ORACLE_REL_1PASS}
            emit("kernel_vs_plain", ok=ok and oracle_ok, kernel="fir_band",
                 case=name, wrapper=wrapper.__name__, shape=list(x.shape),
                 taps=len(taps), passes=passes, **check,
                 oracle_max_abs_err=oracle_err, oracle_max_ref=scale,
                 oracle_tol=oracle_tol)
            if not (ok and oracle_ok):
                fail("kernel_vs_plain", f"fir_band disagrees with its plain "
                     f"version or the oracle on {name}, passes {passes}")
            worst = max(worst, check["max_abs_err"])
            if name.startswith("main") and passes == 3:
                main_err = check["max_abs_err"]
            del kern
        torch.cuda.empty_cache()

    # time at the main path's shape (400 MB in, 400 MB out: past L2)
    x = cases[0][1]
    del cases
    torch.cuda.empty_cache()
    t = _fir_time(
        "fir_band", x, taps_main,
        lambda: fc.fir_band_cuda(x, taps_main, passes=3),
        lambda: fc.fir_band_plain(x, taps_main, passes=3), 3,
        "F.conv1d float32, cudnn.allow_tf32=False", passes=3)
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": main_err, "max_abs_err_all_cases": worst,
            "built": fc.fir_kernel_attributes(torch.float32, 3), **t}


def fir_bf16_kernel() -> dict:
    """fir_band_bf16 (K8) against its plain version and the oracle; its
    time, bound, host cost and library time."""
    import numpy as np
    import torch
    from njw_tpu_torch.signal import fir_cuda as fc

    path_ = _fir_path("fir_bf16")
    taps_main = path_.taps()
    rnd_taps = (np.random.default_rng(7).standard_normal(101)
                .astype(np.float32) * 0.1)
    cases = [("main_1000x100000", _fir_signal(path_.shape, 1), taps_main),
             ("3x1000", _fir_signal((3, 1000), 2), rnd_taps),
             ("2x300", _fir_signal((2, 300), 4), rnd_taps),
             ("nan_after_3x1000", _fir_signal((3, 1000), 6), rnd_taps),
             # the design's edges: the staging branch (n no multiple of
             # 8; a view 2 bytes in), fewer tiles than SMs, a ring's end
             ("nan_after_staged_7x777", _fir_signal((7, 777), 9), rnd_taps),
             ("staged_view_2B_in_3x1000", _fir_signal((3, 1000), 11),
              rnd_taps),
             ("1x1000000", _fir_signal((1, 10**6), 12), rnd_taps),
             ("nan_after_ring_end_2x24576", _fir_signal((2, 24576), 14),
              rnd_taps),
             ("nan_after_ring_end_plus_frame_2x24704",
              _fir_signal((2, 24704), 15), rnd_taps)]
    main_err, worst = None, 0.0
    for name, x32, taps in cases:
        oracle = _fir_oracle(x32, taps)
        scale = float(np.abs(oracle).max())
        x = x32.to(torch.bfloat16)
        if name.startswith("nan_after"):
            x = _nan_after(x)
        elif name.startswith("staged_view"):
            x = _nan_around(x, 1)
        for taps_passes, out_dtype in ((1, torch.bfloat16),
                                       (2, torch.bfloat16),
                                       (1, torch.float32)):
            kern = fc.fir_batch_bf16(x, taps, taps_passes=taps_passes,
                                     out_dtype=out_dtype)
            torch.cuda.synchronize()
            check, ok = _fir_bf16_vs_plain(kern, x, taps, taps_passes,
                                           out_dtype)
            oracle_rel = float(np.abs(kern[:FIR_ORACLE_ROWS].float().cpu()
                                      .numpy() - oracle).max()) / scale
            oracle_ok = oracle_rel < FIR_BF16_ORACLE_REL
            emit("kernel_vs_plain", ok=ok and oracle_ok,
                 kernel="fir_band_bf16", case=name, shape=list(x.shape),
                 taps=len(taps), taps_passes=taps_passes,
                 out_dtype=str(out_dtype), **check,
                 oracle_rel_err=oracle_rel,
                 oracle_tol_rel_to_max_ref=FIR_BF16_ORACLE_REL)
            if not (ok and oracle_ok):
                fail("kernel_vs_plain", f"fir_band_bf16 disagrees with its "
                     f"plain version or the oracle on {name}, taps_passes "
                     f"{taps_passes}, {out_dtype}")
            worst = max(worst, check["max_abs_err"])
            if name.startswith("main") and taps_passes == 1 and \
                    out_dtype == torch.bfloat16:
                main_err = check["max_abs_err"]
            del kern
        torch.cuda.empty_cache()

    x = cases[0][1].to(torch.bfloat16)
    del cases
    torch.cuda.empty_cache()
    t = _fir_time(
        "fir_band_bf16", x, taps_main,
        lambda: fc.fir_band_bf16_cuda(x, taps_main),
        lambda: fc.fir_band_bf16_plain(x, taps_main), 1,
        "F.conv1d bfloat16", taps_passes=1)
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": main_err, "max_abs_err_all_cases": worst,
            "built": fc.fir_kernel_attributes(torch.bfloat16, 1), **t}


def main_path_fir(name: str) -> dict:
    """One FIR main path as a user calls it: launches, ms per call by
    events, host enqueue per call, the bound, whether host or device sets
    the pace, and the last timed call's output against the kernel's plain
    version on the same input."""
    import torch

    p = _fir_path(name)
    x = p.signal(seed=0)
    call = p.call()
    for _ in range(p.warm):
        y = call(x)
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(p.calls):
        y = call(x)
    end.record()
    end.synchronize()
    launched = counts()
    ms = start.elapsed_time(end) / p.calls
    finite = bool(torch.isfinite(y).all()) and tuple(y.shape) == p.shape
    t0 = time.perf_counter()
    for _ in range(p.calls):
        call(x)
    host_ms = (time.perf_counter() - t0) * 1e3 / p.calls
    torch.cuda.synchronize()
    rows, n = p.shape
    frames = -(-n // 128)
    n_bytes = distinct_bytes(x) + y.numel() * y.element_size()
    passes = 3 if p.dtype == torch.float32 else 1
    b_ms, b_by = roofline_ms(n_bytes, rows * frames * FIR_FRAME_FLOP * passes,
                             tensor_cores=True)
    if p.dtype == torch.float32:
        check, agrees = _fir_vs_plain(y, x, p.taps(), passes)
    else:
        check, agrees = _fir_bf16_vs_plain(y, x, p.taps(), passes,
                                           torch.bfloat16)
    want = {p.kernel: p.calls}
    r = {"launches": launched, "finite": finite, "ms_per_call": ms,
         "host_enqueue_ms_per_call": host_ms,
         "paced_by": paced_by(ms, host_ms)}
    emit(f"main_path_{name}", ok=finite and agrees and launched == {
        **{k: 0 for k in launched}, **want}, shape=[rows, n],
         dtype=str(p.dtype), taps=p.num_taps, calls=p.calls, warm=p.warm,
         gbps=n_bytes / (ms * 1e6), bound_ms=b_ms, bound_by=b_by,
         fraction_of_bound=b_ms / ms, vs_plain=check, **r)
    _check_main(f"main_path_{name}", r, want)
    if not agrees:
        fail(f"main_path_{name}", "the path's output disagrees with the "
             "kernel's plain version on the same input")
    del x, y
    torch.cuda.empty_cache()
    return r


def _sharded_path(name: str):
    """A sharded path of njw_tpu_torch.weather.main_paths."""
    from njw_tpu_torch.weather.main_paths import SHARDED_PATHS

    return SHARDED_PATHS[name]


def _nan_framed(a, halo, reach: int, margin: int = 8):
    """``a``, a padded block (interior at ``halo``; hx = 0: x whole), as a
    view inside a NaN buffer ``margin`` cells wider on every side, with NaN
    also in each of the block's cells that no interior output depends on
    (distances dy, dx outside the interior with dy + dx > ``reach``: 4 for
    the whole-step kernels, 1 for the stage kernel)."""
    import torch

    hy, hx = halo
    rows, cols = a.shape[-2:]
    buf = torch.full(a.shape[:-2] + (rows + 2 * margin, cols + 2 * margin),
                     float("nan"), device=a.device)
    view = buf[..., margin:margin + rows, margin:margin + cols]
    view.copy_(a)

    def dist(n, h):
        i = torch.arange(n, device=a.device)
        return torch.clamp(torch.maximum(h - i, i - (n - h - 1)), min=0)

    view.masked_fill_(dist(rows, hy)[:, None] + dist(cols, hx)[None, :]
                      > reach, float("nan"))
    return view


def _padded_bound(planes: int, ly: int, lx: int, reach: int, two_d: bool,
                  extra_planes: int, flop: float) -> tuple:
    """Bound of one padded launch: ``planes`` planes of the block read over
    the interior and the halo band the kernel reads (``reach`` rows, and
    columns when ``two_d``), ``extra_planes`` more interior planes read
    (the bases), the interior written once; ``flop`` operations."""
    cells = ly * lx + 2 * reach * lx + (2 * reach * ly if two_d else 0)
    n_bytes = 4 * (planes * cells + extra_planes * ly * lx
                   + planes * ly * lx)
    return roofline_ms(n_bytes, flop)


def sharded_kernels() -> dict:
    """Phase 10: each padded launch of K1, K5 and K4 against its plain
    version at the full-width shard shapes, clean and NaN-framed; its time,
    plain time, bound and host cost. Returns {kernel: {form: numbers}}."""
    import torch
    from njw_tpu_torch.ops import pe_stencil as ps
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.weather import GridSpec, make_initial_state

    swe_path, pe_path = _sharded_path("swe_2x2"), _sharded_path(
        "pe5_fused_2x2")
    swe_cfg, pe_cfg = swe_path.sim_config(), pe_path.sim_config()
    N, L = pe_cfg.grid_width, pe_cfg.num_levels
    swe_kw = dict(dt=swe_cfg.dt, dx=swe_cfg.dx, dy=swe_cfg.dy,
                  coriolis_f=swe_cfg.coriolis_f)
    pe_kw = dict(dx=pe_cfg.dx, dy=pe_cfg.dy, coriolis_f=pe_cfg.coriolis_f)
    third = 1.0 / 3.0
    rk4 = (-third, third, 2.0 * third, third)
    res: dict = {"swe_rk4": {}, "pe_stage": {}, "pe_rk4": {}}

    def shard(mesh):
        return N // mesh[0], N // mesh[1]

    def report(kernel, form, mesh, halo, kern, plain, run, plain_run, tol,
               bound, **extra):
        """Compare (clean and NaN), time, emit; ``kern(framed)`` and
        ``plain()`` give lists of interior tensors, ``run``/``plain_run``
        launch once into preallocated outputs."""
        rtol, atol = tol
        want = plain()
        checks = {}
        for case, arg in (("clean", False), ("nan", True)):
            got = kern(arg)
            torch.cuda.synchronize()
            checks[case] = _compare(got, want, rtol, atol)
            del got
        ok = all(c[2] for c in checks.values())
        emit("sharded_kernel_vs_plain", ok=ok, kernel=kernel, form=form,
             mesh=list(mesh), halo=list(halo), rtol=rtol, atol=atol,
             max_abs_err=checks["clean"][0], max_rel_err=checks["clean"][1],
             max_abs_err_nan=checks["nan"][0], **extra)
        if not ok:
            fail("sharded_kernel_vs_plain", f"{kernel} {form} disagrees with "
                 "its plain version (clean or NaN-framed)")
        del want
        _events_ms(run, 3)
        ms = _events_ms(run, 20)
        _events_ms(plain_run, 1)
        plain_ms = _events_ms(plain_run, 2)
        b_ms, b_by = bound
        host_us = host_us_per_launch(run)
        emit("sharded_kernel_time", ok=True, kernel=kernel, form=form,
             mesh=list(mesh), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, fraction_of_bound=b_ms / ms,
             host_us_per_launch=host_us, **extra)
        torch.cuda.empty_cache()
        return {"max_abs_err": checks["clean"][0],
                "max_abs_err_nan": checks["nan"][0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "host_us": host_us}

    # K1: local and carry on a (4, 1) shard, local2d on a (2, 2) shard
    for form, mesh, halo in (("local", (4, 1), (4, 0)),
                             ("carry", (4, 1), (4, 0)),
                             ("local2d", (2, 2), (4, 4))):
        ly, lx = shard(mesh)
        hy, hx = halo
        g = GridSpec(nx=lx + 2 * hx, ny=ly + 2 * hy)
        # seeded noise: every halo row and column differs from the rows a
        # wrapped index would read in its place
        s = make_initial_state("random", g, device="cuda", amplitude=0.1,
                               seed=ly + hx)
        blk = (s.u, s.v, s.h)
        dst = tuple(torch.empty_like(t) for t in blk)
        inner = tuple(t[hy:hy + ly] for t in dst) if form == "carry" else \
            tuple(torch.empty(ly, lx, device="cuda") for _ in blk)

        def kern(nan, blk=blk, halo=halo, form=form):
            ins = tuple(_nan_framed(t, halo, 4) for t in blk) if nan else blk
            if form == "carry":
                out = stencil.swe_rk4_step_carry(*ins, hy=halo[0], **swe_kw)
                return [o[halo[0]:halo[0] + ly] for o in out]
            if form == "local":
                return stencil.swe_rk4_step_local(*ins, hy=halo[0], **swe_kw)
            return stencil.swe_rk4_step_local2d(*ins, hy=halo[0],
                                                hx=halo[1], **swe_kw)

        def plain(blk=blk, halo=halo):
            return stencil.swe_rk4_step_padded_plain(*blk, halo=halo,
                                                     **swe_kw)

        def run(blk=blk, halo=halo, inner=inner):
            stencil.swe_rk4_step_padded(*blk, halo=halo, out=inner, **swe_kw)

        layout = swe_layout_info(padded=(1, int(hx > 0)))
        res["swe_rk4"][form] = report(
            "swe_rk4", form, mesh, halo, kern, plain, run, plain,
            (RTOL, ATOL), _padded_bound(3, ly, lx, 4, bool(hx), 0,
                                        FLOP_PER_POINT * ly * lx),
            layout=layout)
        res["swe_rk4"][form]["layout"] = layout
        del s, blk, dst, inner

    # K5: local on a (4, 1) shard, local2d on a (2, 2) shard; one base
    # (stages 1-3) and four (the last stage, bases s, s1, s2, s3)
    res["pe_stage_built"] = built = pe_stage_built(L)
    for form, mesh, halo in (("local", (4, 1), (1, 0)),
                             ("local2d", (2, 2), (1, 1))):
        ly, lx = shard(mesh)
        hy, hx = halo
        cur = _pe_state(_pe_grid(L, ly + 2 * hy, lx + 2 * hx), 21)
        grid_i = _pe_grid(L, ly, lx)
        for nbase in (1, 4):
            bases = [_pe_state(grid_i, 22 + g) for g in range(nbase)]
            kw = dict(halo=halo, c_dt=0.5 * pe_cfg.dt if nbase == 1
                      else pe_cfg.dt / 6.0,
                      base_coeffs=(1.0,) if nbase == 1 else rk4, **pe_kw)
            out = bases[0].map(torch.empty_like)

            def kern(nan, cur=cur, bases=bases, kw=kw, form=form):
                c = cur.map(lambda a: _nan_framed(a, kw["halo"], 1)) \
                    if nan else cur
                f = ps.pe_stage_local if form == "local" else \
                    ps.pe_stage_local2d
                extra = {} if form == "local" else {"hx": kw["halo"][1]}
                k = {key: v for key, v in kw.items() if key != "halo"}
                return [t for _, t in f(c, bases, hy=kw["halo"][0], **extra,
                                        **k).items()]

            def plain(cur=cur, bases=bases, kw=kw):
                return [t for _, t in ps.pe_stage_padded_plain(
                    cur, bases, **kw).items()]

            def run(cur=cur, bases=bases, kw=kw, out=out):
                ps.pe_stage_padded(cur, bases, out=out, **kw)

            res["pe_stage"][f"{form}_{nbase}_bases"] = report(
                "pe_stage", form, mesh, halo, kern, plain, run, plain,
                (PE_RTOL, PE_ATOL),
                _padded_bound(4 * L + 1, ly, lx, 1, bool(hx),
                              nbase * (4 * L + 1),
                              PE_FLOP[nbase] * L * ly * lx),
                bases=nbase, built=built)
            del bases, out
        del cur

    # K4: local and carry on a (4, 1) shard, local2d and carry2d (K6) on a
    # (2, 2) shard
    for form, mesh, halo in (("local", (4, 1), (4, 0)),
                             ("carry", (4, 1), (4, 0)),
                             ("local2d", (2, 2), (4, 4)),
                             ("carry2d", (2, 2), (4, 4))):
        ly, lx = shard(mesh)
        hy, hx = halo
        s = _pe_state(_pe_grid(L, ly + 2 * hy, lx + 2 * hx), 31)
        kw = dict(dt=pe_cfg.dt, **pe_kw)
        carry = form.startswith("carry")
        nxt = s.map(torch.empty_like) if carry else None
        out = ps.interior(nxt, halo) if carry else \
            _pe_state(_pe_grid(L, ly, lx), 32)

        def kern(nan, s=s, halo=halo, form=form, kw=kw):
            x = s.map(lambda a: _nan_framed(a, halo, 4)) if nan else s
            hy, hx = halo
            f = {"local": ps.pe_rk4_local, "carry": ps.pe_rk4_carry,
                 "local2d": ps.pe_rk4_local2d,
                 "carry2d": ps.pe_rk4_carry2d}[form]
            extra = {"hx": hx} if form.endswith("2d") else {}
            got = f(x, hy=hy, **extra, **kw)
            if form.startswith("carry"):
                got = ps.interior(got, halo)
            return [t for _, t in got.items()]

        def plain(s=s, halo=halo, kw=kw):
            return [t for _, t in ps.pe_rk4_padded_plain(
                s, halo=halo, **kw).items()]

        def run(s=s, halo=halo, kw=kw, out=out):
            ps.pe_rk4_padded(s, halo=halo, out=out, **kw)

        res["pe_rk4"][form] = report(
            "pe_rk4", form, mesh, halo, kern, plain, run, plain,
            (PE_RTOL, PE_ATOL),
            _padded_bound(4 * L + 1, ly, lx, 4, bool(hx), 0,
                          PE_STEP_FLOP * L * ly * lx))
        del s, nxt, out
    torch.cuda.empty_cache()
    return res


def _max_abs(a_state, b_state) -> float:
    return max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(a_state.items(), b_state.items()))


def _within(a_state, b_state, tol: dict) -> bool:
    import torch

    return all(bool(torch.isfinite(a).all()) and bool(
        torch.allclose(a, b, rtol=tol[n][0], atol=tol[n][1]))
        for (n, a), (_, b) in zip(a_state.items(), b_state.items()))


# the JAX sharded tests' tolerances (tests/test_parallel_halo.py:398-424,
# :270-305): SWE h 1e-5 / 1e-5, u and v 1e-5 / 1e-4; PE 1e-3 / 5e-4
SHARD_TOL = {"h": (1e-5, 1e-5), "u": (1e-5, 1e-4), "v": (1e-5, 1e-4)}
SHARD_TOL_PE = {n: (1e-3, 5e-4) for n in ("u", "v", "T", "q", "ps")}


def _whole_domain(p, kind: str):
    """The whole-domain run of a sharded path's configuration: Simulation
    with backend auto ("auto"), or on the sharded path's own kernel
    ("stage": the four-stage stepper, "whole_step": K4)."""
    if kind == "auto":
        return p.simulation()
    return _pe_simulation(kind == "whole_step", **p.overrides)


def _time_steps(step, steps: int) -> tuple:
    """(ms per step by events, host ms per step) of ``step()``, which runs
    ``steps`` steps; the host time is that of the whole call, until it
    returns."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    step()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps, host_ms


def _step_costs(stepper, shards, reps: int = 3) -> tuple:
    """(host ms, device ms) of one step: a two-step call less a one-step
    call, which cancels the call's copies of the shards in and out; the
    median of ``reps`` pairs. Host: the enqueue on the host clock after a
    synchronise. Device: CUDA events with the device kept busy first
    (``_events_ms``), so that they time the device's work and not the
    host's pace (two steps stay well inside the launch queue)."""
    import statistics

    import torch

    n = stepper.n_steps
    host, dev = [], []
    try:
        for _ in range(reps):
            h, d = {}, {}
            for k in (1, 2):
                stepper.n_steps = k
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stepper(shards)
                h[k] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                d[k] = _events_ms(lambda: stepper(shards), 1)
            host.append(h[2] - h[1])
            dev.append(d[2] - d[1])
    finally:
        stepper.n_steps = n
    return statistics.median(host), statistics.median(dev)


def sharded_paths() -> dict:
    """Phase 11: every SHARDED_PATHS entry on a LocalMesh on cuda:0."""
    import torch
    from njw_tpu_torch.parallel import LocalMesh
    from njw_tpu_torch.weather.main_paths import SHARDED_PATHS

    results = {}
    refs: dict = {}   # (model, overrides) -> {kind: whole-domain run}
    for name, p in SHARDED_PATHS.items():
        cfg = p.sim_config()
        # the whole-domain run on the sharded path's own kernel
        same = {"pe_stage": "stage", "pe_rk4": "whole_step"}.get(p.kernel,
                                                                "auto")
        key = (p.model, tuple(sorted(p.overrides.items())))
        if key not in refs:
            refs.clear()
            torch.cuda.empty_cache()
            refs[key] = {}
        bucket = refs[key]
        for kind in ("auto", same):
            if kind in bucket:
                continue
            sim = _whole_domain(p, kind)
            s0 = sim.state.map(torch.clone)
            sim.step(p.steps)
            ref = sim.state.map(torch.clone)
            whole_ms, _ = _time_steps(lambda: sim.step(p.steps), p.steps)
            emit("sharded_path_reference", ok=True, model=cfg.model,
                 stepper=sim.stepper.name, kind=kind, ms_per_step=whole_ms,
                 card=card_state())
            bucket[kind] = (s0, ref, whole_ms, sim.stepper.name)
            del sim
            torch.cuda.empty_cache()
        s0, ref_auto, auto_ms, auto_name = bucket["auto"]
        _, ref_same, same_ms, same_name = bucket[same]

        mesh = LocalMesh(*p.mesh)
        stepper = p.make_stepper(mesh)
        shards = mesh.shard_state(s0)
        reset_counts()
        got = mesh.gather_state(stepper(shards))
        torch.cuda.synchronize()
        launched = counts()
        want = {k: 0 for k in launched}
        want[p.kernel] = mesh.size * p.steps * p.launches_per_step
        diff_same = _max_abs(got, ref_same)
        diff_auto = _max_abs(got, ref_auto)
        tol = SHARD_TOL_PE if cfg.model == "primitive" else SHARD_TOL
        ok_auto = _within(got, ref_auto, tol)
        # K4's sharded runs equal its whole-domain run bit for bit: every
        # column's arithmetic is the same at every tile position
        ok_same = _within(got, ref_same, tol) and (
            p.kernel != "pe_rk4" or diff_same == 0.0)
        del got

        card_before = card_state()
        ms, call_host_ms = _time_steps(lambda: stepper(shards), p.steps)
        card_after = card_state()
        host_ms, device_ms = _step_costs(stepper, shards)
        _events_ms(stepper.exchange, 2)
        exchange_ms = _events_ms(stepper.exchange, 10)
        # the stage path exchanges before each of its four stages
        exchange_ms_step = exchange_ms * p.launches_per_step
        n = cfg.grid_width * cfg.grid_height
        if cfg.model == "primitive":
            b_ms, b_by, _ = _pe_step_bound(dataclasses.asdict(cfg))
        else:
            b_ms, b_by = bound_ms(n, viscous=False)
        ok = ok_auto and ok_same and launched == want
        r = {"stepper": stepper.name, "mesh": list(p.mesh),
             "shards": mesh.size, "steps": p.steps, "launches": launched,
             "expected_launches": want, "max_abs_diff_vs_same_kernel":
             diff_same, "same_kernel_path": same_name,
             "max_abs_diff_vs_auto": diff_auto, "auto_path": auto_name,
             "ms_per_step": ms, "grid_points_per_s": n / (ms / 1e3),
             "whole_domain_ms_per_step": same_ms,
             "whole_domain_auto_ms_per_step": auto_ms,
             "host_enqueue_ms_per_step": host_ms,
             "host_ms_per_step_of_call": call_host_ms,
             "device_ms_per_step": device_ms,
             "paced_by": paced_by(ms, call_host_ms, device_ms),
             "exchange_ms": exchange_ms,
             "exchange_ms_per_step": exchange_ms_step,
             "exchange_share": exchange_ms_step / ms, "step_bound_ms": b_ms,
             "step_bound_by": b_by, "fraction_of_bound": b_ms / ms,
             "card_before_after": [card_before, card_after]}
        emit(f"sharded_path_{name}", ok=ok, tol=tol, **r)
        if launched != want:
            fail(f"sharded_path_{name}", f"launch counts {launched}, "
                 f"expected {want}")
        if not ok:
            fail(f"sharded_path_{name}", "the sharded run disagrees with the "
                 "whole-domain run")
        results[name] = r
        del stepper, shards
        torch.cuda.empty_cache()
    refs.clear()
    torch.cuda.empty_cache()
    return results


# the JAX plain sharded tests' tolerances (tests/test_parallel_halo.py:
# SWE :58-129, PE :220-245, barotropic :478-533), (rtol, atol) by field
PLAIN_TOL = {"shallow_water": dict.fromkeys(("u", "v", "h"), (1e-5, 1e-5)),
             "primitive": dict.fromkeys(("u", "v", "T", "q", "ps"),
                                        (2e-5, 2e-5)),
             "barotropic": {"zeta": (5e-4, 5e-5)}}


def _plain_reference(p) -> tuple:
    """(s0, state after p.steps, ms per step, stepper name) of the
    whole-domain run of a plain sharded path's configuration with backend
    plain on the card; fails if it launched a kernel."""
    import torch

    sim = p.simulation(backend="plain")
    s0 = sim.state.map(torch.clone)
    reset_counts()
    sim.step(p.steps)
    if any(counts().values()):
        fail("plain_sharded_reference", f"backend plain launched {counts()}")
    ref = sim.state.map(torch.clone)
    ms, _ = _time_steps(lambda: sim.step(p.steps), p.steps)
    return s0, ref, ms, sim.stepper.name


def _scaling_rows() -> dict:
    """njw_tpu_torch.bench.scaling on the card; every row must be ok."""
    import torch
    from njw_tpu_torch.bench.scaling import (
        halo_overlap_efficiency, pe_mesh_shape_sweep, swe_scaling_sweep,
    )

    rows = {"swe_scaling_sweep": swe_scaling_sweep(
        2048, steps_per_call=10, device_counts=[1, 2, 4])}
    rows["halo_overlap_efficiency"] = [
        halo_overlap_efficiency(2048, 4, n_steps=10, overlap=ov)
        for ov in (True, False)]
    reset_counts()
    pe = pe_mesh_shape_sweep(4, ny=512, nx=512, L=20, dt=240.0)
    torch.cuda.synchronize()
    launched = counts()
    # two one-step calls a mesh shape (the first makes the padded blocks)
    want = {k: 0 for k in launched}
    want["pe_rk4"] = 2 * sum(r["mesh"][0] * r["mesh"][1] for r in pe)
    rows["pe_mesh_shape_sweep"] = pe
    for fn, rs in rows.items():
        for r in rs:
            emit(f"scaling_{fn}", **r)
    bad = [(fn, r) for fn, rs in rows.items() for r in rs if not r["ok"]]
    emit("scaling_pe_launches", ok=launched == want and len(pe) == 3,
         launches=launched, expected_launches=want)
    if bad:
        fail("scaling", f"rows not ok: {bad}")
    if launched != want or len(pe) != 3:
        fail("scaling_pe_launches", f"{len(pe)} mesh shapes, launch counts "
             f"{launched}, expected {want}")
    return rows


def _plain_step_costs(stepper, *args, reps: int = 3) -> tuple:
    """(host ms, device ms) of one step of a plain sharded stepper called
    with ``args``. Host: a two-step call less a one-step call, each
    enqueued after a synchronise, the median of ``reps``. Device:
    ``_device_ms`` of a one-step call."""
    import statistics

    import torch

    n = stepper.n_steps
    host = []
    try:
        for _ in range(reps):
            h = {}
            for k in (1, 2):
                stepper.n_steps = k
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stepper(*args)
                h[k] = (time.perf_counter() - t0) * 1e3
            host.append(h[2] - h[1])
        stepper.n_steps = 1
        device_ms = _device_ms(lambda: stepper(*args))
    finally:
        stepper.n_steps = n
    return statistics.median(host), device_ms


def _reflective_walls() -> dict:
    """SWE with winds across reflective walls (the state of
    tests/test_parallel_halo.py:107-129: random, u + 0.5, v - 0.3; the
    main path's vortex is all but still at the walls, so only such a state
    shows the ghost's sign) on (2, 2) with overlap, 10 steps, against the
    whole-domain plain run on the card (1e-5)."""
    import torch
    from njw_tpu_torch.parallel import LocalMesh, sharded_swe_step
    from njw_tpu_torch.weather import SimConfig, Simulation, WeatherState
    from njw_tpu_torch.weather.dynamics import make_tendency_fn

    cfg = SimConfig(grid_width=256, grid_height=256, dt=0.005,
                    coriolis_f=1e-4, boundary_condition="reflective")
    grid, params = cfg.grid_spec(), cfg.physics()
    s = Simulation.from_config(cfg, "random").state
    s0 = WeatherState(u=s.u + 0.5, v=s.v - 0.3, h=s.h)
    whole = Simulation(s0, make_tendency_fn("shallow_water", grid, params),
                       dt=cfg.dt, grid=grid)
    mesh = LocalMesh(2, 2)
    got = mesh.gather_state(sharded_swe_step(grid, params, mesh, dt=cfg.dt,
                                             n_steps=10)(
        mesh.shard_state(s0)))
    whole.step(10)
    diff = _max_abs(got, whole.state)
    ok = _within(got, whole.state, PLAIN_TOL["shallow_water"])
    emit("plain_sharded_reflective_walls", ok=ok, mesh=[2, 2], steps=10,
         grid=[256, 256], max_abs_diff=diff)
    if not ok:
        fail("plain_sharded_reflective_walls", "the sharded run disagrees "
             "with the whole-domain plain run at the walls")
    return {"max_abs_diff": diff}


def plain_sharded_paths() -> dict:
    """Phase 15: every PLAIN_SHARDED_PATHS entry on a LocalMesh on
    cuda:0, SWE overlap against padded, and the scaling harness."""
    import torch
    from njw_tpu_torch.parallel import LocalMesh, sharded_swe_step
    from njw_tpu_torch.weather.main_paths import PLAIN_SHARDED_PATHS

    t0 = time.perf_counter()
    results, refs = {}, {}
    for name, p in PLAIN_SHARDED_PATHS.items():
        cfg = p.sim_config()
        key = (p.model, tuple(sorted(p.overrides.items())), p.steps)
        if key not in refs:
            refs.clear()
            torch.cuda.empty_cache()
            refs[key] = _plain_reference(p)
        s0, ref, whole_ms, whole_name = refs[key]
        mesh = LocalMesh(*p.mesh)
        stepper = p.make_stepper(mesh)
        shards = mesh.shard_state(s0)
        host_ms, device_ms = _plain_step_costs(stepper, shards)  # warms up
        reset_counts()
        mesh.exchanges = mesh.exchange_bytes = 0
        out = []
        ms, call_host_ms = _time_steps(lambda: out.append(stepper(shards)),
                                       p.steps)
        launched = counts()
        exchanges = mesh.exchanges / p.steps
        exchange_bytes = mesh.exchange_bytes / p.steps
        got = mesh.gather_state(out.pop())
        diff = _max_abs(got, ref)
        tol = PLAIN_TOL[cfg.model]
        ok_ref = _within(got, ref, tol)
        del got

        def exchange():
            stepper.exchange(shards)

        _events_ms(exchange, 2)
        exchange_ms = _events_ms(exchange, 10) * stepper.stages
        n = cfg.grid_width * cfg.grid_height
        r = {"stepper": stepper.name, "mesh": list(p.mesh),
             "shards": mesh.size, "steps": p.steps,
             "options": p.options, "overrides": p.overrides,
             "launches": launched,
             "max_abs_diff_vs_whole_domain": diff,
             "equal": "bit-equal" if diff == 0.0 else "within tolerance",
             "whole_domain_path": whole_name,
             "ms_per_step": ms, "grid_points_per_s": n / (ms / 1e3),
             "whole_domain_plain_ms_per_step": whole_ms,
             "host_enqueue_ms_per_step": host_ms,
             "host_ms_per_step_of_call": call_host_ms,
             "device_ms_per_step": device_ms,
             "device_busy_share": device_ms / ms,
             "paced_by": paced_by(ms, call_host_ms, device_ms),
             "exchange_ms_per_step": exchange_ms,
             "exchange_share": exchange_ms / ms,
             "exchanges_per_step": exchanges,
             "exchange_bytes_per_step": exchange_bytes,
             "card": card_state()}
        no_launch = not any(launched.values())
        emit(f"plain_sharded_path_{name}", ok=ok_ref and no_launch, tol=tol,
             **r)
        if not no_launch:
            fail(f"plain_sharded_path_{name}", f"a plain path launched "
                 f"kernels: {launched}")
        if not ok_ref:
            fail(f"plain_sharded_path_{name}", "the sharded run disagrees "
                 "with the whole-domain plain run")
        results[name] = r
        del stepper, shards, out
    refs.clear()
    torch.cuda.empty_cache()

    # the interior/edge form against the padded form: the same arithmetic
    p = PLAIN_SHARDED_PATHS["swe_plain_2x2"]
    cfg = p.sim_config()
    mesh = LocalMesh(*p.mesh)
    s0 = p.initial_state()
    forms = {}
    for overlap in (True, False):
        step = sharded_swe_step(cfg.grid_spec(), cfg.physics(), mesh,
                                dt=cfg.dt, n_steps=10, overlap=overlap)
        forms[overlap] = mesh.gather_state(step(mesh.shard_state(s0)))
    diff = _max_abs(forms[True], forms[False])
    emit("plain_sharded_overlap_vs_padded", ok=diff == 0.0, mesh=[2, 2],
         steps=10, max_abs_diff=diff)
    if diff != 0.0:
        fail("plain_sharded_overlap_vs_padded", "overlap=True differs from "
             f"overlap=False by {diff}")
    del forms, s0
    results["reflective_walls"] = _reflective_walls()
    torch.cuda.empty_cache()
    results["scaling"] = _scaling_rows()
    emit("plain_sharded_summary", ok=True,
         seconds=time.perf_counter() - t0,
         ms_per_step={n: results[n]["ms_per_step"]
                      for n in PLAIN_SHARDED_PATHS})
    return results


BF16_VS_PLAIN = 1e-3    # of max|h| per step: 1/20 of the JAX band below
# RMS of (bf16 kernel - plain) over RMS of (float32 kernel - plain). On an
# H100 a sound kernel reads <= 1.5e-4 over the smoke's cases; one
# product-difference contracted into fma.bf16, or done in float32 and
# rounded once, reads 1.6e-3 to 2.0e-3 at 2048^2 (PERF.md)
BF16_RMS_SHARE = 3e-4
JAX_BF16_BAND = 2e-2    # of max|h|: tests/test_ops_stencil.py:93
SI_VS_CPU = 1e-4        # normalised: the SI runs on the card against the CPU


def _variant(name: str):
    """A path of njw_tpu_torch.weather.main_paths.VARIANT_PATHS."""
    from njw_tpu_torch.weather.main_paths import VARIANT_PATHS

    return VARIANT_PATHS[name]


def _swe_case(ny, nx, ic, ic_kw):
    """(u, v, h) of a named initial condition on the card."""
    from njw_tpu_torch.weather import GridSpec, make_initial_state

    s = make_initial_state(ic, GridSpec(nx=nx, ny=ny), device="cuda", **ic_kw)
    return s.u, s.v, s.h


def _ping_pong(launch, fields):
    """A call that runs ``launch(src, dst)`` between two buffer sets in
    turn, as the steppers do."""
    import torch

    bufs = [fields, tuple(torch.empty_like(t) for t in fields)]
    turn = [0]

    def call():
        launch(bufs[turn[0]], bufs[1 - turn[0]])
        turn[0] ^= 1

    return call


def _swe_bf16_vs_plain(kern, plain, f32) -> tuple[dict, bool]:
    """The bf16 kernel's outputs against its plain version's: the largest
    distance over max|h| (at most BF16_VS_PLAIN), and the RMS distance over
    the float32 kernel's from the same plain version (at most
    BF16_RMS_SHARE; each the largest over u, v, h); the output must differ
    from the float32 kernel's."""
    import torch

    def rms(a, b):
        return max(float((x.double() - y.double()).pow(2).mean().sqrt())
                   for x, y in zip(a, b))

    scale = float(plain[2].abs().max())
    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    control = rms(f32, plain)
    share = rms(kern, plain) / control if control else float("inf")
    vs_f32 = float((kern[2] - f32[2]).abs().max())
    ok = all(bool(torch.isfinite(t).all()) for t in kern) and \
        err <= BF16_VS_PLAIN * scale and share <= BF16_RMS_SHARE and \
        vs_f32 > 0
    return {"max_abs_err": err, "max_abs_err_rel_to_max_h": err / scale,
            "tol_rel_to_max_h": BF16_VS_PLAIN,
            "rms_err_share_of_f32_kernel": share,
            "tol_rms_share": BF16_RMS_SHARE,
            "max_abs_diff_from_f32_kernel": vs_f32}, ok


def variant_kernels() -> dict:
    """Phase 12: the bf16 kernel (K1-bf16) and the multistep kernel (K2)
    against their plain versions, and K2 with N = 2 against two K1
    launches, at the main path's 2048^2, a ragged 1000 x 1500 and 5 x 7;
    then each one's time at 2048^2 beside K1's in this call."""
    import torch
    from njw_tpu_torch.ops import stencil
    from njw_tpu_torch.weather import GridSpec

    swe = path("swe")
    n, dt, f = swe.config["grid_width"], swe.config["dt"], \
        swe.config["coriolis_f"]
    cases = [  # name, ny, nx, ic, ic kwargs, dt
        ("main_2048", n, n, swe.ic, swe.ic_params, dt),
        ("ragged_1000x1500", 1000, 1500, "breaking_wave", {"amplitude": 0.3},
         0.005),
        ("tiny_5x7", 5, 7, "random", {"amplitude": 0.1, "seed": 2}, 0.001),
    ]
    res = {"bf16": {}, "multi": {}}
    for name, ny, nx, ic, ic_kw, step_dt in cases:
        fields = _swe_case(ny, nx, ic, ic_kw)
        grid = GridSpec(nx=nx, ny=ny)
        for nu in (0.0, 0.02):
            kw = dict(grid=grid, dt=step_dt, coriolis_f=f, viscosity=nu)
            kern = stencil.swe_rk4_step_cuda(*fields, variant="bf16", **kw)
            plain = stencil.swe_rk4_step_plain(*fields, variant="bf16", **kw)
            f32 = stencil.swe_rk4_step_cuda(*fields, **kw)
            torch.cuda.synchronize()
            check, ok = _swe_bf16_vs_plain(kern, plain, f32)
            emit("kernel_vs_plain", ok=ok, kernel="swe_rk4_bf16", case=name,
                 shape=[ny, nx], viscosity=nu, **check)
            if not ok:
                fail("kernel_vs_plain", f"swe_rk4_bf16 disagrees with its "
                     f"plain version, or equals float32, on {name}")
            res["bf16"][f"{name}_nu{nu}"] = check["max_abs_err"]
        kw = dict(grid=grid, dt=step_dt, coriolis_f=f)
        two = stencil.swe_rk4_multistep_cuda(*fields, n_fused=2, **kw)
        one = stencil.swe_rk4_multistep_cuda(*fields, n_fused=1, **kw)
        k1 = stencil.swe_rk4_step_cuda(*fields, **kw)
        k1k1 = stencil.swe_rk4_step_cuda(*k1, **kw)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(two, k1k1)) and \
            all(torch.equal(a, b) for a, b in zip(one, k1))
        errs, ok = {}, exact
        for nf, got in ((1, one), (2, two)):
            plain = stencil.swe_rk4_multistep_plain(*fields, n_fused=nf, **kw)
            max_abs, _, agree = _compare(got, plain, nf * RTOL, nf * ATOL)
            errs[nf] = max_abs
            ok &= agree
        emit("kernel_vs_plain", ok=ok, kernel="swe_rk4_multi", case=name,
             shape=[ny, nx], equals_k1_launches=exact,
             max_abs_err_n1=errs[1], max_abs_err_n2=errs[2],
             rtol_per_step=RTOL, atol_per_step=ATOL,
             max_abs_diff_n2_vs_two_k1=max(
                 float((a - b).abs().max()) for a, b in zip(two, k1k1)))
        if not ok:
            fail("kernel_vs_plain", f"swe_rk4_multi disagrees with two K1 "
                 f"launches or its plain version on {name}")
        res["multi"][name] = errs[2]
        del fields, kern, plain, f32, two, one, k1, k1k1

    # times at the main path's shape, each kernel ping-ponging two buffer
    # sets as its stepper does; K1 beside them in this call
    fields = _swe_case(n, n, swe.ic, swe.ic_params)
    grid = GridSpec(nx=n, ny=n)
    kw = dict(grid=grid, dt=dt, coriolis_f=f)
    forms = {
        "swe_rk4": lambda src, dst: stencil.swe_rk4_step_cuda(
            *src, out=dst, **kw),
        "swe_rk4_bf16": lambda src, dst: stencil.swe_rk4_step_cuda(
            *src, out=dst, variant="bf16", **kw),
        "swe_rk4_multi": lambda src, dst: stencil.swe_rk4_multistep_cuda(
            *src, out=dst, n_fused=2, **kw),
    }
    plains = {
        "swe_rk4": lambda: stencil.swe_rk4_step_plain(*fields, **kw),
        "swe_rk4_bf16": lambda: stencil.swe_rk4_step_plain(
            *fields, variant="bf16", **kw),
        "swe_rk4_multi": lambda: stencil.swe_rk4_multistep_plain(
            *fields, n_fused=2, **kw),
    }
    times = {}
    for kernel, launch in forms.items():
        call = _ping_pong(launch, tuple(t.clone() for t in fields))
        _events_ms(call, 20)
        ms = _events_ms(call, 200)
        _events_ms(plains[kernel], 2)
        plain_ms = _events_ms(plains[kernel], 10)
        steps = 2 if kernel == "swe_rk4_multi" else 1
        b_ms, b_by = roofline_ms(BYTES_PER_POINT * n * n,
                                 steps * FLOP_PER_POINT * n * n)
        host_us = host_us_per_launch(call)
        layout = swe_layout_info(n_steps=steps,
                                 bf16=kernel == "swe_rk4_bf16")
        times[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "host_us": host_us,
                         "ms_per_step": ms / steps,
                         "bound_ms_per_step": b_ms / steps, "layout": layout}
        emit("kernel_time", ok=True, kernel=kernel, shape=[n, n],
             steps_per_launch=steps, ms=ms, ms_per_step=ms / steps,
             plain_ms=plain_ms, bound_ms=b_ms, bound_ms_per_step=b_ms / steps,
             bound_by=b_by, fraction_of_bound=b_ms / ms, library_ms=None,
             host_us_per_launch=host_us, card=card_state(), **layout)
    return {
        "bf16": {"max_abs_err": res["bf16"]["main_2048_nu0.0"],
                 "max_abs_err_all_cases": max(res["bf16"].values()),
                 **times["swe_rk4_bf16"]},
        "multi": {"max_abs_err": res["multi"]["main_2048"],
                  "max_abs_err_all_cases": max(res["multi"].values()),
                  **times["swe_rk4_multi"]},
        "k1_same_call": times["swe_rk4"]}


def variant_paths(m1: dict) -> dict:
    """Phase 13: swe_bf16 and swe_multistep (VARIANT_PATHS) at full width,
    each launch count set to 0 just before the timed run and read just
    after; the multistep run held to the float32 run of the same steps bit
    for bit, the bf16 run to the JAX band of it."""
    import torch

    out = {}
    for name, stepper in (("swe_bf16", "rk4_kernel_bf16"),
                          ("swe_multistep", "rk4_kernel_x2")):
        p = _variant(name)
        sim = p.simulation()
        if sim.stepper.name != stepper:
            fail(f"variant_path_{name}", f"stepper {sim.stepper.name}")
        r = _drive(sim, p.main.warm, p.main.steps)
        want = {p.kernel: p.main.steps * p.launches_per_step}
        steps = sim.step_count * p.steps_per_call
        ref = path("swe").simulation(backend="kernel")   # K1, float32
        ref.step(steps)
        scale = float(ref.state.h.abs().max())
        diff = _max_abs(sim.state, ref.state)
        if name == "swe_multistep":
            agrees = all(torch.equal(a, b) for (_, a), (_, b) in
                         zip(sim.state.items(), ref.state.items()))
            check = {"equals_f32_run": agrees}
        else:
            agrees = 0 < diff <= JAX_BF16_BAND * scale
            check = {"max_abs_diff_rel_to_max_h": diff / scale,
                     "band_rel_to_max_h": JAX_BF16_BAND}
        r["ms_per_call"] = r["ms_per_step"]
        ms_rk4_step = r["ms_per_step"] / p.steps_per_call
        emit(f"variant_path_{name}", ok=r["finite"] and agrees,
             grid=[p.main.config["grid_height"], p.main.config["grid_width"]],
             stepper=stepper, calls=p.main.steps,
             rk4_steps=p.main.steps * p.steps_per_call,
             ms_per_rk4_step=ms_rk4_step,
             f32_main_path_ms_per_step=m1["ms_per_step"],
             vs_f32_main_path=ms_rk4_step / m1["ms_per_step"],
             steps_compared=steps, max_abs_diff_vs_f32_run=diff, **check, **r)
        _check_main(f"variant_path_{name}", r, want)
        if not agrees:
            fail(f"variant_path_{name}", "the run disagrees with the float32 "
                 "run of the same steps")
        out[name] = r
        del sim, ref
        torch.cuda.empty_cache()
    return out


# fields that share one scale: the winds, and the spectral winds' zeta and
# div (a balanced state's div is orders below its zeta and carries the
# winds' rounding)
SCALE_GROUPS = (("u", "v"), ("zeta", "div"), ("coarse_u", "coarse_v"),
                ("fine_u", "fine_v"))


def _normalised_groups(a_state, b_state) -> dict:
    """max |a - b| per field over the scale of b's group (SCALE_GROUPS;
    every other field has its own)."""
    bs = dict(b_state.items())

    def scale(name):
        group = next((g for g in SCALE_GROUPS if name in g), (name,))
        return max(float(bs[g].abs().max()) for g in group if g in bs) \
            + 1e-30

    return {name: float((a.cpu() - bs[name].cpu()).abs().max()) / scale(name)
            for name, a in a_state.items()}


def semi_implicit() -> dict:
    """Phase 14: swe_si and pe_si (VARIANT_PATHS) at full width with their
    RK4 partners; the SI runs on the card against the port on the CPU; PE
    SI against the RK4 kernel path at a small dt."""
    import torch
    from njw_tpu_torch.weather import SimConfig, Simulation

    res = {}
    partners = {"swe_si": 0.05, "pe_si": 240.0}
    for name, rk4_dt in partners.items():
        p = _variant(name)
        sim = p.simulation()
        if sim.stepper.name != "semi_implicit":
            fail(f"semi_implicit_{name}", f"stepper {sim.stepper.name}")
        r = _drive(sim, p.main.warm, p.main.steps)
        _check_main(f"semi_implicit_{name}", r, {})
        del sim
        torch.cuda.empty_cache()
        rk = p.main.simulation(integration_method="rk4", dt=rk4_dt)
        rr = _drive(rk, p.main.warm, p.main.steps)
        si_dt = p.main.config["dt"]
        emit(f"semi_implicit_{name}", ok=True, config=p.main.config,
             ic=p.main.ic, ic_params=p.main.ic_params, steps=p.main.steps,
             sim_seconds_per_wall_second=si_dt / r["ms_per_step"] * 1e3,
             rk4_partner={"dt": rk4_dt, "stepper": rk.stepper.name,
                          "ms_per_step": rr["ms_per_step"],
                          "host_enqueue_ms_per_step":
                              rr["host_enqueue_ms_per_step"],
                          "paced_by": rr["paced_by"],
                          "launches": rr["launches"],
                          "finite": rr["finite"],
                          "sim_seconds_per_wall_second":
                              rk4_dt / rr["ms_per_step"] * 1e3},
             card=card_state(), **r)
        res[name] = {"si": r, "rk4": rr, "si_dt": si_dt, "rk4_dt": rk4_dt}
        del rk
        torch.cuda.empty_cache()

    # the card against the port on the CPU (cuFFT and cuBLAS against
    # pocketfft and the CPU's matmul)
    for name, size, steps in (("swe_si", {}, 20),
                              ("pe_si", {"grid_width": 128,
                                         "grid_height": 128}, 20)):
        main = _variant(name).main
        card = main.simulation(**size)
        host = main.simulation(device="cpu", **size)
        card.step(steps)
        host.step(steps)
        diffs = _normalised_groups(card.state, host.state)
        ok = all(bool(torch.isfinite(t).all()) for _, t in card.state.items())
        ok &= max(diffs.values()) <= SI_VS_CPU
        emit("semi_implicit_vs_cpu", ok=ok, path=name,
             shape=[main.config.get("num_levels", 1),
                    size.get("grid_height", main.config["grid_height"]),
                    size.get("grid_width", main.config["grid_width"])],
             steps=steps, normalised_max_diff=diffs, tol=SI_VS_CPU)
        if not ok:
            fail("semi_implicit_vs_cpu", f"{name} on the card disagrees "
                 "with the port on the CPU")
        res[f"{name}_vs_cpu"] = diffs

    # small dt: the SI and RK4 kernel paths integrate the same equations
    # (tests/test_weather_primitive.py:470-484)
    pe = dict(model="primitive", grid_width=48, grid_height=32, num_levels=5,
              dx=1e5, dy=1e5, dt=5.0, coriolis_f=1e-4, device="cuda")
    si = Simulation.from_config(SimConfig(integration_method="semi_implicit",
                                          **pe), "baroclinic", u_jet=8.0,
                                perturb=0.5)
    # the K4 path whatever the auto choice at these levels
    rk = _pe_simulation(True, {"u_jet": 8.0, "perturb": 0.5},
                        grid_width=48, grid_height=32, num_levels=5,
                        dx=1e5, dy=1e5, dt=5.0, coriolis_f=1e-4)
    reset_counts()
    si.step(40)
    si_launches = counts()
    rk.step(40)
    rk_launches = counts()
    ok_ps = bool(torch.allclose(si.state.ps, rk.state.ps, rtol=2e-4, atol=0))
    ok_u = bool(torch.allclose(si.state.u, rk.state.u, rtol=0, atol=2e-2))
    ok = ok_ps and ok_u and not any(si_launches.values()) and \
        rk_launches["pe_rk4"] == 40 and rk.stepper.name == \
        "pe_rk4_kernel_fused"
    emit("semi_implicit_vs_rk4_kernel", ok=ok, shape=[5, 32, 48], dt=5.0,
         steps=40, rk4_stepper=rk.stepper.name,
         ps_max_rel_diff=float(((si.state.ps - rk.state.ps).abs()
                                / rk.state.ps.abs()).max()),
         u_max_abs_diff=float((si.state.u - rk.state.u).abs().max()),
         tol={"ps_rtol": 2e-4, "u_atol": 2e-2}, si_launches=si_launches,
         rk4_launches=rk_launches)
    if not ok:
        fail("semi_implicit_vs_rk4_kernel", "PE semi-implicit and the RK4 "
             "kernel path disagree at small dt")
    return res


# ------------------------------------------------------------ phase 16

GLOBAL_CPU_TOL = 1e-4       # the card against the port on the CPU, 20 steps
FOLD_TRANSFORM_ATOL = 1e-5  # tests/test_weather_spherical.py:114-129
FOLD_STATE_ATOL = 1e-4      # :131-147
SPHERE_SHARD_ATOL = 1e-4    # tests/test_parallel_sphere.py:42
ICOSA_SHARD_ATOL = {"h": 1e-3, "V": 1e-5}  # tests/test_parallel_icosa.py:94
RH_ROTATION_TOL = 1e-4      # tests/test_weather_spherical.py:176
TC2_SPECTRAL = (1e-5, 1e-8)  # :208-209 (phi drift, max |div|)
TC2_ICOSA = 2e-3            # tests/test_weather_icosa.py:165
MASS_TOL = 1e-3             # tests/test_weather_staggered.py:57
CGRID_REF_TOL = 1e-4        # vs float64 NumPy: float32 rounding of g h + K
#                             differenced over a cell reads 2e-5 of max|du|
# ops that may take a table without copying it: the products and views
TABLE_VIEW_OPS = {"aten::bmm", "aten::select", "aten::slice",
                  "aten::as_strided", "aten::view", "aten::expand",
                  "aten::transpose", "aten::permute", "aten::resolve_conj",
                  "aten::resolve_neg", "aten::alias", "aten::unsqueeze",
                  "aten::squeeze", "aten::narrow", "aten::detach"}
# the Legendre tables each spectral tendency reads (weather/spherical.py)
CORE_TABLES = {"swe": ("P", "H", "Pw_over_c2", "Hw_over_c2", "Pw"),
               "bve": ("P", "H", "Pw_over_c2", "Hw_over_c2")}


def _global(name: str):
    from njw_tpu_torch.weather.main_paths import GLOBAL_PATHS

    return GLOBAL_PATHS[name]


def _spectral_core(cfg) -> str:
    return "bve" if cfg.model == "barotropic" else "swe"


def _table_bound(sim, cfg) -> dict:
    """The Legendre table bytes one step reads (each tendency reads its
    tables once, ``stages`` tendencies a step) and their time at the
    card's memory rate: the step's bytes bound."""
    core = _spectral_core(cfg)
    per_tendency = sum(sim.sht.table_bytes(t) for t in CORE_TABLES[core])
    n_bytes = sim.stepper.stages * per_tendency
    ms, by = roofline_ms(n_bytes, 0.0)
    return {"table_bytes_per_step": n_bytes, "tables_per_tendency":
            list(CORE_TABLES[core]), "folded": sim.sht.fold_parity,
            "table_bound_ms": ms}


def _table_copies(sim) -> dict:
    """One step of a spectral path under torch.profiler (CPU and CUDA,
    input shapes recorded): the ops other than the products and views
    (TABLE_VIEW_OPS) that took a tensor of a Legendre table's shape (a
    table-sized copy or upcast: there must be none), and, to read beside
    it, the memory one step allocates beyond what it started with (at
    T341 the step's own grids and stacks come to about one folded
    table half)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sht = sim.sht
    tables = ([t for pair in sht.folded.values() for t in pair]
              if sht.folded is not None else list(sht.tables.values()))
    shapes = {list(t.shape).__repr__() for t in tables}
    smallest = min(t.numel() * t.element_size() for t in tables)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        sim.step(1)
    step_bytes = torch.cuda.max_memory_allocated() - before
    copies = sorted({e.key for e in prof.key_averages(
        group_by_input_shape=True)
        if e.key not in TABLE_VIEW_OPS and any(repr(list(s)) in shapes
                                        for s in e.input_shapes if s)})
    return {"ops_copying_a_table": copies,
            "step_alloc_bytes": step_bytes,
            "smallest_table_bytes": smallest, "ok": not copies}


def _cgrid_numpy(u, v, h, g, f, dx, dy):
    """The Sadourny C-grid tendencies in float64 NumPy, written from the
    formulas (weather/staggered.py's docstring), not from the port."""
    import numpy as np

    def at(a, di=0, dj=0):   # a[j + dj, i + di], periodic
        return np.roll(np.roll(a, -dj, 0), -di, 1)

    U = 0.5 * (h + at(h, 1)) * u
    V = 0.5 * (h + at(h, 0, 1)) * v
    zeta = (at(v, 1) - v) / dx - (at(u, 0, 1) - u) / dy
    hq = 0.25 * (h + at(h, 1) + at(h, 0, 1) + at(h, 1, 1))
    q = (zeta + f) / hq
    K = 0.25 * (u * u + at(u * u, -1) + v * v + at(v * v, 0, -1))
    phi = g * h + K
    V_u = 0.25 * (V + at(V, 0, -1) + at(V, 1) + at(V, 1, -1))
    U_v = 0.25 * (U + at(U, -1) + at(U, 0, 1) + at(U, -1, 1))
    du = 0.5 * (q + at(q, 0, -1)) * V_u - (at(phi, 1) - phi) / dx
    dv = -0.5 * (q + at(q, -1)) * U_v - (at(phi, 0, 1) - phi) / dy
    dh = -((U - at(U, -1)) / dx + (V - at(V, 0, -1)) / dy)
    return du, dv, dh


def _small_cases() -> dict:
    """The card-vs-CPU configurations (20 steps each): for each, a function
    of the device that makes its Simulation."""
    from njw_tpu_torch.weather import SimConfig, Simulation
    from njw_tpu_torch.weather.nested import make_nested_sim

    def staggered(dev):
        return Simulation.from_config(SimConfig(
            grid_width=256, grid_height=256, grid_type="staggered",
            coriolis_f=1e-4, dt=0.01, device=dev), "vortex", strength=1.0)

    def nested(dev):
        return make_nested_sim(Simulation, SimConfig(
            grid_width=128, grid_height=128, coriolis_f=1e-4, dt=0.02,
            device=dev), "vortex", patch=(32, 96, 32, 96), ratio=2,
            strength=1.0)

    def spectral(fold):
        def build(dev):
            return Simulation.from_config(SimConfig(
                grid_type="spherical_harmonic", grid_width=128,
                grid_height=64, dt=900.0, device=dev), "rossby_haurwitz",
                nu4=1e15, fold_parity=fold)
        return build

    def icosa(dev):
        return Simulation.from_config(SimConfig(
            grid_type="icosahedral", grid_width=32, grid_height=32,
            dt=450.0, device=dev), "gaussian", amplitude=50.0)

    return {"staggered_256": staggered, "nested_128": nested,
            "sph_swe_nlat64_fold": spectral(True),
            "sph_swe_nlat64_unfolded": spectral(False), "icosa_32": icosa}


def _global_cpu_vs_card() -> dict:
    """Each core at a small size, 20 steps on the card and on the CPU,
    normalised by field group: within GLOBAL_CPU_TOL."""
    import numpy as np

    out = {}
    for name, build in _small_cases().items():
        card, cpu = build("cuda"), build("cpu")
        card.step(20)
        cpu.step(20)
        diffs = _normalised_groups(card.state, cpu.state)
        worst = max(diffs.values())
        ok = bool(np.isfinite(worst)) and worst <= GLOBAL_CPU_TOL
        emit("global_cpu_vs_card", ok=ok, case=name, steps=20,
             stepper=card.stepper.name, normalised_max_diff=diffs,
             tol=GLOBAL_CPU_TOL)
        if not ok:
            fail("global_cpu_vs_card", f"{name}: the card and the CPU "
                 "disagree")
        out[name] = worst
    return out


def _cgrid_reference() -> dict:
    """The card's C-grid tendencies at 256^2 against the float64 NumPy
    evaluation of the same formulas (normalised by field group)."""
    import numpy as np
    from njw_tpu_torch.weather.dynamics import make_tendency_fn

    sim = _small_cases()["staggered_256"]("cuda")
    cfg = sim.config
    s = sim.state
    t = make_tendency_fn("shallow_water", cfg.grid_spec(), cfg.physics())(s)
    ref = _cgrid_numpy(*(a.double().cpu().numpy() for a in (s.u, s.v, s.h)),
                       cfg.gravity, cfg.coriolis_f, cfg.dx, cfg.dy)
    wind = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    diffs = {n: float(np.abs(getattr(t, n).double().cpu().numpy() - r).max()
                      / (wind if n != "h" else np.abs(r).max()))
             for n, r in zip(("u", "v", "h"), ref)}
    ok = max(diffs.values()) <= CGRID_REF_TOL
    emit("global_cgrid_vs_numpy", ok=ok, grid=[256, 256],
         normalised_max_diff=diffs, tol=CGRID_REF_TOL)
    if not ok:
        fail("global_cgrid_vs_numpy", "the C-grid tendency disagrees with "
             "its float64 NumPy evaluation")
    return diffs


def _check_global(phase: str, r: dict) -> None:
    if not r["finite"]:
        fail(phase, "non-finite fields")
    if any(r["launches"].values()):
        fail(phase, f"a global path launched kernels: {r['launches']}")


def _global_path(name: str) -> dict:
    """One whole-domain GLOBAL_PATHS entry through Simulation, timed by
    _drive, with its invariant where the JAX tests hold one."""
    import numpy as np
    import torch

    p = _global(name)
    cfg = p.sim_config()
    phase = f"global_path_{name}"
    torch.cuda.empty_cache()
    sim = p.simulation()
    s0 = sim.state
    check = {}
    if name == "staggered_2048":
        from njw_tpu_torch.weather.dynamics import make_tendency_fn

        dh = make_tendency_fn("shallow_water", cfg.grid_spec(),
                              cfg.physics())(s0).h.double()
        ratio = float(dh.sum().abs() / dh.abs().sum())
        check = {"mass_tendency_sum_over_abs_sum": ratio,
                 "tol": MASS_TOL, "ok": ratio < MASS_TOL}
    r = _drive(sim, p.warm, p.steps)
    _check_global(phase, r)
    if name == "sph_bve_T341":
        m, n = 4, 5        # rossby_haurwitz_bve's mode
        om_r = 2.0 * sim.omega / (n * (n + 1))
        exact = s0.zeta * np.exp(1j * m * om_r * sim.time)
        got, want = sim.sht.synthesis(sim.state.zeta), \
            sim.sht.synthesis(exact)
        rel = float((got - want).abs().max() / want.abs().max())
        check = {"rotation_rel_err": rel, "model_seconds": sim.time,
                 "phase_rad": m * om_r * sim.time, "tol": RH_ROTATION_TOL,
                 "ok": rel < RH_ROTATION_TOL}
    elif name == "icosa_256":
        h0, h1 = s0.h.double(), sim.state.h.double()
        rel = float(torch.sqrt(((h1 - h0) ** 2).mean() / (h0 ** 2).mean()))
        V = sim.state.V
        vr = float((V * sim.icosa_ops.r).sum(-1).abs().max()
                   / V.abs().max())
        check = {"tc2_h_rel_drift": rel, "model_seconds": sim.time,
                 "tol": TC2_ICOSA, "radial_over_max_V": vr,
                 "ok": rel < TC2_ICOSA and vr < 1e-3}
    elif name == "sph_swe_T341":
        check = _tc2_spectral(sim)
    extra = {}
    if cfg.grid_type == "spherical_harmonic":
        extra = _table_bound(sim, cfg)
        extra["fraction_of_table_bound"] = (extra["table_bound_ms"]
                                            / r["ms_per_step"])
        extra["table_copies"] = _table_copies(sim)
        if not extra["table_copies"]["ok"]:
            fail(phase, f"a step copies a table: {extra['table_copies']}")
    ok = check.get("ok", True)
    emit(phase, ok=ok, config=p.config, ic=p.ic, ic_params=p.ic_params,
         steps=p.steps, warm_steps=p.warm, stepper=sim.stepper.name,
         grid_points=p.points,
         grid_points_per_s=p.points / (r["ms_per_step"] / 1e3),
         invariant=check, **extra, **r)
    if not ok:
        fail(phase, f"the invariant does not hold: {check}")
    return {**r, **extra, "invariant": check}


def _tc2_spectral(sim) -> dict:
    """Williamson TC2 on the path's (folded) T341 transform, RK4 with no
    hyperdiffusion, 96 steps of the path's dt: the JAX test's band."""
    from njw_tpu_torch.weather import make_stepper
    from njw_tpu_torch.weather.spherical import (
        swe_tendencies, williamson2_state)

    sht, omega = sim.sht, sim.omega
    s = williamson2_state(sht, omega)
    p0 = sht.synthesis(s.phi)
    step = make_stepper("rk4", lambda x: swe_tendencies(x, sht, omega)).step
    for _ in range(96):
        _, s = step((), s, sim._dt_f32)
    p1 = sht.synthesis(s.phi)
    rel = float((p1 - p0).norm() / p0.norm())
    div = float(sht.synthesis(s.div).abs().max())
    return {"tc2_phi_rel_drift": rel, "tc2_max_div": div, "steps": 96,
            "tol": list(TC2_SPECTRAL),
            "ok": rel < TC2_SPECTRAL[0] and div < TC2_SPECTRAL[1]}


def _global_si() -> dict:
    """sph_si_T170: semi-implicit order 2 at dt 480 beside its RK4 partner
    at dt 240, 80 steps each."""
    p = _global("sph_si_T170")
    out = {}
    for kind, over in (("si", {}), ("rk4", p.partner)):
        sim = p.simulation(**over)
        r = _drive(sim, p.warm, p.steps)
        _check_global(f"global_path_sph_si_T170_{kind}", r)
        dt = p.sim_config(**over).dt
        r.update(_table_bound(sim, p.sim_config(**over)), dt=dt,
                 stepper=sim.stepper.name,
                 grid_points_per_s=p.points / (r["ms_per_step"] / 1e3),
                 sim_seconds_per_wall_second=dt / r["ms_per_step"] * 1e3)
        out[kind] = r
        del sim
    emit("global_path_sph_si_T170", ok=True, steps=p.steps, **out)
    return out


def _sharded_global(name: str, whole, same_arithmetic) -> dict:
    """A sharded GLOBAL_PATHS entry on its LocalMesh: the stepper's call
    of ``steps`` steps timed by CUDA events, its host time, the device's
    work over one step (torch.profiler), the mesh's exchanges a step; and
    the result against the whole-domain run of the same RK4 arithmetic
    (``same_arithmetic(steps)``)."""
    import torch
    from njw_tpu_torch.parallel import LocalMesh

    p = _global(name)
    mesh = LocalMesh(*p.mesh)
    stepper, states = p.sharded(whole, mesh)
    dt = whole.dt
    host_ms, device_ms = _plain_step_costs(stepper, states, dt)  # warms up
    reset_counts()
    mesh.exchanges = mesh.exchange_bytes = 0
    torch.cuda.reset_peak_memory_stats()
    out = []
    ms, call_host_ms = _time_steps(lambda: out.append(stepper(states, dt)),
                                   p.steps)
    launched = counts()
    exchanges = mesh.exchanges / p.steps
    exchange_bytes = mesh.exchange_bytes / p.steps
    return {"stepper": stepper, "mesh": mesh, "out": out.pop(),
            "ref": same_arithmetic(p.steps), "launches": launched,
            "ms_per_step": ms,
            "grid_points_per_s": p.points / (ms / 1e3),
            "host_enqueue_ms_per_step": host_ms,
            "host_ms_per_step_of_call": call_host_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / ms,
            "paced_by": paced_by(ms, call_host_ms, device_ms),
            "exchanges_per_step": exchanges,
            "exchange_bytes_per_step": exchange_bytes,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "card": card_state()}


def _sphere_sharded_and_fold() -> dict:
    """sph_swe_T341_4x1 against the unfolded whole-domain run, and the
    folded T341 transform against the unfolded one: the stacked
    contractions on the path's state (FOLD_TRANSFORM_ATOL) and 50 RK4
    steps (FOLD_STATE_ATOL), in this call."""
    import torch
    from njw_tpu_torch.weather.integrators import rk4_lists
    from njw_tpu_torch.weather.spherical import swe_tendencies

    name = "sph_swe_T341_4x1"
    p = _global(name)
    torch.cuda.empty_cache()
    whole = p.simulation()                      # the unfolded transform
    s0, sht, omega = whole.state, whole.sht, whole.omega
    nu4 = p.ic_params["nu4"]

    def same_arithmetic(steps):
        return rk4_lists(lambda ss: [swe_tendencies(ss[0], sht, omega,
                                                    nu4)],
                         [s0], whole.dt, steps)[0]

    r = _sharded_global(name, whole, same_arithmetic)
    diffs = _normalised_groups(r.pop("out")[0], r.pop("ref"))
    stepper, mesh = r.pop("stepper"), r.pop("mesh")
    ok = max(diffs.values()) <= SPHERE_SHARD_ATOL and not any(
        r["launches"].values())
    r.update(_table_bound(whole, p.sim_config()))
    emit(f"global_path_{name}", ok=ok, mesh=list(p.mesh), steps=p.steps,
         stepper=stepper.name, normalised_max_diff_vs_whole=diffs,
         tol=SPHERE_SHARD_ATOL, **r)
    if not ok:
        fail(f"global_path_{name}", "the sharded run disagrees with the "
             "whole-domain run")
    del stepper, mesh

    # the fold: the folded path's transform against the unfolded one
    folded = _global("sph_swe_T341").simulation()
    a = torch.stack([s0.zeta, s0.div, s0.phi])
    transforms = {}
    for which in ("P", "H", "Pw", "Pw_over_c2", "Hw_over_c2"):
        f0 = sht.syn_stack(a, which)
        f1 = folded.sht.syn_stack(a, which)
        b0 = sht.anal_stack(f0, which)
        b1 = folded.sht.anal_stack(f0, which)
        transforms[which] = max(
            float((f1 - f0).abs().max() / f0.abs().max()),
            float((b1 - b0).abs().max() / b0.abs().max()))
    steps = _global("sph_swe_T341").steps
    whole.step(steps)       # from s0: no step has run on ``whole`` yet
    folded.step(steps)
    state = _normalised_groups(folded.state, whole.state)
    ok = (max(transforms.values()) <= FOLD_TRANSFORM_ATOL
          and max(state.values()) <= FOLD_STATE_ATOL)
    emit("global_fold_vs_unfolded", ok=ok, nlat=sht.nlat, steps=steps,
         transforms_normalised_max_diff=transforms,
         state_normalised_max_diff=state,
         tol=[FOLD_TRANSFORM_ATOL, FOLD_STATE_ATOL])
    if not ok:
        fail("global_fold_vs_unfolded", "the folded transform disagrees "
             "with the unfolded one")
    r["fold"] = {"transforms": transforms, "state": state}
    return r


def _icosa_sharded() -> dict:
    """icosa_256_5x1 against the whole-domain run of the same RK4
    arithmetic (the JAX test's absolute tolerances)."""
    import torch
    from njw_tpu_torch.parallel.icosa import unshard_state
    from njw_tpu_torch.weather.icosa import swe_tendencies_icosa
    from njw_tpu_torch.weather.integrators import rk4_lists

    name = "icosa_256_5x1"
    p = _global(name)
    torch.cuda.empty_cache()
    whole = p.simulation()
    cfg = p.sim_config()
    ops, s0 = whole.icosa_ops, whole.state

    def same_arithmetic(steps):
        return rk4_lists(lambda ss: [swe_tendencies_icosa(
            ss[0], ops, g=cfg.gravity, omega=7.292e-5, nu=cfg.viscosity)],
            [s0], whole.dt, steps)[0]

    r = _sharded_global(name, whole, same_arithmetic)
    mesh = r.pop("mesh")
    got, ref = unshard_state(r.pop("out"), mesh), r.pop("ref")
    diffs = {n: float((getattr(got, n) - getattr(ref, n)).abs().max())
             for n in ("V", "h")}
    stepper = r.pop("stepper")
    ok = all(diffs[n] <= ICOSA_SHARD_ATOL[n] for n in diffs) and not any(
        r["launches"].values())
    emit(f"global_path_{name}", ok=ok, mesh=list(p.mesh), steps=p.steps,
         stepper=stepper.name, max_abs_diff_vs_whole=diffs,
         equal="bit-equal" if not any(diffs.values()) else
         "within tolerance", tol=ICOSA_SHARD_ATOL, **r)
    if not ok:
        fail(f"global_path_{name}", "the sharded run disagrees with the "
             "whole-domain run")
    return r


def _global_cli() -> None:
    """The CLI's --json on each new grid type at a small size, and one
    --output-format netcdf run read back with the port's read_netcdf."""
    import os
    import tempfile

    import numpy as np
    from njw_tpu_torch.utils.netcdf3 import read_netcdf
    from njw_tpu_torch.weather.__main__ import main as cli_main

    runs = {
        "staggered": ["--grid-type", "staggered", "--width", "128",
                      "--height", "128", "--coriolis", "1e-4", "--steps",
                      "20", "--json"],
        "spherical_harmonic": ["--grid-type", "spherical_harmonic",
                               "--width", "128", "--height", "64", "--dt",
                               "900", "--steps", "20", "--json"],
        "icosahedral": ["--grid-type", "icosahedral", "--width", "32",
                        "--height", "32", "--dt", "450", "--steps", "20",
                        "--json"],
        "nest_patch": ["--width", "128", "--height", "128", "--dt", "0.02",
                       "--nest-patch", "32,96,32,96", "--nest-ratio", "2",
                       "--steps", "20", "--json"],
    }
    with tempfile.TemporaryDirectory() as tmp:
        runs["netcdf"] = ["--width", "64", "--height", "64", "--steps", "11",
                          "--output-interval", "5", "--output-format",
                          "netcdf", "--output-dir", tmp, "--json"]
        for name, argv in runs.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            ok = rc == 0 and line.get("num_steps") == int(
                argv[argv.index("--steps") + 1]) - 1
            extra = {}
            if name == "netcdf":
                files = sorted(os.listdir(tmp))
                variables, dims, gatts = read_netcdf(os.path.join(
                    tmp, files[-1]))
                finite = all(np.isfinite(a).all()
                             for _, a in variables.values())
                ok = ok and files == ["weather_00000006.nc",
                                      "weather_00000011.nc"] and finite \
                    and dims == {"y": 64, "x": 64} and \
                    int(gatts["step"]) == 11
                extra = {"files": files, "variables": sorted(variables),
                         "dims": dims, "finite": finite}
            emit("global_cli", ok=ok, run=name, rc=rc, result=line, **extra)
            if not ok:
                fail("global_cli", f"CLI {name} run failed")


def global_paths() -> dict:
    """Phase 16: the C-grid, nested, spectral and icosahedral cores and
    their sharded forms (GLOBAL_PATHS) at full width on cuda:0."""
    import torch

    t0 = time.perf_counter()
    res = {"cpu_vs_card": _global_cpu_vs_card(),
           "cgrid_vs_numpy": _cgrid_reference()}
    for name in ("staggered_2048", "nested_512", "sph_swe_T341",
                 "sph_bve_T341", "icosa_256"):
        res[name] = _global_path(name)
    res["sph_si_T170"] = _global_si()
    res["sph_swe_T341_4x1"] = _sphere_sharded_and_fold()
    res["icosa_256_5x1"] = _icosa_sharded()
    _global_cli()
    torch.cuda.empty_cache()
    emit("global_summary", ok=True, seconds=time.perf_counter() - t0,
         ms_per_step={n: r["ms_per_step"] for n, r in res.items()
                      if isinstance(r, dict) and "ms_per_step" in r},
         paced_by={n: r["paced_by"] for n, r in res.items()
                   if isinstance(r, dict) and "paced_by" in r})
    return res


# ------------------------------------------------------------ phase 17

SIGNAL_CPU_TOL = 1e-4       # the card against the port on the CPU, normalised
IIR_TOL = 1e-4              # parallel vs scan: tests/test_signal.py:284
STREAM_ATOL = 1e-5          # streamed vs one-shot scan: :639
LMS_Y_REL, LMS_W_ATOL = 2e-4, 5e-4   # parallel vs scan engine: :356-358
RECON_ATOL = 1e-3           # STFT / DWT / WPT round trips: :407, 430, 480
RLS_HORIZON = 512           # RLS samples held card to CPU (ROADMAP.md §3)
SEQ_N = 4096                # samples of the sequential engines' timed runs
SEQ_CALLS = 3               # their timed calls, after one warm-up


def _graph_ms(fn, replays: int = 5) -> tuple:
    """The device's time for one call of fn(): the call captured once in a
    CUDA graph, then replayed, timed by CUDA events, so that its kernels
    run back to back with no host in the way (the gaps between them
    included). Returns (ms, None), or (None, the reason) where the call
    cannot be captured. Phase 17 reads the device's work this way: late
    in the script's process torch.profiler (``_device_ms``) recorded only
    some kernels of calls that launch few, and a call queued behind a
    spin overfills the launch queue where it launches ~1000."""
    import torch

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as err:
        del graph
        torch.cuda.synchronize()
        return None, str(err).splitlines()[0][:200]
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / replays, None


def _analysis(name: str):
    from njw_tpu_torch.signal.main_paths import ANALYSIS_PATHS

    return ANALYSIS_PATHS[name]


def _signal_cases() -> dict:
    """The card-vs-CPU cases: for each, a function of the device that runs
    the port's call on the same seeded inputs and returns its outputs."""
    import numpy as np
    import torch
    from njw_tpu_torch import signal as sg
    from njw_tpu_torch.signal.spectral import compute_csd

    rng = np.random.default_rng(17)
    x2 = rng.standard_normal((4, 8192)).astype(np.float32)
    y2 = rng.standard_normal((4, 8192)).astype(np.float32)
    x1 = rng.standard_normal(SEQ_N).astype(np.float32)
    h = rng.standard_normal(16).astype(np.float32) * 0.3
    d1 = (np.convolve(x1, h)[:SEQ_N]
          + 0.01 * rng.standard_normal(SEQ_N)).astype(np.float32)
    d_rls = np.convolve(x1, [0.5, -0.3, 0.2, 0.1])[:SEQ_N].astype(np.float32)
    t = np.arange(16384) / 16000.0
    harm = (sum(np.sin(2 * np.pi * k * 220.0 * t) / k for k in range(1, 6))
            + 0.01 * rng.standard_normal(16384)).astype(np.float32)
    sos = sg.IIRFilter(design="butterworth", order=8, cutoff=0.2,
                       device="cpu").sos
    scales = np.arange(2, 40, 2, dtype=np.float32)

    def on(dev, a):
        return torch.from_numpy(a).to(dev)

    def stream(dev):
        si = sg.StreamingIIR(sos, batch=4, device=dev)
        return [torch.cat([si.process(c) for c in
                           on(dev, x2[:, :2048]).split([300, 700, 1048], 1)],
                          dim=1)]

    def adaptive(method, engine, mu):
        def run(dev):
            return list(sg.AdaptiveFilter(
                num_taps=16, method=method, mu=mu, engine=engine,
                device=dev).apply(on(dev, x1), on(dev, d1)))
        return run

    def rls(dev):
        y, e, w = sg.AdaptiveFilter(num_taps=4, method="rls",
                                    device=dev).apply(on(dev, x1),
                                                      on(dev, d_rls))
        return [y[:RLS_HORIZON], e[:RLS_HORIZON], w]

    def stft(dev):
        # the inverse's interior: within a window of either end the
        # window-square sum it divides by nears 0 (the JAX test's interior)
        st = sg.STFT(256, 64, device=dev)
        spec = st.forward(on(dev, x2))
        return [spec, st.inverse(spec, 8192)[..., 256:-256]]

    def dwt(dev):
        d = sg.DWT("db4", device=dev)
        c = d.decompose(on(dev, x2), 3)
        return c + [d.reconstruct(c)]

    def wpt(dev):
        w = sg.WPT("db4", device=dev)
        leaves = w.decompose(on(dev, x2), 2)
        return leaves + [w.reconstruct(leaves)]

    return {
        "sos_scan": lambda dev: [sg.sos_apply(on(dev, x2[:, :2048]), sos,
                                              "scan")],
        "sos_parallel": lambda dev: [sg.sos_apply(on(dev, x2), sos,
                                                  "parallel")],
        "streaming_iir": stream,
        "median_11": lambda dev: [sg.median_filter(on(dev, x2), 11)],
        "lms_scan": adaptive("lms", "scan", 0.01),
        "lms_parallel": adaptive("lms", "parallel", 0.01),
        "nlms_scan": adaptive("nlms", "scan", 0.4),
        "nlms_parallel": adaptive("nlms", "parallel", 0.4),
        "block_lms": adaptive("block_lms", "auto", 0.05),
        "rls": rls,
        "psd": lambda dev: list(sg.compute_psd(on(dev, x2), 1000.0, 512)),
        "csd": lambda dev: list(compute_csd(on(dev, x2), on(dev, y2),
                                            1000.0, 512)),
        "coherence": lambda dev: list(sg.compute_coherence(
            on(dev, x2), on(dev, y2), 1000.0, 512)),
        "spectrogram": lambda dev: list(sg.compute_spectrogram(
            on(dev, x2), 1000.0, 512)),
        "cepstrum": lambda dev: [sg.cepstrum(on(dev, harm))],
        "pitch": lambda dev: [sg.pitch_detect(on(dev, harm), 16000.0)],
        "stft_round_trip": stft,
        "cwt": lambda dev: [sg.CWT(device=dev).forward(on(dev, x2[0, :2048]),
                                                       scales)],
        "dwt_round_trip": dwt,
        "wpt_round_trip": wpt,
        "modwt": lambda dev: sg.MODWT("db4", device=dev).decompose(
            on(dev, x2), 4),
        "wigner_ville_1024": lambda dev: [sg.WignerVille(device=dev).forward(
            on(dev, x2[0, :1024]))],
        "mel": lambda dev: [sg.mel_spectrogram(on(dev, harm), 16000.0)],
        "mfcc": lambda dev: [sg.mfcc(on(dev, harm), 16000.0)],
    }


def _signal_cpu_vs_card() -> dict:
    """Every ported function on the card against the port on the CPU,
    normalised by each output's largest value: within SIGNAL_CPU_TOL."""
    out = {}
    for name, run in _signal_cases().items():
        card, cpu = run("cuda"), run("cpu")
        diffs = [_normalised_diff(a.cpu(), b) for a, b in zip(card, cpu)]
        worst = max(diffs)
        ok = (len(card) == len(cpu) and worst <= SIGNAL_CPU_TOL
              and all(a.shape == b.shape for a, b in zip(card, cpu)))
        out[name] = worst
        if not ok:
            emit("signal_cpu_vs_card", ok=False, case=name,
                 normalised_max_diff=diffs, tol=SIGNAL_CPU_TOL)
            fail("signal_cpu_vs_card", f"{name}: the card and the CPU "
                 "disagree")
    emit("signal_cpu_vs_card", ok=True, tol=SIGNAL_CPU_TOL,
         normalised_max_diff=out)
    return out


def _analysis_path(name: str) -> dict:
    """One ANALYSIS_PATHS entry as a user calls it: warm-up calls, then the
    timed calls by CUDA events with every launch count set to 0 just
    before and read just after, the host's enqueue per call, the device's
    time for one call replayed from a CUDA graph (``_graph_ms``) beside the
    kernels' sum under torch.profiler, paced_by, peak memory, and for a
    path that reaches fir_band each launch against its plain version."""
    import torch

    p = _analysis(name)
    phase = f"analysis_path_{name}"
    torch.cuda.empty_cache()
    xs = p.inputs(seed=0)
    call = p.call("cuda")
    for _ in range(p.warm):
        out = call(*xs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(p.calls):
        out = call(*xs)
    end.record()
    end.synchronize()
    launched = counts()
    ms = start.elapsed_time(end) / p.calls
    peak = torch.cuda.max_memory_allocated()
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    t0 = time.perf_counter()
    for _ in range(p.calls):
        call(*xs)
    host_ms = (time.perf_counter() - t0) * 1e3 / p.calls
    torch.cuda.synchronize()
    reset_counts()
    call(*xs)
    one_call = counts()["fir_band"]
    device_ms, graph_error = _graph_ms(lambda: call(*xs))
    profiler_ms = _device_ms(lambda: call(*xs)) or None
    n_bytes = sum(t.numel() * t.element_size() for t in xs + outs)
    want = {**{k: 0 for k in launched}, "fir_band": p.fir_band * p.calls}
    r = {"ms_per_call": ms, "gbps": n_bytes / (ms * 1e6),
         "host_enqueue_ms_per_call": host_ms, "device_ms_per_call": device_ms,
         "profiler_kernel_ms_per_call": profiler_ms,
         "graph_error": graph_error,
         "device_busy_share": device_ms and device_ms / ms,
         "paced_by": paced_by(ms, host_ms, device_ms),
         "peak_mem_bytes": peak, "launches": launched,
         "fir_band_launches_one_call": one_call}
    vs_plain = _fir_launches_vs_plain(p, xs) if p.fir_band else None
    ok = (finite and launched == want and one_call == p.fir_band
          and (vs_plain is None or vs_plain["ok"]))
    emit(phase, ok=ok, source=p.source, shapes=[list(s) for s in p.shapes],
         output_shapes=[list(o.shape) for o in outs], calls=p.calls,
         warm=p.warm, bytes_per_call=n_bytes, finite=finite,
         fir_band_vs_plain=vs_plain, **r)
    if not ok:
        fail(phase, f"non-finite output, launch counts {launched} (one "
             f"call: {one_call}, expected {want}), or a fir_band launch "
             "that disagrees with its plain version")
    del xs, out, outs
    return r


def _fir_launches_vs_plain(p, xs) -> dict:
    """A path that reaches fir_band, run once more with each
    fir_batch_lanes call recorded: every launch's output against
    fir_band_plain on that launch's own input (_fir_vs_plain: rtol
    FIR_RTOL, atol the larger of FIR_ATOL and the float32 summation
    spread). These are the path's shapes: MODWT's periodic joins grow its
    rows by 7, 14, 28 and 56 samples, so the first two levels' rows are
    not 16-byte aligned and take the kernel's staging branch, the last
    two its TMA stream."""
    import torch
    from njw_tpu_torch.signal import fir_cuda as fc

    seen = []
    real = fc.fir_batch_lanes

    def recording(x, taps, **kw):
        y = real(x, taps, **kw)
        seen.append((x, taps, kw.get("passes", 3), y))
        return y

    fc.fir_batch_lanes = recording
    try:
        p.call("cuda")(*xs)
    finally:
        fc.fir_batch_lanes = real
    torch.cuda.synchronize()
    launches, ok = [], len(seen) == p.fir_band
    for x, taps, passes, y in seen:
        check, agrees = _fir_vs_plain(y, x, taps, passes)
        streamed = fc.fir_layout(*x.shape, passes=passes,
                                 data_ptr=x.data_ptr()).streamed
        launches.append({"shape": list(x.shape), "taps": len(taps),
                         "streamed": streamed, "agrees": agrees, **check})
        ok = ok and agrees
    del seen
    return {"ok": ok, "launches": launches}


def _timed_once(fn) -> tuple:
    """(result, seconds) of one call ended by a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _iir_full_width() -> dict:
    """iir_8th_1m: the doubling scan against the per-sample scan on the
    same 2^20 samples (rtol / atol IIR_TOL), and StreamingIIR over
    1024-sample chunks of all of them against the one-shot scan
    (STREAM_ATOL; the same per-sample function, so bit for bit expected).
    The scan and the stream run once each and are timed: a few hundred
    µs a sample on the card's host, so together they take minutes."""
    import torch
    from njw_tpu_torch.signal import IIRFilter, StreamingIIR, sos_apply

    x, = _analysis("iir_8th_1m").inputs(seed=0)
    sos = IIRFilter(design="butterworth", order=8, cutoff=0.2).sos
    y_par = sos_apply(x, sos, "parallel")
    y_scan, scan_s = _timed_once(lambda: sos_apply(x, sos, "scan"))
    si = StreamingIIR(sos)
    y_stream, stream_s = _timed_once(lambda: torch.cat(
        [si.process(c) for c in x.split(1024)]))
    d = (y_par - y_scan).abs()
    par_ok = bool((d <= IIR_TOL + IIR_TOL * y_scan.abs()).all())
    stream_diff = float((y_stream - y_scan).abs().max())
    r = {"samples": x.numel(), "parallel_vs_scan_max_abs": float(d.max()),
         "parallel_vs_scan_ok": par_ok, "tol": IIR_TOL,
         "stream_vs_scan_max_abs": stream_diff,
         "stream_bit_equal": bool(torch.equal(y_stream, y_scan)),
         "stream_atol": STREAM_ATOL, "scan_seconds": scan_s,
         "scan_us_per_sample": scan_s / x.numel() * 1e6,
         "stream_seconds": stream_s,
         "stream_us_per_sample": stream_s / x.numel() * 1e6}
    ok = par_ok and stream_diff <= STREAM_ATOL
    emit("analysis_invariant_iir", ok=ok, **r)
    if not ok:
        fail("analysis_invariant_iir", "the parallel or streamed IIR "
             "disagrees with the per-sample scan")
    return r


def _lms_full_width() -> dict:
    """lms_64_50k: the parallel engine (the path) against the scan engine
    on the same inputs: y and e within LMS_Y_REL of max|y|, w within
    LMS_W_ATOL."""
    from njw_tpu_torch.signal import AdaptiveFilter

    x, d = _analysis("lms_64_50k").inputs(seed=0)
    yp, ep, wp = AdaptiveFilter(num_taps=64, method="lms", mu=0.01,
                                engine="parallel").apply(x, d)
    (ys, es, ws), scan_s = _timed_once(lambda: AdaptiveFilter(
        num_taps=64, method="lms", mu=0.01, engine="scan").apply(x, d))
    scale = float(ys.abs().max())
    r = {"y_max_abs": float((yp - ys).abs().max()),
         "e_max_abs": float((ep - es).abs().max()),
         "w_max_abs": float((wp - ws).abs().max()), "y_scale": scale,
         "y_tol": LMS_Y_REL * scale, "w_tol": LMS_W_ATOL,
         "scan_seconds": scan_s}
    ok = (r["y_max_abs"] <= r["y_tol"] and r["e_max_abs"] <= r["y_tol"]
          and r["w_max_abs"] <= LMS_W_ATOL)
    emit("analysis_invariant_lms", ok=ok, samples=x.numel(), **r)
    if not ok:
        fail("analysis_invariant_lms", "the parallel LMS disagrees with the "
             "scan engine")
    return r


def _reconstruction_full_width() -> dict:
    """DWT("db4") (3 levels) and WPT("db4") (2 levels) on the modwt_16x1m
    input reconstruct it within RECON_ATOL (their batches of 16 rows run
    on fir_band), and so does STFT(1024, 256) on its first two rows away
    from the ends (the JAX test's interior, tests/test_signal.py:407)."""
    import torch
    from njw_tpu_torch.signal import DWT, STFT, WPT

    x, = _analysis("modwt_16x1m").inputs(seed=0)
    n = x.shape[-1]
    dwt = DWT("db4")
    dwt_err = float((dwt.reconstruct(dwt.decompose(x, 3))[..., :n]
                     - x).abs().max())
    wpt = WPT("db4")
    wpt_err = float((wpt.reconstruct(wpt.decompose(x, 2))[..., :n]
                     - x).abs().max())
    st = STFT(1024, 256)
    y = st.inverse(st.forward(x[:2]))       # ends at the last whole frame
    stft_err = float((y - x[:2, :y.shape[-1]])[..., 1024:-1024].abs().max())
    torch.cuda.empty_cache()
    ok = max(dwt_err, wpt_err, stft_err) <= RECON_ATOL
    r = {"dwt_max_abs": dwt_err, "wpt_max_abs": wpt_err,
         "stft_interior_max_abs": stft_err, "atol": RECON_ATOL}
    emit("analysis_invariant_reconstruction", ok=ok, shape=list(x.shape),
         **r)
    if not ok:
        fail("analysis_invariant_reconstruction", "a round trip misses "
             "the input")
    return r


def _sequential_engines() -> dict:
    """The per-sample engines at SEQ_N samples: ms per call by CUDA events
    over SEQ_CALLS calls, the host's enqueue per call, the device's time
    for one call replayed from a CUDA graph beside the kernels' sum under
    torch.profiler, and paced_by."""
    import numpy as np
    import torch
    from njw_tpu_torch.signal import (
        AdaptiveFilter, IIRFilter, StreamingIIR, sos_apply,
    )

    rng = np.random.default_rng(3)
    x, d = (torch.from_numpy(rng.standard_normal(SEQ_N, dtype=np.float32))
            .cuda() for _ in range(2))
    sos = IIRFilter(design="butterworth", order=8, cutoff=0.2).sos

    def stream():
        si = StreamingIIR(sos)
        return torch.cat([si.process(c) for c in x.split(1024)])

    def adaptive(method):
        af = AdaptiveFilter(num_taps=64, method=method, mu=0.01,
                            engine="scan")
        return lambda: af.apply(x, d)

    engines = {"sos_scan_8th": lambda: sos_apply(x, sos, "scan"),
               "streaming_iir_8th_1024": stream,
               "lms_scan_64": adaptive("lms"), "nlms_scan_64":
               adaptive("nlms"), "rls_64": adaptive("rls")}
    out = {}
    for name, fn in engines.items():
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(SEQ_CALLS):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / SEQ_CALLS
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / SEQ_CALLS
        device_ms, graph_error = _graph_ms(fn, replays=1)
        out[name] = {"samples": SEQ_N, "ms_per_call": ms,
                     "us_per_sample": ms / SEQ_N * 1e3,
                     "host_enqueue_ms_per_call": host_ms,
                     "device_ms_per_call": device_ms,
                     "graph_error": graph_error,
                     "profiler_kernel_ms_per_call": _device_ms(fn) or None,
                     "paced_by": paced_by(ms, host_ms, device_ms)}
        emit(f"analysis_sequential_{name}", ok=True, **out[name])
    return out


def analysis_paths() -> dict:
    """Phase 17: the rest of the signal package on cuda:0: every ported
    function on the card against the port on the CPU, the ANALYSIS_PATHS
    at full width, the JAX tests' invariants at full width, and the
    per-sample engines' cost."""
    from njw_tpu_torch.signal.main_paths import ANALYSIS_PATHS

    t0 = time.perf_counter()
    res = {"cpu_vs_card": _signal_cpu_vs_card()}
    for name in ANALYSIS_PATHS:
        res[name] = _analysis_path(name)
    res["lms_invariant"] = _lms_full_width()
    res["reconstruction"] = _reconstruction_full_width()
    res["sequential"] = _sequential_engines()
    res["iir_invariant"] = _iir_full_width()
    emit("analysis_summary", ok=True, seconds=time.perf_counter() - t0,
         ms_per_call={n: res[n]["ms_per_call"] for n in ANALYSIS_PATHS},
         paced_by={n: res[n]["paced_by"] for n in ANALYSIS_PATHS},
         scan_seconds_2e20=res["iir_invariant"]["scan_seconds"],
         stream_seconds_2e20=res["iir_invariant"]["stream_seconds"])
    return res


# ------------------------------------------------------------ phase 18

GRAM_REL = 2e-3             # Gram vs direct: tests/test_nbody.py:41-46
# At N = 4096 the JAX package's own Gram form misses its direct form by
# more than GRAM_REL (tests/test_torch_nbody.py::
# test_gram_band_at_the_suite_configuration): a reference fault
GRAM_FAULT = "ROADMAP.md section 3: the Gram form's band at N = 4096"
# the card against the port on the CPU, normalised; the Gram form's sums
# in another order (cuBLAS) move r2 = |p_i|^2 + |p_j|^2 - 2 p_i.p_j by
# its cancellation, so it is held to its band against the direct form
PARTICLE_CPU_TOL = {"*": 1e-4, "accelerations_mxu": GRAM_REL}
MOMENTUM_REL = 1e-3         # :102-108's 1e-3, relative to sum m |v| at start
PM_NET_REL = 1e-4           # net PM force: :184-194
NVE_DRIFT = 0.05            # tests/test_md.py:110-117
CELL_RTOL, CELL_ATOL = 1e-3, 1e-3        # cell list vs all pairs: :203-224
WATER_RTOL, WATER_ATOL = 1e-3, 1e-2      # with exclusions: :240-259
P3M_EWALD_REL = 0.03        # tests/test_nbody.py:247-268
CROSSOVER_N = (2000, 5000, 20_000)
FORCE_REPS = 3              # timed force evaluations a method and N
PARTICLE_HOST_STEPS = 10    # steps enqueued on the host clock


def _nbody_path(name: str):
    from njw_tpu_torch.nbody.main_paths import NBODY_PATHS

    return NBODY_PATHS[name]


def _md_path(name: str):
    from njw_tpu_torch.md.main_paths import MD_PATHS

    return MD_PATHS[name]


def _particle_cases() -> dict:
    """{name: run(device) -> list of tensors}: every ported N-body and MD
    function on the same seeded inputs, small, for the card against the
    CPU."""
    import numpy as np
    import torch
    from njw_tpu_torch import md, nbody
    from njw_tpu_torch.md import ewald, neighbors
    from njw_tpu_torch.nbody import pm

    rng = np.random.default_rng(18)
    p01 = rng.random((3000, 3)).astype(np.float32)
    m01 = (0.5 + rng.random(3000)).astype(np.float32)
    q16 = rng.standard_normal(16).astype(np.float32)
    q16 -= q16.mean()
    p16 = (rng.random((16, 3)) * 4.0).astype(np.float32)

    def on(dev, *arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def acc(method, n, chunk=1024):
        def run(dev):
            s = nbody.create_random_system(n, seed=1, device=dev)
            return [nbody.accelerations(s, chunk=chunk, method=method)]
        return run

    def integrate(method):
        def run(dev):
            s = nbody.create_random_system(256, seed=2, device=dev)
            sim = nbody.NBodySimulation(s, integrator=method, dt=0.001)
            sim.step(20)
            return [sim.system.pos, sim.system.vel]
        return run

    def diagnostics(dev):
        d = nbody.system_diagnostics(
            nbody.create_galaxy_model(500, seed=3, device=dev))
        return [d[k].reshape(-1) for k in sorted(d)]

    def mesh(fn):
        return lambda dev: [fn(*on(dev, p01, m01), mesh=32)]

    def pm_energy(dev):
        return [pm.pm_potential_energy(*on(dev, p01, m01), mesh=32)
                .reshape(1)]

    def perturbed_fluid(dev, n=2000):
        st, topo, lj = md.create_lj_fluid(n, density=0.4, seed=3,
                                          device=dev)
        jitter = np.random.default_rng(4).normal(
            scale=0.1, size=(n, 3)).astype(np.float32)
        return st.replace(pos=st.pos + torch.from_numpy(jitter).to(dev)), \
            topo, lj

    def cell_table(dev):
        st, _, _ = perturbed_fluid(dev)
        box = st.box.cpu().numpy()
        nc = neighbors.cell_grid(box, 2.5)
        cap = neighbors.pick_capacity(st.n, box, nc)
        table, coords, occ = neighbors.build_cell_table(st.pos, st.box, nc,
                                                        cap)
        cand = neighbors.neighbor_candidates(table, coords, nc)
        return [table, coords, occ.reshape(1), cand]

    def forces(method, water=False):
        def run(dev):
            if water:
                st, topo, lj = md.create_water_box(80, seed=4, device=dev)
            else:
                st, topo, lj = perturbed_fluid(dev)
            f, e = md.make_force_fn(topo, lj, 2.5, st.n, method=method,
                                    box_static=st.box.cpu().numpy(),
                                    device=dev)(st)
            return [f, e["potential"].reshape(1)]
        return run

    def dynamics(integrator, thermostat):
        def run(dev):
            st, topo, lj = md.create_lj_fluid(125, density=0.6, T0=0.3,
                                              seed=5, device=dev)
            sim = md.MDSimulation(st, topo, lj, dt=0.002,
                                  integrator=integrator,
                                  thermostat=thermostat, T0=1.2, tau=0.1)
            sim.step(20)
            return [sim.state.pos, sim.state.vel]
        return run

    def ewald_case(dev):
        energy, force = ewald.make_ewald_coulomb(
            np.full(3, 4.0, np.float32), alpha=1.2, r_cut=1.99, kmax=10,
            device=dev)
        p, q = on(dev, p16, q16)
        return [energy(p, q).reshape(1), force(p, q)]

    cases = {f"accelerations_{m}": acc(m, 600) for m in ("direct", "mxu")}
    cases["accelerations_blocked"] = acc("direct", 2500)
    cases["potential_and_diagnostics"] = diagnostics
    cases.update({f"nbody_{m}_20": integrate(m)
                  for m in ("euler", "leapfrog", "verlet", "rk4")})
    cases["pm_accelerations_32"] = mesh(pm.pm_accelerations)
    cases["pm_potential_energy_32"] = pm_energy
    cases["p3m_accelerations_32"] = mesh(pm.p3m_accelerations)
    cases["cell_table"] = cell_table
    cases.update({f"md_forces_{m}": forces(m)
                  for m in ("all_pairs", "cell_list")})
    cases["md_forces_water_cell_list"] = forces("cell_list", water=True)
    cases.update({f"md_{i}_{t or 'nve'}_20": dynamics(i, t)
                  for i in ("velocity_verlet", "leapfrog", "beeman")
                  for t in (None, "berendsen", "nose_hoover")})
    cases["ewald"] = ewald_case
    return cases


def _particle_cpu_vs_card() -> dict:
    """Every case of _particle_cases on the card against the CPU,
    normalised by each output's largest value (PARTICLE_CPU_TOL); the cell
    table, its coordinates and candidates exactly equal."""
    import torch

    out, bad = {}, []
    for name, run in _particle_cases().items():
        card, cpu = run("cuda"), run("cpu")
        same_shapes = len(card) == len(cpu) and all(
            a.shape == b.shape for a, b in zip(card, cpu))
        if name == "cell_table":
            equal = same_shapes and all(torch.equal(a.cpu(), b)
                                        for a, b in zip(card, cpu))
            out[name] = "equal" if equal else "differs"
            ok = equal
        else:
            diffs = [_normalised_diff(a.cpu().double(), b.double())
                     for a, b in zip(card, cpu)]
            out[name] = max(diffs)
            ok = same_shapes and out[name] <= PARTICLE_CPU_TOL.get(
                name, PARTICLE_CPU_TOL["*"])
        if not ok:
            bad.append(name)
    emit("particle_cpu_vs_card", ok=not bad, tol=PARTICLE_CPU_TOL,
         normalised_max_diff=out, failed=bad)
    if bad:
        fail("particle_cpu_vs_card", f"{bad}: the card and the CPU disagree")
    return out


def _step_device_ms(step) -> dict:
    """The device's work for one step: one call of step() captured in a
    CUDA graph and replayed (``_graph_ms``); where it cannot be captured,
    the kernels' sum in a torch.profiler session of its own, with the
    graph's reason."""
    ms, err = _graph_ms(step, replays=3)
    if ms is not None:
        return {"device_ms_per_step": ms, "device_source": "cuda_graph"}
    prof = _device_ms(step) or None
    return {"device_ms_per_step": prof,
            "device_source": "profiler" if prof else None,
            "graph_error": err,
            "device_null_reason": None if prof else
            f"no graph ({err}) and the profiler recorded no kernel"}


def _time_particle_run(sim, steps: int, warm: int, advance) -> dict:
    """Warm up, set every launch count to 0, take ``steps`` steps timed by
    CUDA events, read the counts, then the host's enqueue per step and the
    device's work for one step (``advance``: one step, mutating nothing)."""
    import torch

    sim.step(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sim.step(steps, synchronize=False)
    end.record()
    end.synchronize()
    launched = counts()
    ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated()
    n_host = min(PARTICLE_HOST_STEPS, steps)
    t0 = time.perf_counter()
    sim.step(n_host, synchronize=False)
    host_ms = (time.perf_counter() - t0) * 1e3 / n_host
    torch.cuda.synchronize()
    dev = _step_device_ms(advance)
    device_ms = dev["device_ms_per_step"]
    return {"ms_per_step": ms, "host_enqueue_ms_per_step": host_ms, **dev,
            "device_busy_share": device_ms and device_ms / ms,
            "paced_by": paced_by(ms, host_ms, device_ms),
            "peak_mem_bytes": peak, "launches": launched,
            "kernel_launches_total": sum(launched.values())}


def _particle_fail(phase: str, r: dict, msg: str) -> None:
    emit(phase, ok=False, **r)
    fail(phase, msg)


def _nbody_full_width(name: str) -> dict:
    """One NBODY_PATHS entry at full width, with its invariant: momentum
    on nbody_direct_8192, Gram against direct on nbody_suite_4096's first
    step, the net PM force on nbody_pm_1m."""
    import torch
    from njw_tpu_torch.nbody import accelerations, system_diagnostics
    from njw_tpu_torch.nbody.pm import pm_accelerations, pm_potential_energy

    p = _nbody_path(name)
    phase = f"particle_path_{name}"
    torch.cuda.empty_cache()
    sim = p.simulation("cuda")
    s0 = sim.system
    check = {}
    if name == "nbody_suite_4096":
        a_d = accelerations(s0, method="direct")
        a_g = accelerations(s0, method="mxu")
        scale = float(a_d.abs().max())
        err = float((a_g - a_d).abs().max())
        cpu = dataclasses.replace(s0, pos=s0.pos.cpu(), vel=s0.vel.cpu(),
                                  mass=s0.mass.cpu())
        card_cpu = _normalised_diff(a_g.cpu(), accelerations(
            cpu, method="mxu"))
        # the Gram band is a reference fault at this N (GRAM_FAULT): it is
        # reported against its unchanged tolerance, and the card's Gram
        # form is held to the port's on the CPU instead
        check = {"gram_vs_direct_max_abs": err, "scale": scale,
                 "tol": GRAM_REL * scale,
                 "gram_band_holds": err <= GRAM_REL * scale,
                 "reference_fault": None if err <= GRAM_REL * scale
                 else GRAM_FAULT,
                 "card_vs_cpu_gram": card_cpu, "card_vs_cpu_tol": GRAM_REL,
                 "ok": card_cpu <= GRAM_REL}
    if name == "nbody_pm_1m":
        acc = pm_accelerations(s0.pos, s0.mass, mesh=p.pm_mesh,
                               box=p.box_size, G=s0.G)
        f = (s0.mass[:, None] * acc).double()
        net = float(f.sum(0).abs().max())
        scale = float(f.abs().sum())
        check = {"net_force_max_abs": net, "scale": scale,
                 "tol": PM_NET_REL * scale, "ok": net <= PM_NET_REL * scale}
        del acc, f

    def energy(s):
        if p.pm:
            ke = 0.5 * (s.mass * (s.vel * s.vel).sum(1)).sum()
            return float(ke + pm_potential_energy(
                s.pos, s.mass, mesh=p.pm_mesh, box=p.box_size, G=s.G))
        return float(system_diagnostics(s)["total_energy"])

    e0 = energy(s0)
    p0 = (s0.mass[:, None] * s0.vel).double().sum(0)
    mv0 = float((s0.mass * s0.vel.norm(dim=1)).double().sum())
    r = _time_particle_run(sim, p.steps, p.warm,
                           lambda: sim.advance(sim._carry, sim.system))
    s1 = sim.system
    finite = bool(torch.isfinite(s1.pos).all() and
                  torch.isfinite(s1.vel).all())
    e1 = energy(s1)
    dp = float(((s1.mass[:, None] * s1.vel).double().sum(0) - p0)
               .abs().max())
    if name == "nbody_direct_8192":
        check = {"momentum_change_max_abs": dp, "sum_m_abs_v": mv0,
                 "tol": MOMENTUM_REL * mv0, "ok": dp <= MOMENTUM_REL * mv0}
    r.update({
        "source": p.source, "n": p.n, "force_method": p.force_method,
        "steps": p.steps, "warm": p.warm, "dt": p.dt, "finite": finite,
        "interactions_per_second": p.n * p.n / (r["ms_per_step"] / 1e3),
        "particle_steps_per_second": p.n / (r["ms_per_step"] / 1e3),
        "energy_initial": e0, "energy_final": e1,
        "momentum_change_max_abs": dp, "invariant": check or None})
    ok = finite and r["kernel_launches_total"] == 0 and \
        check.get("ok", True)
    if not ok:
        _particle_fail(phase, r, "non-finite state, a kernel of the port "
                       "launched, or the invariant does not hold")
    emit(phase, ok=True, **r)
    del sim, s0, s1
    return r


def _md_full_width(name: str) -> dict:
    """One MD_PATHS simulation entry at full width, with the NVE drift
    (md_suite_1000, md_lj_4096) or the water's finite state and bonded
    energy >= 0 (md_water_1000)."""
    import torch

    p = _md_path(name)
    phase = f"particle_path_{name}"
    torch.cuda.empty_cache()
    sim = p.simulation("cuda")
    e0 = sim.energies()
    r = _time_particle_run(sim, p.steps, p.warm,
                           lambda: sim.advance(sim._carry))
    e1 = sim.energies()
    finite = bool(torch.isfinite(sim.state.pos).all()) and all(
        math.isfinite(v) for v in e1.values())
    check = None
    if p.thermostat is None:
        drift = abs(e1["total"] - e0["total"]) / max(abs(e0["total"]), 1e-6)
        check = {"nve_drift": drift, "tol": NVE_DRIFT,
                 "ok": drift < NVE_DRIFT}
    elif p.system == "water":
        check = {"bonded": e1["bonded"], "ok": finite and e1["bonded"] >= 0}
    r.update({
        "source": p.source, "atoms": sim.state.n, "steps": p.steps,
        "warm": p.warm, "dt": p.dt, "cutoff": p.cutoff,
        "thermostat": p.thermostat,
        "cell_list": sim._force_fn.uses_cell_list, "finite": finite,
        "atom_steps_per_second": sim.state.n / (r["ms_per_step"] / 1e3),
        "energies_initial": e0, "energies_final": e1,
        "temperature_final": sim.temperature(), "invariant": check})
    ok = finite and r["kernel_launches_total"] == 0 and \
        (check is None or check["ok"])
    if not ok:
        _particle_fail(phase, r, "non-finite state, a kernel of the port "
                       "launched, or the invariant does not hold")
    emit(phase, ok=True, **r)
    del sim
    return r


def _force_times(st, fns: dict) -> dict:
    """Each force function on one state: ms per evaluation by CUDA events
    over FORCE_REPS after one warm-up, the host's enqueue, the device's
    work (``_step_device_ms``), peak memory and launch counts."""
    import torch

    out = {}
    for method, fn in fns.items():
        torch.cuda.empty_cache()
        fn(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(FORCE_REPS):
            f, e = fn(st)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / FORCE_REPS
        end.synchronize()
        launched = counts()
        ms = start.elapsed_time(end) / FORCE_REPS
        peak = torch.cuda.max_memory_allocated()
        dev = _step_device_ms(lambda: fn(st))
        out[method] = {"ms_per_eval": ms, "host_enqueue_ms_per_eval": host_ms,
                       **dev, "paced_by": paced_by(
                           ms, host_ms, dev["device_ms_per_step"]),
                       "peak_mem_bytes": peak, "launches": launched,
                       "kernel_launches_total": sum(launched.values()),
                       "forces": f, "potential": float(e["potential"])}
    return out


def _forces_agree(a, b, rtol: float, atol: float) -> tuple:
    """(largest |a - b| - rtol |b|, ok): a within atol + rtol |b| of b."""
    excess = float(((a - b).abs() - rtol * b.abs()).max())
    return excess, excess <= atol


def _md_forces_full_width(name: str) -> dict:
    """md_forces_5k / _20k: one force evaluation by all pairs and one by
    the cell list, timed, and the two forces within CELL_RTOL / CELL_ATOL
    (tests/test_md.py:203-224)."""
    p = _md_path(name)
    phase = f"particle_path_{name}"
    st, topo, lj = p.make_system("cuda")
    res = _force_times(st, p.force_fns(st, topo, lj))
    fa, fc = res["all_pairs"].pop("forces"), res["cell_list"].pop("forces")
    excess, agree = _forces_agree(fc, fa, CELL_RTOL, CELL_ATOL)
    r = {"source": p.source, "atoms": st.n, "methods": res,
         "invariant": {"cell_vs_all_pairs_excess": excess,
                       "max_abs_force": float(fa.abs().max()),
                       "rtol": CELL_RTOL, "atol": CELL_ATOL, "ok": agree}}
    ok = agree and all(m["kernel_launches_total"] == 0
                       for m in res.values())
    if not ok:
        _particle_fail(phase, r, "the cell list disagrees with all pairs, "
                       "or a kernel of the port launched")
    emit(phase, ok=True, **r)
    return r


def _water_cell_vs_all_pairs() -> dict:
    """md_water_1000's initial state: the cell list with the exclusions
    subtracted against masked all pairs (WATER_RTOL / WATER_ATOL,
    tests/test_md.py:240-259)."""
    p = _md_path("md_water_1000")
    st, topo, lj = p.make_system("cuda")
    f = {m: fn(st) for m, fn in p.force_fns(st, topo, lj).items()}
    excess, agree = _forces_agree(f["cell_list"][0], f["all_pairs"][0],
                                  WATER_RTOL, WATER_ATOL)
    pot = {m: float(e["potential"]) for m, (_, e) in f.items()}
    r = {"excess": excess, "rtol": WATER_RTOL, "atol": WATER_ATOL,
         "potential": pot, "ok": agree}
    emit("particle_invariant_water_cells", **r)
    if not agree:
        fail("particle_invariant_water_cells", "the cell list with "
             "exclusions disagrees with all pairs")
    return r


def _p3m_vs_ewald() -> dict:
    """P3M on the card against the exact Ewald sum with the masses as
    charges, at tests/test_nbody.py:247-268's size and tolerance."""
    import numpy as np
    import torch
    from njw_tpu_torch.md.ewald import make_ewald_coulomb
    from njw_tpu_torch.md.forces import COULOMB_K
    from njw_tpu_torch.nbody.pm import p3m_accelerations

    rng = np.random.default_rng(12)
    pos = rng.random((40, 3)).astype(np.float32)
    mass = (0.5 + rng.random(40)).astype(np.float32)
    tp, tm = (torch.from_numpy(a).cuda() for a in (pos, mass))
    got = p3m_accelerations(tp, tm, mesh=64, box=1.0)
    _, coul_forces = make_ewald_coulomb(np.ones(3), alpha=6.0, r_cut=0.49,
                                        kmax=14, device="cuda")
    want = (-1.0 / COULOMB_K) * coul_forces(tp, tm) / tm[:, None]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    r = {"max_abs": err, "scale": scale, "tol": P3M_EWALD_REL * scale,
         "ok": err <= P3M_EWALD_REL * scale}
    emit("particle_invariant_p3m_ewald", **r)
    if not r["ok"]:
        fail("particle_invariant_p3m_ewald", "P3M misses the Ewald sum")
    return r


def _cell_list_crossover(forces_5k: dict, forces_20k: dict) -> dict:
    """All pairs against the cell list at N = 2000 (timed here), 5000 and
    20000 (their paths' times): the smallest N at which the cell list
    was faster, the constant make_force_fn's 'auto' takes on CUDA."""
    p = _md_path("md_forces_5k")
    st, topo, lj = dataclasses.replace(p, n=2000).make_system("cuda")
    res = _force_times(st, p.force_fns(st, topo, lj))
    ms = {2000: {m: r["ms_per_eval"] for m, r in res.items()}}
    for n, r in ((5000, forces_5k), (20_000, forces_20k)):
        ms[n] = {m: v["ms_per_eval"] for m, v in r["methods"].items()}
    wins = [n for n in CROSSOVER_N
            if ms[n]["cell_list"] < ms[n]["all_pairs"]]
    from njw_tpu_torch.md.forces import _CELL_LIST_MIN_N_CUDA

    r = {"ms_per_eval": {str(n): v for n, v in ms.items()},
         "cell_list_wins_from_n": min(wins) if wins else None,
         "constant_in_md_forces": _CELL_LIST_MIN_N_CUDA}
    emit("particle_crossover", ok=True, **r)
    return r


def _particle_cli() -> None:
    """Both CLIs once each on the card, a short run, their JSON lines."""
    from njw_tpu_torch.md.__main__ import main as md_main
    from njw_tpu_torch.nbody.__main__ import main as nbody_main

    runs = {
        "nbody": (nbody_main, ["--num-particles", "256", "--duration",
                               "0.05", "--device", "cuda"],
                  {"particles": 256, "steps": 5}),
        "md": (md_main, ["--num-atoms", "256", "--steps", "20",
                         "--device", "cuda"], {"atoms": 256, "steps": 20}),
    }
    for name, (main_fn, argv, want) in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main_fn(argv)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        ok = rc == 0 and all(line.get(k) == v for k, v in want.items()) \
            and math.isfinite(line["energy_final"]) and line["ms_per_step"] > 0
        emit("particle_cli", ok=ok, run=name, rc=rc, result=line)
        if not ok:
            fail("particle_cli", f"CLI {name} run failed")


def particle_paths() -> dict:
    """Phase 18: the N-body and MD packages on cuda:0: every ported
    function on the card against the port on the CPU, the NBODY_PATHS and
    MD_PATHS at full width with the JAX tests' invariants, the all-pairs /
    cell-list crossover, and both CLIs."""
    import torch
    from njw_tpu_torch.md.main_paths import MD_PATHS
    from njw_tpu_torch.nbody.main_paths import NBODY_PATHS

    t0 = time.perf_counter()
    res = {"cpu_vs_card": _particle_cpu_vs_card()}
    for name in NBODY_PATHS:
        res[name] = _nbody_full_width(name)
    for name, p in MD_PATHS.items():
        res[name] = (_md_full_width(name) if p.steps
                     else _md_forces_full_width(name))
    res["water_cells"] = _water_cell_vs_all_pairs()
    res["p3m_ewald"] = _p3m_vs_ewald()
    res["crossover"] = _cell_list_crossover(res["md_forces_5k"],
                                            res["md_forces_20k"])
    _particle_cli()
    torch.cuda.empty_cache()
    runs = {n: r for n, r in res.items() if "ms_per_step" in r}
    emit("particle_summary", ok=True, seconds=time.perf_counter() - t0,
         budget_seconds=150,
         ms_per_step={n: r["ms_per_step"] for n, r in runs.items()},
         paced_by={n: r["paced_by"] for n, r in runs.items()},
         cell_list_wins_from_n=res["crossover"]["cell_list_wins_from_n"])
    return res


# ------------------------------------------------------------ phase 19

IMAGING_CPU_TOL = 1e-4      # the card against the port on the CPU, normalised
MASK_SHARE = 1e-3           # masks and labels: share of differing cells
FBP_CORR = 0.9              # tests/test_medical.py:42-51
CG_FULL_ATOL = 1e-3         # fully sampled CG against the image: :118-125
CG_ZF, PD_ZF, CS_ZF = 0.5, 0.7, 0.8   # error over zero-filled: :127-173
RADIAL_CC = 0.93            # KB gridding's correlation: :192-218
SHIFT_TOL, ANGLE_TOL = 0.7, 0.03      # :358-372
DEFORM_RATIO = 0.3          # deformable MSE over its start: :403-425
COST_RTOL, COST_ATOL = 2e-5, 1e-4     # tests/test_geospatial.py:125-131
FILL_ATOL = 5e-3            # against the Jacobi fixed point: :133-153
DEFORM_CPU_REL = 1e-3       # the card's deformable MSE ratio against the CPU's
IMAGING_BUDGET_S = 150
# behaviours of the reference at the paths' configurations: the JAX
# package misses the same bound on the CPU (ROADMAP.md section 3)
CG_NOISE_FAULT = ("ROADMAP.md section 3: CG-SENSE on the example's noisy "
                  "k-space at R = 4")
DEFORM_FAULT = ("ROADMAP.md section 3: register_deformable at the "
                "example's settings")


def _small_imaging_inputs() -> dict:
    """Seeded NumPy inputs of the card-against-CPU cases: 64^2 images,
    a 32^3 volume, 48^2 DEMs, 20 000 points."""
    import numpy as np
    from njw_tpu_torch.geospatial.datasets import synthetic_point_cloud
    from njw_tpu_torch.geospatial.main_paths import measure_dem
    from njw_tpu_torch.medical import main_paths as mp

    rng = np.random.default_rng(19)
    img = mp.insert_phantom(64)
    n = 64
    sens = mp.coil_maps(n, 4)
    mask = np.zeros((n, n), np.float32)
    mask[::2] = 1.0
    mask[n // 2 - 6:n // 2 + 6] = 1.0
    k1 = np.fft.fftshift(np.fft.fft2(img, norm="ortho")).astype(np.complex64)
    kc = (mask[None] * np.fft.fftshift(np.fft.fft2(sens * img[None],
                                                   norm="ortho"),
                                       axes=(-2, -1))).astype(np.complex64)
    coords = mp.radial_trajectory(32, 64)
    dem = measure_dem(48)
    y, x = np.mgrid[0:64, 0:64].astype(np.float32)
    smooth = (np.sin(x / 7) * np.cos(y / 9) + np.exp(
        -((x - 32) ** 2 + (y - 28) ** 2) / 300)).astype(np.float32)
    return {
        "img": img, "noisy": img + 0.1 * rng.standard_normal(
            (n, n)).astype(np.float32),
        "angles": np.linspace(0, np.pi, 30, endpoint=False).astype(
            np.float32),
        "vol": mp.ball_volume(32),
        "views": np.linspace(0, 2 * np.pi, 12, endpoint=False).astype(
            np.float32),
        "k1": k1, "kc": kc, "mask": mask, "sens": sens,
        "kpf": np.where(np.arange(n)[:, None] < 40, k1, 0).astype(
            np.complex64),
        "coords": coords,
        "samples": (rng.standard_normal(len(coords))
                    + 1j * rng.standard_normal(len(coords))).astype(
                        np.complex64),
        "kernel": rng.standard_normal((4, 5)).astype(np.float32),
        "stack": rng.standard_normal((2, 3, 16, 16)).astype(np.float32),
        "elev": mp.two_basins(32)[0], "markers": mp.two_basins(32)[1],
        "smooth": smooth, "ctrl": rng.normal(0, 1.5, (2, 7, 7)).astype(
            np.float32),
        "dem": dem, "cost": np.abs(dem) * 0.01 + 1.0,
        "points": synthetic_point_cloud(20_000, seed=1),
    }


def _imaging_cases() -> dict:
    """{name: (kind, run(device) -> list of tensors)}: every ported medical
    and geospatial function on the same seeded small inputs. kind: "close"
    (normalised IMAGING_CPU_TOL), "equal" (exactly, NaN where NaN) or
    "share" (masks and labels: the share of differing cells)."""
    import numpy as np
    import torch
    from njw_tpu_torch import geospatial as geo
    from njw_tpu_torch import medical as med
    from njw_tpu_torch.geospatial import point_cloud as pcm
    from njw_tpu_torch.medical import ct, registration as reg

    s = _small_imaging_inputs()

    def t(dev, *keys):
        return [torch.from_numpy(np.ascontiguousarray(s[k])).to(dev)
                for k in keys]

    def one(fn):
        return lambda dev: [fn(dev)]

    cases = {
        "radon": ("close", one(lambda dev: med.radon(*t(dev, "img",
                                                        "angles")))),
        "sirt_5": ("close", one(lambda dev: med.sirt(
            med.radon(*t(dev, "img", "angles")), t(dev, "angles")[0], 5))),
        "cone_project": ("close", one(lambda dev: ct.cone_beam_project(
            *t(dev, "vol", "views"), sod=64.0, sdd=128.0,
            det_shape=(32, 32)))),
        "reconstruct_kspace": ("close", one(
            lambda dev: med.reconstruct_kspace(*t(dev, "k1")))),
        "grid_noncartesian": ("close", one(
            lambda dev: med.grid_noncartesian(*t(dev, "samples", "coords"),
                                              32))),
        "pipe_menon_dcf": ("close", one(
            lambda dev: med.pipe_menon_dcf(*t(dev, "coords"), 32))),
        "gridding_reconstruct": ("close", one(
            lambda dev: med.gridding_reconstruct(
                *t(dev, "samples", "coords"), 32))),
        "cg_sense_10": ("close", one(lambda dev: med.reconstruct_cg(
            *t(dev, "kc", "mask", "sens"), num_iterations=10))),
        "primal_dual_30": ("close", one(
            lambda dev: med.reconstruct_primal_dual(
                t(dev, "k1")[0] * t(dev, "mask")[0], t(dev, "mask")[0],
                num_iterations=30))),
        "fista_20": ("close", one(
            lambda dev: med.reconstruct_compressed_sensing(
                t(dev, "k1")[0] * t(dev, "mask")[0], t(dev, "mask")[0],
                num_iterations=20))),
        "partial_fourier": ("close", one(
            lambda dev: med.reconstruct_partial_fourier(
                *t(dev, "kpf"), 40 / 64))),
        "convolve2d": ("close", one(lambda dev: med.convolve2d(
            *t(dev, "noisy", "kernel")))),
        "gaussian": ("close", one(lambda dev: med.gaussian_filter(
            *t(dev, "noisy"), 2.0))),
        "median_5": ("close", one(lambda dev: med.median_filter(
            *t(dev, "noisy"), 5))),
        "bilateral_5": ("close", one(lambda dev: med.bilateral_filter(
            *t(dev, "noisy"), 5))),
        "nlm_3_1": ("close", one(lambda dev: med.nlm_filter(
            *t(dev, "noisy"), 3, 1))),
        "apply_filter_4d": ("close", lambda dev: [
            med.apply_filter(*t(dev, "stack"), m)
            for m in ("gaussian", "median", "bilateral", "nlm")]),
        "threshold": ("equal", one(lambda dev: med.threshold(
            *t(dev, "noisy"), 0.5))),
        "otsu_threshold": ("close", one(lambda dev: torch.tensor(
            [med.otsu_threshold(*t(dev, "noisy"))]))),
        "adaptive": ("share", one(lambda dev: med.apply_segmentation(
            *t(dev, "noisy"), "adaptive"))),
        "region_growing": ("equal", one(lambda dev: med.region_growing(
            *t(dev, "img"), (32, 32), 0.5, 64))),
        "watershed": ("equal", one(lambda dev: med.watershed(
            *t(dev, "elev", "markers")))),
        "mrf_segment": ("equal", one(lambda dev: med.mrf_segment(
            *t(dev, "noisy"), 0.5, 0.3))),
        "warp_image": ("close", one(lambda dev: med.warp_image(
            *t(dev, "smooth"), torch.tensor([3.0, -2.0, 0.05, 1.0, 1.0],
                                            device=dev)))),
        "mse_metric": ("close", one(lambda dev: med.mse_metric(
            *t(dev, "smooth", "noisy")).reshape(1))),
        "mutual_information": ("close", one(
            lambda dev: med.mutual_information(
                *t(dev, "smooth", "noisy")).reshape(1))),
        "register_images_adam": ("close", lambda dev: [
            torch.from_numpy(np.asarray(v, np.float32)) for v in
            med.register_images(
                *t(dev, "smooth"), med.warp_image(
                    *t(dev, "smooth"), torch.tensor(
                        [3.0, -2.0, 0.06, 1.0, 1.0], device=dev)),
                n_iterations=20, pyramid_levels=2, optimizer="adam",
                learning_rate=0.5)]),
        "bspline_displacement": ("close", one(
            lambda dev: reg.bspline_displacement(*t(dev, "ctrl"),
                                                 (40, 44)))),
        "warp_deformable": ("close", one(lambda dev: reg.warp_deformable(
            *t(dev, "smooth", "ctrl")))),
        "register_deformable": ("close", lambda dev: [
            torch.from_numpy(np.asarray(v, np.float32)) for v in
            reg.register_deformable(
                *t(dev, "smooth"), reg.warp_deformable(
                    *t(dev, "smooth"), -t(dev, "ctrl")[0]),
                grid_shape=(4, 4), n_iterations=20, learning_rate=1.0,
                smooth_weight=0.001)]),
        "terrain_derivatives": ("close", lambda dev: list(
            geo.terrain_derivatives(*t(dev, "dem")).values())),
        "viewshed": ("share", one(lambda dev: geo.viewshed(
            *t(dev, "dem"), (24, 24)))),
        "fill_sinks": ("close", one(lambda dev: geo.fill_sinks(
            *t(dev, "dem")))),
        "flow_direction": ("equal", one(lambda dev: geo.flow_direction(
            *t(dev, "dem")))),
        "flow_push": ("equal", one(lambda dev: geo.flow_accumulation(
            *t(dev, "dem")))),
        "flow_doubling": ("equal", one(lambda dev: geo.flow_accumulation(
            *t(dev, "dem"), method="doubling"))),
        "cost_distance": ("close", one(lambda dev: geo.cost_distance(
            *t(dev, "cost"), (24, 24)))),
        "least_cost_path": ("close", one(lambda dev: _path_cost(
            s["cost"], geo.least_cost_path(*t(dev, "cost"), (24, 24),
                                           (2, 45))))),
        "resample": ("close", lambda dev: [
            geo.resample(*t(dev, "dem"), 63, 30, m)
            for m in ("bilinear", "nearest")]),
        "dem_statistics": ("close", one(lambda dev: torch.tensor(list(
            geo.dem_statistics(*t(dev, "dem")).values())))),
        "hydrology": ("equal", lambda dev: list(geo.DEMProcessor(
            *t(dev, "dem")).hydrology().values())),
        "rasterize_min_max": ("equal", lambda dev: [
            geo.rasterize_dem(s["points"], 2.0, st, device=dev)[0]
            for st in ("min", "max")]),
        "rasterize_mean": ("close", one(lambda dev: geo.rasterize_dem(
            s["points"], 2.0, "mean", device=dev)[0])),
        "classify_ground": ("share", one(lambda dev: torch.from_numpy(
            geo.classify_ground(s["points"], device=dev).classification))),
        "compute_normals": ("close", one(lambda dev: torch.from_numpy(
            geo.compute_normals(s["points"], device=dev)))),
        "extract_buildings": ("share", one(lambda dev: torch.from_numpy(
            geo.extract_buildings(pcm.classify_ground(
                s["points"], device=dev), device=dev).classification))),
    }
    for kind in ("ramlak", "shepp_logan", "cosine", "hann"):
        cases[f"fbp_{kind}"] = ("close", one(
            lambda dev, kind=kind: med.filtered_backprojection(
                med.radon(*t(dev, "img", "angles")), t(dev, "angles")[0],
                filter_kind=kind)))
    cases["fdk"] = ("close", one(lambda dev: ct.fdk_reconstruct(
        ct.cone_beam_project(*t(dev, "vol", "views"), sod=64.0, sdd=128.0,
                             det_shape=(32, 32)),
        t(dev, "views")[0], sod=64.0, sdd=128.0)))
    return cases


def _path_cost(cost, path):
    """The D8 cost of a least-cost path (float64): a path may take
    another cell where two costs tie to the ulp, its cost may not."""
    import numpy as np
    import torch

    c = np.asarray(cost, np.float64)
    total = sum(np.hypot(y1 - y0, x1 - x0) * 0.5 * (c[y0, x0] + c[y1, x1])
                for (y0, x0), (y1, x1) in zip(path, path[1:]))
    return torch.tensor([total], dtype=torch.float64)


def _same(a, b) -> bool:
    """Equal values, NaN where the other is NaN."""
    import torch

    if a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(
            torch.equal(a[~na], b[~nb]))
    return bool(torch.equal(a, b))


def _chan_vese_spread(img) -> dict:
    """chan_vese at 64^2 (100 iterations) on the card against the CPU,
    beside the CPU against itself on the image raised by one ulp: the
    level set's curvature term amplifies rounding ~10x an iteration in
    the reference too (ROADMAP.md section 3), so the card is held to
    the larger of MASK_SHARE and twice that spread."""
    import numpy as np
    import torch
    from njw_tpu_torch.medical import chan_vese

    bumped = np.nextafter(img, np.float32(np.inf)).astype(np.float32)
    cpu = chan_vese(torch.from_numpy(img))
    card = chan_vese(torch.from_numpy(img).cuda()).cpu()
    spread = float((chan_vese(torch.from_numpy(bumped)) != cpu)
                   .float().mean())
    share = float((card != cpu).float().mean())
    bound = max(MASK_SHARE, 2 * spread)
    return {"share": share, "cpu_one_ulp_spread": spread, "bound": bound,
            "ok": share <= bound}


def _imaging_cpu_vs_card() -> dict:
    """Every case of _imaging_cases on the card against the CPU."""
    import torch

    out, bad = {}, []
    for name, (kind, run) in _imaging_cases().items():
        card, cpu = run("cuda"), run("cpu")
        card = [a.cpu() for a in card]
        same_shapes = len(card) == len(cpu) and all(
            a.shape == b.shape for a, b in zip(card, cpu))
        if kind == "equal":
            ok = same_shapes and all(_same(a, b) for a, b in zip(card, cpu))
            out[name] = "equal" if ok else "differs"
        elif kind == "share":
            out[name] = max(float((a != b).float().mean())
                            for a, b in zip(card, cpu)) if same_shapes \
                else 1.0
            ok = out[name] <= MASK_SHARE
        else:
            out[name] = max(_normalised_diff(
                torch.nan_to_num(a.double()), torch.nan_to_num(b.double()))
                for a, b in zip(card, cpu)) if same_shapes else math.inf
            ok = out[name] <= IMAGING_CPU_TOL
        if not ok:
            bad.append(name)
    cv = _chan_vese_spread(_small_imaging_inputs()["noisy"])
    if not cv["ok"]:
        bad.append("chan_vese")
    emit("imaging_cpu_vs_card", ok=not bad, tol=IMAGING_CPU_TOL,
         mask_share_tol=MASK_SHARE, results=out, chan_vese=cv, failed=bad)
    if bad:
        fail("imaging_cpu_vs_card", f"{bad}: the card and the CPU disagree")
    return out


def _finite(out, nan_ok: bool = False) -> bool:
    """No inf or NaN in the output (NaN allowed where it is a value of
    the output, as in an empty raster cell, but some value finite)."""
    import numpy as np
    import torch

    if isinstance(out, torch.Tensor):
        if not out.is_floating_point():
            return True
        fin = torch.isfinite(out)
        if nan_ok:
            return bool((fin | torch.isnan(out)).all() and fin.any())
        return bool(fin.all())
    if isinstance(out, np.ndarray):
        return out.dtype.kind != "f" or bool(np.isfinite(out).all())
    if isinstance(out, dict):
        return all(_finite(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return all(_finite(v) for v in out)
    if hasattr(out, "xyz"):
        return bool(np.isfinite(out.xyz).all())
    return math.isfinite(out) if isinstance(out, float) else True


def _imaging_call(c, d, profiled=None) -> tuple:
    """One Call of a path: a warm-up call, ``c.reps`` calls timed by CUDA
    events with every launch count set to 0 just before and read just
    after, the host's enqueue of one call, the device's work for one call
    (a CUDA-graph replay where the call captures, else the kernels' sum
    under torch.profiler, with the reason), the rate, paced_by and peak
    memory. A call that reads the host and names its device part
    (``Call.device_fn``) has that part's device time read instead;
    ``profiled``, a reader of the profiler's raw activity records,
    replaces ``_device_ms`` (and reads 0 for a call with no device
    activity).
    Returns (its numbers, its last output)."""
    import torch

    out = c.fn(d)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(c.reps):
        out = c.fn(d)
    end.record()
    end.synchronize()
    launched = counts()
    ms = start.elapsed_time(end) / c.reps
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    c.fn(d)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if c.device_fn is not None:
        # the call reads the host: time its device part alone, captured
        # where it captures, else by CUDA events behind a spin
        device_ms, reason = _graph_ms(lambda: c.device_fn(d), replays=3)
        source = "cuda_graph_of_device_part"
        if device_ms is None:
            device_ms = _events_ms(lambda: c.device_fn(d), 3)
            source = "events_after_spin_of_device_part"
    else:
        device_ms, reason = (
            _graph_ms(lambda: c.fn(d), replays=3) if c.graph
            else (None, "the call reads the host or copies from it "
                  "mid-call: not captured"))
        source = "cuda_graph"
    if device_ms is None and profiled is not None:
        # the raw activity records: none at all is a call on the host
        device_ms, source = profiled(lambda: c.fn(d)), "profiler"
        if not device_ms:
            reason += "; no device activity: the call is NumPy on the host"
    if device_ms is None:
        device_ms = _device_ms(lambda: c.fn(d)) or None
        source = "profiler" if device_ms else None
        if device_ms is None:
            reason += ("; torch.profiler recorded no kernel of the call "
                       "(late in the process it misses calls of few "
                       "kernels: PERF.md section 7)")
    r = {"ms_per_call": ms, "rate": c.work / (ms / 1e3), "unit": c.unit,
         "reps": c.reps, "host_enqueue_ms_per_call": host_ms,
         "device_ms_per_call": device_ms, "device_source": source,
         "device_note": reason,
         "device_busy_share": device_ms and device_ms / ms,
         "paced_by": paced_by(ms, host_ms, device_ms),
         "peak_mem_bytes": peak, "launches": launched,
         "kernel_launches_total": sum(launched.values()),
         "finite": _finite(out, c.nan_ok)}
    return r, out


def _corr(a, b) -> float:
    import numpy as np

    a = np.asarray(a.cpu() if hasattr(a, "cpu") else a, np.float64).ravel()
    b = np.asarray(b.cpu() if hasattr(b, "cpu") else b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


def _mean_abs(a, b) -> float:
    return float((a - b).abs().mean())


def _zero_filled(k, sens=None):
    """|A^H y| of centred k-space (the coil sum where sens is given)."""
    import torch

    img = torch.fft.ifft2(torch.fft.ifftshift(k, dim=(-2, -1)), norm="ortho")
    if sens is not None:
        img = (torch.conj(sens) * img).sum(0)
    return img.abs()


def _ct_invariants(name, d, outs) -> dict:
    from njw_tpu_torch.medical import sirt

    if name == "ct_sirt_256x180":
        r5 = sirt(d["sino"], d["angles"], n_iterations=5)
        e5 = float(((r5 - d["img"]) ** 2).mean())
        e30 = float(((outs["sirt_30"] - d["img"]) ** 2).mean())
        return {"sirt_mse_5": e5, "sirt_mse_30": e30, "ok": e30 < e5}
    cc = _corr(outs["fbp"], d["img"])
    return {"fbp_correlation": cc, "bound": FBP_CORR, "ok": cc > FBP_CORR}


def _cone_invariants(name, d, outs) -> dict:
    cc = _corr(outs["fdk"], d["vol"])
    return {"fdk_correlation": cc, "gated": False, "ok": True}


def _mri_invariants(name, d, outs) -> dict:
    """CG fully sampled against the image; CG-SENSE, primal-dual and FISTA
    against zero-filled. CG-SENSE is held on the path's noise-free
    k-space (the test's data); on the example's noisy k-space its ratio
    is reported against the same bound (a reference behaviour)."""
    import torch
    from njw_tpu_torch.medical import MRIReconstructor, reconstruct_cg
    from njw_tpu_torch.medical.main_paths import MRI

    img, sens, mask = d["img"], d["sens"], d["mask"]
    k_img = torch.fft.fftshift(torch.fft.fft2(img.to(torch.complex64),
                                              norm="ortho"))
    full = reconstruct_cg(k_img, torch.ones_like(mask), num_iterations=5)
    full_err = float((full - img).abs().max())
    k_coils = mask[None] * torch.fft.fftshift(torch.fft.fft2(
        sens * img[None], norm="ortho"), dim=(-2, -1))
    clean = MRIReconstructor("cg_sense", 15, MRI["r"], sens).process(
        k_coils, mask)
    cg_clean = _mean_abs(clean, img) / _mean_abs(
        _zero_filled(k_coils, sens), img)
    cg_noisy = _mean_abs(outs["cg_sense_15"], img) / _mean_abs(
        _zero_filled(d["ku"], sens), img)
    zf1 = _mean_abs(_zero_filled(d["k1"]), img)
    pd = _mean_abs(outs["primal_dual_80"], img) / zf1
    cs = _mean_abs(outs["fista_40"], img) / zf1
    return {"cg_fully_sampled_max_abs": full_err, "cg_full_tol": CG_FULL_ATOL,
            "cg_sense_over_zero_filled": cg_clean,
            "cg_sense_noisy_over_zero_filled": cg_noisy,
            "cg_noisy_reference_fault": None if cg_noisy < CG_ZF
            else CG_NOISE_FAULT,
            "primal_dual_over_zero_filled": pd,
            "fista_over_zero_filled": cs,
            "bounds": [CG_ZF, PD_ZF, CS_ZF],
            "ok": (full_err <= CG_FULL_ATOL and cg_clean < CG_ZF
                   and pd < PD_ZF and cs < CS_ZF)}


def _radial_invariants(name, d, outs) -> dict:
    kb, bl = _corr(outs["kb_gridding"], d["img"]), _corr(outs["bilinear"],
                                                         d["img"])
    return {"kb_correlation": kb, "bilinear_correlation": bl,
            "bound": RADIAL_CC, "ok": kb > bl and kb > RADIAL_CC}


def _noop_invariants(name, d, outs) -> dict:
    return {"ok": True}


def _registration_invariants(name, d, outs) -> dict:
    """The rigid stage recovers the inverse shift and angle; the
    deformable stage's MSE ratio is reported against DEFORM_RATIO (the
    JAX package misses it at these settings too) and held to the port's
    on the CPU from the same inputs."""
    import numpy as np
    import torch
    from njw_tpu_torch.medical import main_paths as mp

    ty, tx, th = mp.REG["true"][:3]
    params = outs["rigid_adam_300"][0]
    shift = float(max(abs(params[0] + ty), abs(params[1] + tx)))
    angle = float(abs(params[2] + th))
    ctrl, warped, hist = outs["deformable_150"]
    fixed = d["fixed"].cpu().numpy()

    def ratio(w, start):
        return float(np.mean((w - fixed) ** 2) / np.mean((start - fixed) ** 2))

    card = ratio(warped, d["rigid_warped"].cpu().numpy())
    cpu_in = {k: v.cpu() for k, v in d.items() if isinstance(v, torch.Tensor)}
    _, w_rigid, _ = mp._rigid(cpu_in)
    cpu_in["rigid_warped"] = torch.from_numpy(w_rigid)
    _, w_cpu, _ = mp._deformable(cpu_in)
    cpu = ratio(w_cpu, w_rigid)
    rel = abs(card - cpu) / cpu
    return {"rigid_params": [float(v) for v in params],
            "shift_err_px": shift, "angle_err_rad": angle,
            "shift_tol": SHIFT_TOL, "angle_tol": ANGLE_TOL,
            "deformable_mse_ratio": card, "deformable_bound": DEFORM_RATIO,
            "deformable_reference_fault": None if card < DEFORM_RATIO
            else DEFORM_FAULT,
            "deformable_mse_ratio_cpu": cpu, "card_vs_cpu_rel": rel,
            "card_vs_cpu_tol": DEFORM_CPU_REL,
            "ok": shift < SHIFT_TOL and angle < ANGLE_TOL
            and rel <= DEFORM_CPU_REL}


def _d8_dijkstra(cost, source) -> "np.ndarray":
    """The exact D8 shortest-path distances (edge cost hypot * (c_a +
    c_b) / 2, float64) by scipy's Dijkstra."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    c = np.asarray(cost, np.float64)
    h, w = c.shape
    idx = np.arange(h * w).reshape(h, w)
    rows, cols, wts = [], [], []
    for dy, dx in ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1),
                   (0, -1), (-1, -1)):
        a = (slice(max(0, -dy), h - max(0, dy)),
             slice(max(0, -dx), w - max(0, dx)))
        b = (slice(max(0, dy), h + min(0, dy)),
             slice(max(0, dx), w + min(0, dx)))
        rows.append(idx[a].ravel())
        cols.append(idx[b].ravel())
        wts.append((np.hypot(dy, dx) * 0.5 * (c[a] + c[b])).ravel())
    g = sp.csr_matrix((np.concatenate(wts), (np.concatenate(rows),
                                             np.concatenate(cols))),
                      shape=(h * w, h * w))
    return dijkstra(g, indices=source[0] * w + source[1]).reshape(h, w)


def _jacobi_fill(z, eps: float):
    """The least fixed point of W = max(z, min(W, min_8nb(W) + eps)) from
    +1e30 inside the boundary, by Jacobi sweeps on the card in float64
    until a sweep changes nothing by eps * 1e-4 (checked every 32)."""
    import torch
    import torch.nn.functional as F

    z = z.double()
    h, w = z.shape
    wv = torch.full_like(z, 1e30)
    wv[0], wv[-1], wv[:, 0], wv[:, -1] = z[0], z[-1], z[:, 0], z[:, -1]
    for i in range(1, 1_000_000):
        p = F.pad(wv[None, None], (1, 1, 1, 1), value=1e30)[0, 0]
        mn = torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                          if (dy, dx) != (0, 0)]).amin(0)
        new = torch.minimum(wv, torch.maximum(z, mn + eps))
        if i % 32 == 0 and float((new - wv).abs().max()) < eps * 1e-4:
            return new, i
        wv = new
    return wv, i


def _geo_suite_invariants(name, d, outs) -> dict:
    """cost_distance against scipy's Dijkstra and fill_sinks against the
    Jacobi fixed point, on the suite's 512^2 DEM on the card."""
    import numpy as np
    from njw_tpu_torch.geospatial import cost_distance, fill_sinks

    dist = cost_distance(d["cost"], d["src"]).cpu().numpy()
    ref = _d8_dijkstra(d["cost"].cpu().numpy(), d["src"])
    excess = float(np.max(np.abs(dist - ref)
                          - (COST_ATOL + COST_RTOL * np.abs(ref))))
    jac, sweeps = _jacobi_fill(d["dem"], 1e-3)
    fill_err = float((fill_sinks(d["dem"]).double() - jac).abs().max())
    return {"cost_vs_dijkstra_excess": excess, "cost_rtol": COST_RTOL,
            "cost_atol": COST_ATOL, "fill_vs_jacobi_max_abs": fill_err,
            "fill_atol": FILL_ATOL, "jacobi_sweeps": sweeps,
            "ok": excess <= 0 and fill_err <= FILL_ATOL}


def _dem_invariants(name, d, outs) -> dict:
    import torch

    equal = bool(torch.equal(outs["flow_push"], outs["flow_doubling"]))
    path = outs["least_cost_path"]
    return {"flow_push_equals_doubling": equal,
            "least_cost_path_cells": len(path),
            "path_ends": [list(path[0]), list(path[-1])],
            "ok": equal and tuple(path[0]) == tuple(d["src"])
            and tuple(path[-1]) == (0, 0)}


_IMAGING_INVARIANTS = {
    "ct_suite_256": _ct_invariants, "ct_fbp_512x360": _ct_invariants,
    "ct_sirt_256x180": _ct_invariants, "cone_fdk_128": _cone_invariants,
    "mri_cg_256x8": _mri_invariants, "mri_radial_256": _radial_invariants,
    "filters_512": _noop_invariants, "seg_512": _noop_invariants,
    "registration_256": _registration_invariants,
    "geo_suite_512": _geo_suite_invariants, "dem_2048": _dem_invariants,
    "point_cloud_1m": _noop_invariants,
}


def _imaging_path(name: str, p) -> dict:
    """One IMAGING_PATHS or GEO_PATHS entry at full width: its setup
    (timed once, with its peak memory), each call (``_imaging_call``),
    and the JAX tests' invariants there."""
    import torch

    phase = f"imaging_path_{name}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = p.setup(torch.device("cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    calls, outs = {}, {}
    for cname, c in p.calls.items():
        calls[cname], outs[cname] = _imaging_call(c, d)
    inv = _IMAGING_INVARIANTS[name](name, d, outs)
    ok = inv["ok"] and all(r["finite"] and r["kernel_launches_total"] == 0
                           for r in calls.values())
    r = {"source": p.source, "setup_seconds": setup_s,
         "setup_peak_mem_bytes": setup_peak, "calls": calls,
         "invariant": inv}
    emit(phase, ok=ok, **r)
    if not ok:
        fail(phase, "non-finite output, a kernel of the port launched, or "
             "the invariant does not hold")
    del d, outs
    return r


def imaging_paths() -> dict:
    """Phase 19: the medical and geospatial packages on cuda:0: every
    ported function on the card against the port on the CPU, the
    IMAGING_PATHS and GEO_PATHS at full width with the JAX tests'
    invariants."""
    import torch
    from njw_tpu_torch.geospatial.main_paths import GEO_PATHS
    from njw_tpu_torch.medical.main_paths import IMAGING_PATHS

    t0 = time.perf_counter()
    res = {"cpu_vs_card": _imaging_cpu_vs_card()}
    for name, p in {**IMAGING_PATHS, **GEO_PATHS}.items():
        res[name] = _imaging_path(name, p)
    torch.cuda.empty_cache()
    runs = {n: r["calls"] for n, r in res.items() if n != "cpu_vs_card"}
    seconds = time.perf_counter() - t0
    emit("imaging_summary", ok=True, seconds=seconds,
         budget_seconds=IMAGING_BUDGET_S,
         within_budget=seconds <= IMAGING_BUDGET_S,
         ms_per_call={n: {c: v["ms_per_call"] for c, v in cs.items()}
                      for n, cs in runs.items()},
         paced_by={n: {c: v["paced_by"] for c, v in cs.items()}
                   for n, cs in runs.items()})
    return res


# ------------------------------------------------------------ phase 20

FINANCE_CPU_TOL = 1e-4      # the card against the port on the CPU, normalised
VAR_REL = 0.01              # the 0.95 VaR against the Gaussian closed form
WEALTH_SE = 4.0             # mean terminal wealth: standard errors allowed
PARITY_ATOL = 1e-3          # put-call parity: tests/test_financial.py:199-204
DELTA_ATOL = 2e-3           # delta against N(d1): :206-214
TREE_REL = 5e-3             # the European tree at 400 steps: :216-218
MC_SE, MC_ABS = 4.0, 0.05   # the Monte-Carlo price: :227-231
MC_CHECK_PATHS = 200_000    # as the test
FINANCE_BUDGET_S = 30


def _finance_inputs() -> dict:
    """Seeded inputs of the card-against-CPU cases: a 48^2 DEM for the
    factors, a 256^2 DEM and 200 assets for the pipeline, 50 assets x
    20 000 normals for the Monte-Carlo transforms (drawn once on the
    CPU: the card and the CPU take the same normals), a 4 x 4 chain."""
    import numpy as np
    from njw_tpu_torch.geofinancial import generate_assets, generate_dem
    from njw_tpu_torch.geofinancial.main_paths import market
    from njw_tpu_torch.geofinancial.risk_metrics import standard_normals

    mean, cov, w, chol = market(50)
    k, t = np.meshgrid(np.linspace(80.0, 120.0, 4), np.linspace(0.25, 2.0, 4),
                       indexing="ij")
    n = k.size
    return {"dem48": generate_dem(48, seed=5),
            "dem256": generate_dem(256, seed=11),
            "port200": generate_assets(200, extent=256.0, seed=11),
            "mean": mean, "cov": cov, "w": w, "chol": chol,
            "z": standard_normals((20_000, 50), 1, "cpu"),
            "z1": standard_normals((20_000,), 2, "cpu"),
            "zp": standard_normals((80, 250), 3, "cpu"),
            "chain": (np.full(n, 100.0), k.ravel(), t.ravel(),
                      np.full(n, 0.05), np.full(n, 0.2))}


def _finance_cases() -> dict:
    """{name: (kind, run(device) -> list of arrays)}: every function of
    the geo-financial port that computes on a device. kind "equal" must
    match exactly, "ranking" in order, "norm" within FINANCE_CPU_TOL."""
    import numpy as np
    import njw_tpu_torch.geofinancial as G
    from njw_tpu_torch.geofinancial import options as O
    from njw_tpu_torch.geofinancial.main_paths import analysis, risk_model
    from njw_tpu_torch.geofinancial.portfolio import terminal_wealth
    from njw_tpu_torch.geofinancial.risk_metrics import portfolio_samples

    x = _finance_inputs()
    mean, cov, w, chol, chain = (x[k] for k in ("mean", "cov", "w", "chol",
                                                "chain"))
    pipe = {}

    def pipeline(dev):
        if dev not in pipe:
            model = risk_model(x["dem256"], dev)
            pipe[dev] = (model, analysis(x["port200"], model, 256.0))
        return pipe[dev]

    def sets(out):
        return [np.asarray([v["expected_loss"], v["worst_loss"],
                            *v["var"].values()])
                for v in out["scenario_sets"].values()]

    def mc(fn, z, *args, **kw):
        return lambda dev: [np.atleast_1d(np.asarray(v, np.float64))
                            for v in _values(fn(*args, normals=z.to(dev),
                                                **kw))]

    return {
        "slope_48": ("norm", lambda dev: [G.create_slope_risk_factor(
            x["dem48"], device=dev).risk_data]),
        "flood_48": ("equal", lambda dev: [G.create_flood_risk_factor(
            x["dem48"], device=dev).risk_data]),
        "pipeline_256_factors": ("equal", lambda dev: [
            rf.risk_data for rf in pipeline(dev)[0].risk_factors]),
        "pipeline_256_analysis": ("norm", lambda dev: [
            pipeline(dev)[1]["risks"],
            np.asarray([pipeline(dev)[1]["expected_loss"]]),
            *sets(pipeline(dev)[1])]),
        "pipeline_256_ranking": ("ranking", lambda dev: [
            name for name, _ in pipeline(dev)[1]["regions"]]),
        "portfolio_samples": ("norm", lambda dev: [portfolio_samples(
            x["z"].to(dev), mean, chol, w)]),
        "monte_carlo_var": ("norm", mc(G.monte_carlo_var, x["z"], mean=mean,
                                       cov=cov, weights=w, n_samples=20_000,
                                       return_cvar=True)),
        "terminal_wealth": ("norm", lambda dev: [terminal_wealth(
            x["z"].to(dev), w, mean, chol, 80, 250)]),
        "monte_carlo_simulation": ("norm", mc(
            G.monte_carlo_simulation, x["z"], w, mean=mean, cov=cov,
            n_paths=80, horizon=250)),
        "gbm_paths": ("norm", lambda dev: [O.gbm_paths(
            x["zp"].to(dev), 100.0, 1.0, 0.05, 0.2)]),
        "monte_carlo_price": ("norm", mc(G.monte_carlo_price, x["z1"], 100.0,
                                         100.0, 1.0, 0.05, 0.2,
                                         n_paths=20_000)),
        "barrier_option_price": ("norm", mc(
            G.barrier_option_price, x["zp"], 100.0, 100.0, 115.0, 1.0, 0.05,
            0.2, n_paths=80, n_steps=250)),
        "asian_option_price": ("norm", mc(
            G.asian_option_price, x["zp"], 100.0, 100.0, 1.0, 0.05, 0.2,
            n_paths=80, n_steps=250)),
        "black_scholes": ("norm", lambda dev: [
            G.black_scholes(*chain, kind, device=dev)
            for kind in ("call", "put")]),
        "greeks": ("norm", lambda dev: [
            v for kind in ("call", "put")
            for v in G.greeks(*chain, kind, device=dev).values()]),
        "binomial_tree": ("norm", lambda dev: [
            G.binomial_tree(*chain, n_steps=300, kind=kind, american=am,
                            device=dev)
            for kind in ("call", "put") for am in (False, True)]),
    }


def _values(out):
    """A result's numbers in order: a tuple, a dict's values, or one."""
    if isinstance(out, dict):
        return list(out.values())
    return list(out) if isinstance(out, tuple) else [out]


def _finance_cpu_vs_card() -> dict:
    """Every case of _finance_cases on the card against the CPU."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    out, bad = {}, []
    for name, (kind, run) in _finance_cases().items():
        card = [v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                for v in run("cuda")]
        cpu = [v.numpy() if isinstance(v, torch.Tensor) else v
               for v in run("cpu")]
        if kind == "ranking":
            ok = card == cpu
            out[name] = "identical" if ok else "differs"
        elif kind == "equal":
            ok = all(np.array_equal(a, b) for a, b in zip(card, cpu))
            out[name] = "equal" if ok else "differs"
        else:
            out[name] = max(_normalised_diff(
                torch.as_tensor(np.asarray(a, np.float64)),
                torch.as_tensor(np.asarray(b, np.float64)))
                for a, b in zip(card, cpu))
            ok = out[name] <= FINANCE_CPU_TOL
        if not ok or len(card) != len(cpu):
            bad.append(name)
    emit("finance_cpu_vs_card", ok=not bad, tol=FINANCE_CPU_TOL,
         results=out, failed=bad, seconds=time.perf_counter() - t0)
    if bad:
        fail("finance_cpu_vs_card", f"{bad}: the card and the CPU disagree")
    return out


def _finance_bytes(name: str, cname: str, c) -> float:
    """Bytes that one call must move: the draw's normals written once and
    read once (the Monte-Carlo calls), each input read once and each
    output written once (the chain, the DEM), none (the host's
    analysis)."""
    from njw_tpu_torch.geofinancial import main_paths as M

    n_opt = M.option_chain()[0].size
    if name.startswith("mc_var"):
        return 2 * 4 * c.work * 500
    if name.startswith("mc_wealth"):
        return 2 * 4 * c.work * 100
    if cname in ("barrier_up_out", "asian"):
        return 2 * 4 * c.work
    per_option = {"black_scholes": 5 + 2, "greeks": 5 + 5,
                  "american_put_tree": 5 + 1}
    if cname in per_option:
        return 4 * per_option[cname] * n_opt
    return 2 * 4 * M.N_DEM ** 2 if cname == "risk_model" else 0.0


def _var_invariants(name, d, outs) -> dict:
    """The 0.95 VaR within VAR_REL of -(w.mu + z_0.05 sqrt(w' S w)), and
    CVaR >= VaR at both confidences."""
    import numpy as np

    mu = float(d["weights"] @ d["mean"])
    sd = float(np.sqrt(d["weights"] @ d["cov"] @ d["weights"]))
    closed = -(mu - 1.6448536269514722 * sd)
    var95, cvar95 = outs["var_cvar_95"]
    var99, cvar99 = outs["var_cvar_99"]
    rel = abs(var95 / closed - 1)
    return {"var_95": var95, "var_95_closed_form": closed, "rel": rel,
            "rel_tol": VAR_REL, "var_99": var99, "cvar_95": cvar95,
            "cvar_99": cvar99,
            "ok": (rel <= VAR_REL or name != "mc_var_500x1m")
            and cvar95 >= var95 and cvar99 >= var99}


def _wealth_invariants(name, d, outs) -> dict:
    """Mean terminal wealth within WEALTH_SE standard errors of
    (1 + w.mu)^252, its expectation for independent days."""
    import numpy as np
    from njw_tpu_torch.geofinancial.main_paths import HORIZON

    sim = outs["simulate"]
    tw = sim["terminal_wealth"]
    expect = (1.0 + float(d["weights"] @ d["mean"])) ** HORIZON
    se = float(tw.std(ddof=1) / np.sqrt(tw.size))
    return {"mean": sim["mean"], "expected": expect, "stderr": se,
            "z": (sim["mean"] - expect) / se,
            "ok": abs(sim["mean"] - expect) <= WEALTH_SE * se}


def _chain_invariants(name, d, outs) -> dict:
    """Put-call parity, delta against N(d1), the American put at or above
    the European on the chain; the European tree at 400 steps and the
    Monte-Carlo price at the money against Black-Scholes; the barrier and
    the Asian between 0 and the vanilla call."""
    import numpy as np
    import njw_tpu_torch.geofinancial as G
    from njw_tpu_torch.geofinancial import main_paths as M

    s, k, t, r, sig = d["args"]
    call, put = outs["black_scholes"]
    parity = float(np.abs((call - put) - (s - k * np.exp(-r * t))).max())
    d1 = (np.log(s / k) + (r + 0.5 * sig ** 2) * t) / (sig * np.sqrt(t))
    n_d1 = np.array([0.5 * math.erfc(-v / math.sqrt(2.0)) for v in d1])
    delta = float(np.abs(outs["greeks"]["delta"] - n_d1).max())
    euro = G.binomial_tree(*d["args"], n_steps=M.TREE_STEPS, kind="put",
                           device=d["device"])
    american_excess = float((outs["american_put_tree"] - euro).min())
    van = G.black_scholes(100.0, 100.0, 1.0, M.RATE, M.VOL,
                          device=d["device"])
    tree400 = G.binomial_tree(100.0, 100.0, 1.0, M.RATE, M.VOL, n_steps=400,
                              device=d["device"])
    mc = G.monte_carlo_price(100.0, 100.0, 1.0, M.RATE, M.VOL,
                             n_paths=MC_CHECK_PATHS, device=d["device"])
    barrier, asian = outs["barrier_up_out"]["price"], outs["asian"]["price"]
    checks = {"parity_max_abs": parity <= PARITY_ATOL,
              "delta_vs_n_d1": delta <= DELTA_ATOL,
              "american_at_or_above_european": american_excess >= 0.0,
              "tree_400_vs_bs": abs(tree400 / van - 1) <= TREE_REL,
              "mc_vs_bs": abs(mc["price"] - van)
              <= MC_SE * mc["stderr"] + MC_ABS,
              "barrier_in_0_vanilla": 0.0 < barrier < van,
              "asian_in_0_vanilla": 0.0 < asian < van}
    return {"parity_max_abs": parity, "delta_max_abs": delta,
            "american_minus_european_min": american_excess,
            "bs_atm": van, "tree_400": tree400, "mc": mc,
            "barrier": outs["barrier_up_out"], "asian": outs["asian"],
            "checks": checks, "ok": all(checks.values())}


def _pipeline_invariants(name, d, outs) -> dict:
    """Risks in [0, 1], expected loss at most the total value, each set's
    scenario VaR monotone in its confidence."""
    a = outs["analysis"]
    risks = a["risks"]
    monotone = {n: list(v["var"].values()) == sorted(v["var"].values())
                for n, v in a["scenario_sets"].items()}
    checks = {"risks_in_0_1": bool((risks >= 0).all() and (risks <= 1).all()),
              "expected_loss_at_most_total":
                  0.0 <= a["expected_loss"] <= a["total_value"],
              "var_monotone": all(monotone.values())}
    return {"expected_loss": a["expected_loss"],
            "total_value": a["total_value"],
            "var": {n: v["var"] for n, v in a["scenario_sets"].items()},
            "regions_top3": a["regions"][:3], "checks": checks,
            "ok": all(checks.values())}


_FINANCE_INVARIANTS = {
    "mc_var_500x1m": _var_invariants, "mc_var_500x10k": _var_invariants,
    "mc_wealth_100x10k": _wealth_invariants,
    "options_chain_1024": _chain_invariants,
    "geofin_pipeline_2048": _pipeline_invariants,
}


def _kernel_sum_ms(fn) -> float:
    """``_device_ms`` read from the profiler's raw activity records: the
    summed time of the device's activities in one call of fn(). The same
    sum, without building the per-event tables of ``key_averages`` (17 s
    for the 84 000 kernels of geofin_pipeline_2048's risk model on the
    H100, PERF.md section 6)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6


def _finance_path(name: str, p) -> dict:
    """One FINANCE_PATHS entry at full width: its setup, each call
    (``_imaging_call``, with the bytes bound), the JAX tests' invariants."""
    import torch

    phase = f"finance_path_{name}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = p.setup(torch.device("cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    calls, outs = {}, {}
    for cname, c in p.calls.items():
        t1 = time.perf_counter()
        calls[cname], outs[cname] = _imaging_call(c, d, _kernel_sum_ms)
        calls[cname]["seconds"] = time.perf_counter() - t1
        n_bytes = _finance_bytes(name, cname, c)
        calls[cname]["bound_bytes"] = n_bytes
        calls[cname]["bound_ms"] = (roofline_ms(n_bytes, 0.0)[0]
                                    if n_bytes else None)
    t1 = time.perf_counter()
    inv = _FINANCE_INVARIANTS[name](name, d, outs)
    ok = inv["ok"] and all(r["finite"] and r["kernel_launches_total"] == 0
                           for r in calls.values())
    r = {"source": p.source, "setup_seconds": setup_s, "calls": calls,
         "invariant": inv, "invariant_seconds": time.perf_counter() - t1,
         "seconds": time.perf_counter() - t0}
    emit(phase, ok=ok, **r)
    if not ok:
        fail(phase, "non-finite output, a kernel of the port launched, or "
             "the invariant does not hold")
    del d, outs
    return r


def finance_paths() -> dict:
    """Phase 20: the geo-financial package on cuda:0: every ported
    function that computes on a device on the card against the port on
    the CPU, every FINANCE_PATHS entry at full width with the JAX tests'
    invariants."""
    import torch
    from njw_tpu_torch.geofinancial.main_paths import FINANCE_PATHS

    t0 = time.perf_counter()
    res = {"cpu_vs_card": _finance_cpu_vs_card()}
    for name, p in FINANCE_PATHS.items():
        res[name] = _finance_path(name, p)
    torch.cuda.empty_cache()
    runs = {n: r["calls"] for n, r in res.items() if n != "cpu_vs_card"}
    seconds = time.perf_counter() - t0
    emit("finance_summary", ok=True, seconds=seconds,
         budget_seconds=FINANCE_BUDGET_S,
         within_budget=seconds <= FINANCE_BUDGET_S,
         ms_per_call={n: {c: v["ms_per_call"] for c, v in cs.items()}
                      for n, cs in runs.items()},
         device_ms_per_call={n: {c: v["device_ms_per_call"]
                                 for c, v in cs.items()}
                             for n, cs in runs.items()},
         paced_by={n: {c: v["paced_by"] for c, v in cs.items()}
                   for n, cs in runs.items()})
    return res


SUITE_BUDGET_S = 40
SUITE_CPU_TOL = 1e-4        # the weather workload on the card against the CPU
NATIVE_RTOL = 1e-4          # native SWE against RK4: tests/test_native.py:29-30
NATIVE_ATOL = {"h": 1e-5, "u": 1e-4, "v": 1e-4}
# njw_tpu/bench/suite.py:25-41, the fields proto/dashboard.proto's
# BenchmarkResult carries (njw_tpu/dashboard/schema.py:57-74)
JAX_RESULT_FIELDS = ("workload", "device", "execution_time_s", "throughput",
                     "throughput_unit", "memory_bytes", "additional_metrics",
                     "cost_metrics", "timestamp")
SUITE_KERNELS = {"weather": ("swe_rk4", "steps_per_repeat"),
                 "signal": ("fir_band", "applications_per_repeat")}
SUITE_REPEATS = 6           # run(): warm 1 and 2, timed 1 and 2


def _suite_run(out_dir: str) -> tuple:
    """``python -m njw_tpu_torch.bench --all`` in this process at the
    suite's defaults on cuda, with the H100's cost model and the report:
    (the result rows, the launch counts of the run)."""
    import os

    from njw_tpu_torch.bench.__main__ import main as bench_main

    cost = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "cloud_gpu_h100.yaml")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = bench_main(["--all", "--device", "cuda", "--cost-config", cost,
                         "--output-dir", out_dir, "--report"])
    launched = counts()
    if rc != 0:
        fail("suite", f"python -m njw_tpu_torch.bench --all returned {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")], launched


def _suite_checks(rows: list, launched: dict) -> dict:
    """Each row's keys, throughput and launches: K1 on the weather
    workload and K7 on the signal workload, SUITE_REPEATS x a repeat's
    work each (warm-ups included), nothing else anywhere."""
    from njw_tpu_torch.bench import BenchmarkResult

    fields = tuple(f.name for f in dataclasses.fields(BenchmarkResult))
    want_total = dict.fromkeys(launched, 0)
    checks = {}
    for r in rows:
        kernel, unit_key = SUITE_KERNELS.get(r["workload"], (None, None))
        want = dict.fromkeys(launched, 0)
        if kernel:
            want[kernel] = SUITE_REPEATS * r["additional_metrics"][unit_key]
            want_total[kernel] += want[kernel]
        checks[r["workload"]] = {
            "keys": tuple(r) == JAX_RESULT_FIELDS == fields,
            "throughput": math.isfinite(r["throughput"])
            and r["throughput"] > 0,
            "launches": r["additional_metrics"]["kernel_launches"] == want,
            "cost": r["cost_metrics"].get("hourly_rate") == 6.98}
    names = [r["workload"] for r in rows]
    checks["run"] = {"six_workloads": names == [
        "weather", "nbody", "molecular_dynamics", "signal", "medical",
        "geospatial"], "launches": launched == want_total}
    return checks


def _suite_weather_vs_cpu() -> dict:
    """The weather workload's state after execute(repeats=1) on the card
    against the same run on the CPU (normalised by field)."""
    from njw_tpu_torch.bench import WeatherBenchmark

    states = {}
    for dev in ("cuda", "cpu"):
        b = WeatherBenchmark(device=dev)
        sim = b.setup()
        b.execute(sim, 1)
        states[dev] = sim.state
    diff = {n: _normalised_diff(t.cpu(), getattr(states["cpu"], n))
            for n, t in states["cuda"].items()}
    return {"steps": b.num_steps * b.INNER, "normalised_diff": diff,
            "tol": SUITE_CPU_TOL,
            "ok": all(d <= SUITE_CPU_TOL for d in diff.values())}


def _suite_signal_vs_plain() -> dict:
    """One application of the signal workload's filter (a K7 launch)
    against the kernel's plain version on the same input (phase 8's
    tolerances)."""
    import torch
    from njw_tpu_torch.bench import SignalBenchmark

    b = SignalBenchmark(device="cuda")
    x, filt = b.setup()
    y = filt.apply(x)
    torch.cuda.synchronize()
    check, agrees = _fir_vs_plain(y, x, filt.taps, 3)
    del x, y
    return {**check, "ok": agrees}


def _suite_transfers() -> dict:
    """chunked_device_put and DeviceMemoryManager (to_device, copy,
    to_host, free) on cuda, bit for bit, and the device's memory stats."""
    import numpy as np
    import torch
    from njw_tpu_torch.interop import DeviceMemoryManager, chunked_device_put

    x = np.random.default_rng(21).standard_normal((4096, 1024),
                                                  dtype=np.float32)
    t = chunked_device_put(x, chunk_bytes=1 << 20, device="cuda")
    put_ok = t.is_cuda and np.array_equal(t.cpu().numpy(), x)
    with DeviceMemoryManager("cuda") as mgr:
        mgr.to_device("x", x).wait()
        mgr.copy("x", "y").wait()
        back = mgr.to_host("y").wait()
        tracked = mgr.allocated_bytes
        mgr.free("x")
        stats = mgr.memory_stats()
        freed = stats["tracked_buffers"] == 1 and \
            stats["tracked_bytes"] == x.nbytes
    mgr_ok = np.array_equal(back, x) and tracked == 2 * x.nbytes and freed
    del t
    torch.cuda.empty_cache()
    keep = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
            "reserved_bytes.all.current", "num_alloc_retries",
            "tracked_buffers", "tracked_bytes")
    return {"chunked_device_put": put_ok, "device_memory_manager": mgr_ok,
            "bytes": x.nbytes, "memory_stats": {k: stats.get(k) for k in keep},
            "ok": put_ok and mgr_ok}


def _suite_time_jitted() -> dict:
    """utils.profiling.time_jitted on one K1 step at the suite's 512^2."""
    import torch
    from njw_tpu_torch.ops import launch_counts
    from njw_tpu_torch.ops.stencil import swe_rk4_step
    from njw_tpu_torch.utils.profiling import time_jitted
    from njw_tpu_torch.weather import GridSpec

    grid = GridSpec(nx=512, ny=512)
    f = [torch.full((512, 512), v, device="cuda") for v in (0.1, 0.2, 10.0)]
    before = launch_counts()["swe_rk4"]
    t = time_jitted(swe_rk4_step, *f, grid=grid, dt=0.005, coriolis_f=1e-4,
                    repeats=20)
    k1 = launch_counts()["swe_rk4"] - before
    return {**t, "k1_launches": k1, "ok": t["best_s"] > 0 and k1 == 21}


def _suite_native() -> dict:
    """The native host library's SWE RK4 on 256^2 against the port's
    plain RK4 on the CPU, or why it did not load."""
    import numpy as np
    import torch
    from njw_tpu_torch import native
    from njw_tpu_torch.ops.stencil import swe_rk4_step_plain
    from njw_tpu_torch.weather import GridSpec

    if not native.available():
        print(f"native library: {native.load_error()}", flush=True)
        return {"available": False, "load_error": native.load_error(),
                "ok": True}
    rng = np.random.default_rng(0)
    n = 256
    u = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    v = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    h = (10 + rng.normal(0, 0.1, (n, n))).astype(np.float32)
    out = native.swe_rk4_run(u, v, h, dt=0.01, n_steps=20, coriolis_f=1e-4)
    ref = tuple(torch.from_numpy(a) for a in (u, v, h))
    for _ in range(20):
        ref = swe_rk4_step_plain(*ref, grid=GridSpec(nx=n, ny=n), dt=0.01,
                                 coriolis_f=1e-4)
    err, ok = {}, True
    for name, a, b in zip("uvh", out, ref):
        b = b.numpy()
        err[name] = float(np.abs(a - b).max())
        ok &= bool(np.allclose(a, b, rtol=NATIVE_RTOL,
                               atol=NATIVE_ATOL[name]))
    return {"available": True, "max_abs_err": err, "rtol": NATIVE_RTOL,
            "atol": NATIVE_ATOL, "omp_threads": native.load().omp_thread_count(),
            "ok": ok}


def suite_paths() -> dict:
    """Phase 21: the benchmark suite (``python -m njw_tpu_torch.bench
    --all``) at its defaults on cuda, each result checked; the weather
    workload against the CPU, the signal workload's K7 against its plain
    version; the interop transfers, time_jitted and the native oracle."""
    import os
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="njw_suite_")
    try:
        rows, launched = _suite_run(out_dir)
        report = sorted(os.listdir(out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in rows:
        emit("suite_result", **r)
    checks = _suite_checks(rows, launched)
    part_seconds = {"suite_run": time.perf_counter() - t0}
    parts = {}
    for name, part in (("weather_vs_cpu", _suite_weather_vs_cpu),
                       ("signal_vs_plain", _suite_signal_vs_plain),
                       ("transfers", _suite_transfers),
                       ("time_jitted", _suite_time_jitted),
                       ("native", _suite_native)):
        t1 = time.perf_counter()
        parts[name] = part()
        part_seconds[name] = time.perf_counter() - t1
    seconds = time.perf_counter() - t0
    ok = all(all(c.values()) for c in checks.values()) and all(
        p["ok"] for p in parts.values())
    emit("suite", ok=ok, seconds=seconds, budget_seconds=SUITE_BUDGET_S,
         within_budget=seconds <= SUITE_BUDGET_S, part_seconds=part_seconds,
         script_seconds=time.perf_counter() - SCRIPT_T0, launches=launched,
         report_files=report, checks=checks, **parts,
         throughput={r["workload"]: [r["throughput"], r["throughput_unit"]]
                     for r in rows},
         execution_time_s={r["workload"]: r["execution_time_s"]
                           for r in rows})
    if not ok:
        fail("suite", "a check of the benchmark suite failed (see checks "
             "and each part's ok)")
    return {"rows": rows, "launches": launched, **parts}


# ------------------------------------------------------------ phase 22

EXAMPLES_BUDGET_S = 60
SWE_EXAMPLE_STEPS = 500     # the example's default run: one K1 launch a step
SWE_EXAMPLE_CPU_STEPS = 50  # its final h on the card against the CPU's
EXAMPLE_CPU_TOL = 1e-4      # normalised, the card against the port on the CPU
NBODY_E0_REL = 1e-5         # the galaxy's initial energy, card against CPU
# The galaxy's leapfrog energy drift over the example's 200 steps: the
# two-body bound of tests/test_nbody.py:89-99 (1e-4) does not hold for this
# disk even on the CPU (1.25e-4 there, the port); 10x that CPU figure.
NBODY_DRIFT = 1.25e-3
MD_DRIFT = 0.05             # NVE energy drift: tests/test_md.py:110-118
MD_T_BAND = (0.7, 2.0)      # a thermostat's temperature: :121-127
ICO_TC2 = 2e-3              # icosahedral TC2 drift: test_weather_icosa.py:163
SPEC_TC2 = 1e-5             # spectral TC2 drift: test_weather_spherical.py:207
BS_CALL = 10.450583572185565  # Black-Scholes, S = K = 100, T 1, r 0.05, s 0.2
BS_DELTA = 0.6368306511756191  # N(d1) of the same call
OPTION_ATOL = 1e-3          # the float32 closed form against float64
CHIRP = (20.0, 60.0)        # the wavelet example's f(t) = 20 + 60 t Hz
RISK_GRID_TOL = 1e-4        # the dashboard's risk grid, card against CPU
HILLSHADE_ATOL = 1e-6       # tests/test_torch_viz.py's, card against CPU
VIZ_DEM = 256               # the views' DEM (their CPU half is the cost)
# njw_tpu_torch.examples: (module, arguments beside --device cuda) at the
# defaults of each; the financial example's efficient frontier is a host
# NumPy solver (~60 s at its 50 assets on a CPU core), so it runs at 10
EXAMPLE_RUNS = (
    ("shallow_water_example", ()),
    ("nbody_example", ()),
    ("lj_fluid_example", ()),
    ("ct_reconstruction_example", ("--json",)),
    ("mri_reconstruction_example", ()),
    ("image_registration_example", ("--json",)),
    ("wavelet_transform_example", ()),
    ("viewshed_analysis", ("--json",)),
    ("global_cores_example", ()),
    ("financial_modeling_example", ("--json", "--assets", "10")),
    ("geofinancial_example", ("--json",)),
    ("geofinancial_example", ("--json", "--dem-size", "2048",
                              "--assets", "10000")),   # geofin_pipeline_2048
)
NO_OUTPUT_DIR = {"wavelet_transform_example", "global_cores_example",
                 "financial_modeling_example"}


def _run_example(name: str, args, out_dir=None, device="cuda") -> tuple:
    """``njw_tpu_torch.examples.<name>.main`` in this process: (its
    standard output, wall seconds, the launch counts of the run)."""
    import importlib

    mod = importlib.import_module(f"njw_tpu_torch.examples.{name}")
    argv = list(args) + ["--device", device]
    if out_dir is not None and name not in NO_OUTPUT_DIR:
        argv += ["--output-dir", out_dir]
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    seconds = time.perf_counter() - t0
    launched = counts()
    if rc != 0:
        fail("examples", f"{name} {' '.join(argv)} returned {rc}")
    return buf.getvalue(), seconds, launched


def _printed_json(text: str) -> list:
    """The JSON documents an example printed (one a line, or the whole
    output when it is one indented document)."""
    try:
        return [json.loads(text)]
    except json.JSONDecodeError:
        return [json.loads(ln) for ln in text.splitlines()
                if ln.startswith("{") and ln.rstrip().endswith("}")
                and not ln.startswith("{'")]


def _fin(x) -> bool:
    return x is not None and math.isfinite(x)


def _swe_example_checks(text, launched) -> dict:
    """K1 once a step; the final h of the example's run at 50 steps on the
    card against the same run on the CPU (the plain path)."""
    import ast

    from njw_tpu_torch.examples import shallow_water_example as ex

    metrics = ast.literal_eval(text.strip().splitlines()[-1])
    h = {}
    for dev in ("cuda", "cpu"):
        sim = ex.simulate(ex.parse_args(["--steps",
                                         str(SWE_EXAMPLE_CPU_STEPS),
                                         "--device", dev]))
        h[dev] = sim.state.h.cpu()
    diff = _normalised_diff(h["cuda"], h["cpu"])
    return {"num_steps": metrics["num_steps"] == SWE_EXAMPLE_STEPS,
            "k1_once_a_step": launched["swe_rk4"] == SWE_EXAMPLE_STEPS,
            "finite": bool(h["cuda"].isfinite().all()),
            "h_vs_cpu": diff <= EXAMPLE_CPU_TOL}, {
                "h_vs_cpu_normalised": diff, "tol": EXAMPLE_CPU_TOL,
                "mcups": metrics["mcups"]}


def _nbody_example_checks(text, launched):
    """The galaxy's initial energy against the same system's on the CPU;
    its energy drift finite and within NBODY_DRIFT."""
    from njw_tpu_torch.nbody import create_galaxy_model
    from njw_tpu_torch.nbody.system import system_diagnostics

    (r,) = _printed_json(text)
    e0 = float(system_diagnostics(create_galaxy_model(
        r["n"], device="cpu"))["total_energy"])
    rel = abs(r["energy_initial"] / e0 - 1)
    return {"n": r["n"] == 10_000,
            "energy_initial_vs_cpu": rel <= NBODY_E0_REL,
            "energy_drift": _fin(r["energy_drift"])
            and r["energy_drift"] < NBODY_DRIFT}, {
                "energy_drift": r["energy_drift"], "tol": NBODY_DRIFT,
                "energy_initial_rel_vs_cpu": rel,
                "ms_per_step": r["ms_per_step"]}


def _lj_example_checks(text, launched):
    (r,) = _printed_json(text)
    lo, hi = MD_T_BAND
    return {"nve_drift": _fin(r["nve_energy_drift"])
            and r["nve_energy_drift"] < MD_DRIFT,
            "thermostat": lo < r["T_after_equil"] < hi,
            "production_T": _fin(r["T_production_mean"])}, {
                "nve_energy_drift": r["nve_energy_drift"],
                "T_after_equil": r["T_after_equil"],
                "ms_per_step": r["ms_per_step"]}


def _ct_example_checks(text, launched):
    """Every PSNR finite; the example's phantom through radon and FBP on
    the card correlates with it by FBP_CORR (phase 19's check) and gives
    the FBP PSNR the example printed at noise 0."""
    import numpy as np
    from njw_tpu_torch.examples import ct_reconstruction_example as ex
    from njw_tpu_torch.medical import filtered_backprojection, radon

    (r,) = _printed_json(text)
    img = ex.shepp_logan_like(256)
    angles = np.linspace(0, np.pi, 180, endpoint=False)
    fbp = filtered_backprojection(radon(img, angles, device="cuda"),
                                  angles).cpu().numpy()
    corr = _corr(fbp, img)
    (row,) = r["rows"]
    return {"psnr_finite": _fin(row["fbp_psnr_db"])
            and _fin(row["sirt_psnr_db"]),
            "fbp_corr": corr >= FBP_CORR,
            "printed_psnr": round(ex.psnr(fbp, img), 2)
            == row["fbp_psnr_db"]}, {"fbp_corr": corr, "row": row}


def _mri_example_checks(text, launched):
    """Each acceleration samples between 1/R and 1/R + the centre's 8%;
    CG-SENSE improves on zero-filling at R = 2; every PSNR finite."""
    rows = _printed_json(text)
    sampled = all(1.0 / r["acceleration"] <= r["sampled_fraction"]
                  <= 1.0 / r["acceleration"] + 0.08 + 1e-3 for r in rows)
    return {"accelerations": [r["acceleration"] for r in rows] == [2, 4],
            "sampled_fraction": sampled,
            "cg_beats_zero_filled_r2": rows[0]["psnr_cg_sense"]
            > rows[0]["psnr_zero_filled"],
            "finite": all(_fin(v) for r in rows for v in r.values())}, {
                "rows": rows}


def _registration_example_checks(text, launched):
    """The rigid stage lowers its loss and the RMSE against the fixed
    image (the deformable stage at the example's bump is a reference
    behaviour: ROADMAP.md section 3)."""
    (r,) = _printed_json(text)
    rg = r["rigid"]
    return {"rigid_loss_falls": rg["loss_last"] < rg["loss_first"],
            "rigid_rmse_falls": rg["rmse_after"] < rg["rmse_before"],
            "deformable_finite": _fin(r["deformable"]["rmse_after"])}, {
                "rigid": rg, "deformable": r["deformable"]}


def _wavelet_example_checks(text, launched):
    """The chirp's ridge at the first and last spectrogram frames within
    two bins of f(t) = 20 + 60 t; the printed lines equal the CPU's."""
    import re

    cpu, _, _ = _run_example("wavelet_transform_example", (), device="cpu")
    lo, hi = (float(v) for v in re.search(
        r"chirp ridge: (\S+) Hz -> (\S+) Hz", text).groups())
    fs, nperseg = 1000.0, 256
    hop = nperseg // 2
    n_frames = (4096 - nperseg) // hop + 1
    t0 = (nperseg / 2) / fs
    t1 = (nperseg / 2 + (n_frames - 1) * hop) / fs
    f0, f1 = (CHIRP[0] + CHIRP[1] * t for t in (t0, t1))
    tol = 2 * fs / nperseg
    return {"ridge_start": abs(lo - f0) <= tol,
            "ridge_end": abs(hi - f1) <= tol,
            "scalogram_shape": "scalogram shape: (32, 4096)" in text,
            "same_as_cpu": text == cpu}, {"ridge_hz": [lo, hi],
                                          "chirp_hz": [f0, f1]}


def _viewshed_example_checks(text, launched):
    import os

    (r,) = _printed_json(text)
    fr = [v["visible_fraction"] for v in r["viewsheds"]]
    n = r["size"]
    return {"fractions": all(0.0 <= f <= 1.0 for f in fr),
            "union": max(fr) <= r["union_visible_fraction"] <= 1.0,
            "upstream": 1 <= r["max_upstream_cells"] <= n * n,
            "slope": 0.0 <= r["mean_slope_deg"] <= 90.0,
            "report": os.path.exists(r["report"])}, {
                "union_visible_fraction": r["union_visible_fraction"],
                "max_upstream_cells": r["max_upstream_cells"],
                "timings": r["timings"]}


def _global_example_checks(text, launched):
    (r,) = _printed_json(text)
    sp, ico = r["spectral"], r["icosahedral"]
    return {"spectral_tc2": sp["rel_l2_h_drift"] < SPEC_TC2,
            "icosahedral_tc2": ico["rel_l2_h_drift"] < ICO_TC2}, {
                "spectral": sp, "icosahedral": ico}


def _financial_example_checks(text, launched):
    """The Monte-Carlo VaR against the Gaussian closed form (VAR_REL,
    phase 20's check); the option prices against their closed forms and
    bounds; the simulated wealth's quantiles ordered."""
    (r,) = _printed_json(text)
    rm, op = r["risk_metrics"], r["options"]
    mc = r["optimization"]["mc_simulation"]
    var_rel = abs(rm["var_monte_carlo_95"] / rm["var_parametric_95"] - 1)
    geo = r["geo_portfolio"]
    return {"mc_var_vs_gaussian": var_rel <= VAR_REL,
            "var_positive": all(rm[k] > 0 for k in (
                "var_historical_95", "var_parametric_95", "cvar_95")),
            "bs_call": abs(op["bs_call"] - BS_CALL) <= OPTION_ATOL,
            "delta": abs(op["delta"] - BS_DELTA) <= DELTA_ATOL,
            "exotics_under_vanilla": 0.0 <= op["barrier_up_out"]
            <= op["bs_call"] and 0.0 <= op["asian_call"] <= op["bs_call"],
            "american_put_over_intrinsic":
                op["binomial_american_put"] >= 10.0,
            "wealth": mc["q05"] <= mc["mean"] and 0 <= mc["prob_loss"] <= 1,
            "geo": geo["n_assets_held"] >= 1
            and 0 <= geo["mean_geo_risk_all"] <= 1}, {
                "mc_var_over_gaussian_minus_1": var_rel, "options": op}


def _geofin_example_checks(text, launched):
    """Expected loss at most the total value, each scenario set's VaR
    monotone in its confidence (phase 20's checks), the report's tables."""
    import os

    (r,) = _printed_json(text)
    monotone = all(list(s["var"].values()) == sorted(s["var"].values())
                   for s in r["scenario_sets"].values())
    with open(r["report"]) as fh:
        page = fh.read()
    return {"expected_loss": 0.0 <= r["expected_loss"] <= r["total_value"],
            "var_monotone": monotone,
            "worst_over_expected": all(
                s["worst_loss"] >= s["expected_loss"]
                for s in r["scenario_sets"].values()),
            "report": os.path.exists(r["report"])
            and "expected loss" in page}, {
                "assets": r["assets"], "expected_loss": r["expected_loss"],
                "total_value": r["total_value"]}


_EXAMPLE_CHECKS = {
    "shallow_water_example": _swe_example_checks,
    "nbody_example": _nbody_example_checks,
    "lj_fluid_example": _lj_example_checks,
    "ct_reconstruction_example": _ct_example_checks,
    "mri_reconstruction_example": _mri_example_checks,
    "image_registration_example": _registration_example_checks,
    "wavelet_transform_example": _wavelet_example_checks,
    "viewshed_analysis": _viewshed_example_checks,
    "global_cores_example": _global_example_checks,
    "financial_modeling_example": _financial_example_checks,
    "geofinancial_example": _geofin_example_checks,
}


def _examples(out_root: str) -> dict:
    """Each example at its defaults on cuda, in this process; its checks;
    every launch count 0 but K1's 500 in the shallow-water run."""
    import os

    results = {}
    for i, (name, args) in enumerate(EXAMPLE_RUNS):
        out_dir = os.path.join(out_root, f"{i:02d}_{name}")
        text, seconds, launched = _run_example(name, args, out_dir)
        want = dict.fromkeys(launched, 0)
        if name == "shallow_water_example":
            want["swe_rk4"] = SWE_EXAMPLE_STEPS
        checks, numbers = _EXAMPLE_CHECKS[name](text, launched)
        checks = {k: bool(v) for k, v in checks.items()}
        checks["launches"] = launched == want
        key = name if name not in results else f"{name}_2048"
        emit("example_result", example=key, args=list(args),
             ok=all(checks.values()), seconds=seconds,
             k1_launches=launched["swe_rk4"],
             k7_launches=launched["fir_band"], launches=launched,
             checks=checks, **numbers,
             not_drawn=[ln for ln in text.splitlines()
                        if "plots not drawn" in ln])
        if not all(checks.values()):
            fail("examples", f"{key}: a check failed: {checks}")
        results[key] = {"seconds": seconds, "launches": launched}
    return results


def _get_ms(url: str) -> tuple:
    """(status, body, ms) of one GET."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def _sse_event(server) -> tuple:
    """One Server-Sent Event read after a publish: (event, ms)."""
    import threading
    import urllib.request

    got = {}

    def read():
        with urllib.request.urlopen(server.url + "/api/stream",
                                    timeout=30) as resp:
            while True:
                line = resp.readline()
                if not line:
                    return
                if line.startswith(b"data:"):
                    got["event"] = json.loads(line[5:].decode())
                    got["t"] = time.perf_counter()
                    return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    server.publish({"type": "chip_smoke", "phase": 22})
    t.join(timeout=30)
    if "event" not in got:
        fail("dashboard", "no Server-Sent Event after a publish")
    return got["event"], (got["t"] - t0) * 1e3


def _dashboard(rows: list, out_root: str) -> dict:
    """The dashboard on 127.0.0.1, port 0, on cuda: phase 21's rows and
    the --demo-geofin views; every endpoint once, with its ms."""
    import os

    import numpy as np
    from njw_tpu_torch.dashboard import DashboardServer
    from njw_tpu_torch.dashboard.server import demo_geofin

    path = os.path.join(out_root, "results.json")
    with open(path, "w") as fh:
        json.dump(rows, fh)
    geofin, _ = demo_geofin("cuda")
    cpu_geofin, _ = demo_geofin("cpu")
    server = DashboardServer(path, port=0, geofin=geofin,
                             device="cuda").start()
    try:
        ms, bodies = {}, {}
        for route in ("/api/results", "/api/workloads", "/api/cluster",
                      "/api/history", "/api/schema", "/api/geofin/portfolio",
                      "/api/geofin/riskmap", "/api/geofin/scenarios", "/",
                      "/cluster", "/perf", "/geofin", "/nope"):
            status, body, ms[route] = _get_ms(server.url + route)
            bodies[route] = (status, body)
        event, ms["/api/stream"] = _sse_event(server)
    finally:
        server.stop()
    ok_status = {r: s == (404 if r == "/nope" else 200)
                 for r, (s, _) in bodies.items()}
    js = {r: json.loads(b) for r, (s, b) in bodies.items()
          if r.startswith("/api/") and s == 200}
    cluster = js["/api/cluster"]
    grid, _ = geofin.risk_grid(128, 128)
    cpu_grid, _ = cpu_geofin.risk_grid(128, 128)
    raw_diff = float(np.abs(grid - cpu_grid).max())
    served = np.asarray(js["/api/geofin/riskmap"]["grid"])
    served_diff = float(np.abs(served - cpu_grid).max())
    checks = {
        "status": all(ok_status.values()),
        "results": [r["workload"] for r in js["/api/results"]]
        == [r["workload"] for r in rows]
        and all(set(JAX_RESULT_FIELDS) <= set(r)
                for r in js["/api/results"]),
        "workloads": js["/api/workloads"]
        == sorted({r["workload"] for r in rows}),
        "cluster_card": cluster["platform"] == "cuda"
        and cluster["generation"] == "sm_90"
        and cluster["total_runs"] == len(rows),
        "history": len(js["/api/history"]) == len({r["workload"]
                                                   for r in rows}),
        "schema": "BenchmarkResultRow" in js["/api/schema"],
        "portfolio": js["/api/geofin/portfolio"]
        == json.loads(json.dumps(cpu_geofin.portfolio_view())),
        "scenarios": js["/api/geofin/scenarios"]
        == json.loads(json.dumps(cpu_geofin.scenario_view())),
        "risk_grid_vs_cpu": raw_diff <= RISK_GRID_TOL,
        "served_grid_vs_cpu": served_diff <= RISK_GRID_TOL + 5e-5,
        "pages": all(b"<html" in bodies[p][1].lower()
                     for p in ("/", "/cluster", "/perf", "/geofin")),
        "sse": event == {"type": "chip_smoke", "phase": 22},
    }
    checks = {k: bool(v) for k, v in checks.items()}
    emit("dashboard", ok=all(checks.values()), ms=ms, checks=checks,
         cluster={k: cluster[k] for k in (
             "platform", "generation", "num_devices", "hbm_gb",
             "hbm_bandwidth_gbps", "peak_bf16_tflops", "total_runs")},
         risk_grid_max_abs_vs_cpu=raw_diff,
         served_grid_max_abs_vs_cpu=served_diff, tol=RISK_GRID_TOL)
    if not all(checks.values()):
        fail("dashboard", f"a dashboard check failed: {checks}")
    return {"ms": ms}


def _viz(out_root: str) -> dict:
    """hillshade on the card's DEM against the CPU; both reports' tables
    built on the card equal to the CPU's; a view draws with matplotlib and
    raises its named ImportError without it."""
    import os

    import numpy as np
    import torch
    from njw_tpu_torch.geofinancial import geo_risk, scenarios, testdata
    from njw_tpu_torch.geospatial.dem import DEMProcessor
    from njw_tpu_torch.viz import show_image
    from njw_tpu_torch.viz._common import have_matplotlib
    from njw_tpu_torch.viz.geofinancial import generate_geofin_report
    from njw_tpu_torch.viz.geospatial import (
        generate_geospatial_report, hillshade,
    )

    n = VIZ_DEM
    dem = testdata.generate_dem(n, seed=3)
    card = torch.from_numpy(dem).cuda()
    shade = np.abs(hillshade(card) - hillshade(dem)).max()
    pages = {}
    for dev in ("cuda", "cpu"):
        d = torch.from_numpy(dem).to(dev)
        proc = DEMProcessor(d, device=dev)
        vis = proc.viewshed((n // 2, n // 2),
                            observer_height=10.0).cpu().numpy()
        flow = proc.hydrology()["flow_accumulation"].cpu().numpy()
        metrics = {"visible_fraction": float(vis.mean()),
                   "max_upstream_cells": float(flow.max()),
                   "cells": float(dem.size)}
        geo = generate_geospatial_report(
            os.path.join(out_root, f"geo_{dev}"), d, visible=vis,
            observer_xy=(n // 2, n // 2), flow_acc=flow, metrics=metrics)
        model = geo_risk.GeospatialRiskModel([
            geo_risk.create_flood_risk_factor(d),
            geo_risk.create_elevation_risk_factor(d, weight=0.5)])
        port = testdata.generate_assets(200, extent=float(n), seed=3)
        fin = generate_geofin_report(
            os.path.join(out_root, f"fin_{dev}"), port, model,
            scenarios=scenarios.create_climate_scenarios())
        pages[dev] = [open(p).read() for p in (geo, fin)]
    draws = have_matplotlib()
    if draws:
        png = os.path.join(out_root, "view.png")
        show_image(card[:64, :64], path=png)
        plotted = os.path.getsize(png) > 0
        named = True
    else:
        plotted = True
        try:
            show_image(card[:64, :64])
            named = False
        except ImportError as e:
            named = "matplotlib" in str(e)
    checks = {"hillshade_vs_cpu": shade <= HILLSHADE_ATOL,
              "geospatial_report": pages["cuda"][0] == pages["cpu"][0]
              and "<table" in pages["cuda"][0],
              "geofin_report": pages["cuda"][1] == pages["cpu"][1]
              and "expected loss" in pages["cuda"][1],
              "view_draws": plotted, "named_import_error": named}
    checks = {k: bool(v) for k, v in checks.items()}
    emit("viz", ok=all(checks.values()), checks=checks,
         hillshade_max_abs_vs_cpu=float(shade), tol=HILLSHADE_ATOL,
         matplotlib=draws)
    if not all(checks.values()):
        fail("viz", f"a viz check failed: {checks}")
    return checks


def examples_paths(rows: list) -> dict:
    """Phase 22: the examples (njw_tpu_torch.examples) at their defaults on
    cuda, the dashboard on phase 21's rows and the demo's geo-financial
    views, and the views (njw_tpu_torch.viz)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    out_root = tempfile.mkdtemp(prefix="njw_examples_")
    part_seconds = {}
    try:
        parts = {}
        for name, part in (("examples", lambda: _examples(out_root)),
                           ("dashboard", lambda: _dashboard(rows, out_root)),
                           ("viz", lambda: _viz(out_root))):
            t1 = time.perf_counter()
            parts[name] = part()
            part_seconds[name] = time.perf_counter() - t1
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    emit("examples", ok=True, seconds=seconds,
         budget_seconds=EXAMPLES_BUDGET_S,
         within_budget=seconds <= EXAMPLES_BUDGET_S,
         part_seconds=part_seconds,
         example_seconds={n: r["seconds"]
                          for n, r in parts["examples"].items()},
         endpoint_ms=parts["dashboard"]["ms"],
         script_seconds=time.perf_counter() - SCRIPT_T0)
    return parts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import njw_tpu_torch  # noqa: F401  (fails outside the repository)

    global SCRIPT_T0
    SCRIPT_T0 = time.perf_counter()
    card = toolchain()
    build()
    k1 = kernels_vs_plain()
    k3 = baro_kernel()
    k5 = pe_kernel()
    k4 = pe_rk4_kernel()
    parity_gate()
    parity_cores()
    oracle_cores()
    m1 = main_path()
    m3 = main_path_baro()
    m5 = main_path_pe()
    m4 = main_path_pe(whole_step=True)
    cli()
    k7 = fir_kernel()
    k8 = fir_bf16_kernel()
    m7 = main_path_fir("fir_batch")
    main_path_fir("fir_suite")
    m8 = main_path_fir("fir_bf16")
    ks = sharded_kernels()
    sp = sharded_paths()
    kv = variant_kernels()
    mv = variant_paths(m1)
    si = semi_implicit()
    plain_sharded_paths()
    global_paths()
    analysis_paths()
    particle_paths()
    imaging_paths()
    finance_paths()
    suite = suite_paths()
    examples_paths(suite["rows"])

    def fir_built(b):
        """The built FIR kernel of the main path's instantiation."""
        return {"ptxas_registers": b["registers"],
                "spill_bytes": b["local_bytes"], "smem_bytes": b["smem_bytes"],
                "threads_per_block": b["threads"],
                "blocks_per_sm": b["blocks_per_sm"],
                "tile_frames": b["frames"], "ring_stages": b["stages"]}

    def sharded(kernel):
        """The padded forms' numbers and the sharded paths' launches."""
        paths = {n: r for n, r in sp.items()
                 if r["expected_launches"][kernel]}
        return {"forms": ks[kernel],
                "launches": {n: r["launches"][kernel]
                             for n, r in paths.items()},
                "ms_per_step": {n: r["ms_per_step"]
                                for n, r in paths.items()}}

    def row(name, source, replaces, function, k, launches, run, per="step",
            **extra):
        return {
            "name": name, "route": "cuda",
            "source": f"njw_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "replaces_function": function,
            "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"), "max_err": k["max_abs_err"],
            f"us_per_{per}": run[f"ms_per_{per}"] * 1e3,
            "bound_us": k["bound_ms"] * 1e3,
            "host_us_per_launch": k["host_us"], **extra}

    def built(layout):
        """The built SWE kernel's numbers for the kernels line."""
        return {"ptxas_registers": layout["registers"],
                "spill_bytes": layout["local_bytes"],
                "smem_bytes": layout["smem_bytes"],
                "threads_per_block": layout["threads"],
                "blocks_per_sm": layout["blocks_per_sm"],
                "tile": layout["tile"],
                "rows_per_thread": layout["layout"]["rows"]}

    fir = "njw_tpu/signal/fir_pallas.py"
    st, pe = "njw_tpu/ops/stencil.py", "njw_tpu/ops/pe_stencil.py"
    kernels = [
        row("swe_rk4", "swe_rk4.cu", "njw_tpu/ops/stencil.py:60",
            "swe_rk4_kernel", k1, m1["launches"]["swe_rk4"], m1,
            main_path="main_path",
            also_replaces=[f"{st}:321 swe_rk4_step_pallas_local",
                           f"{st}:377 swe_rk4_step_pallas_carry",
                           f"{st}:433 swe_rk4_step_pallas_local2d"],
            sharded=sharded("swe_rk4"), **built(k1["layout"]),
            padded_layout={form: built(r["layout"])
                           for form, r in ks["swe_rk4"].items()}),
        row("baro_stage", "baro_stage.cu", "njw_tpu/ops/baro_stencil.py:34",
            "_baro_stage_kernel", k3, m3["launches"]["baro_stage"], m3,
            main_path="main_path_baro",
            max_abs_err_all_cases=k3["max_abs_err_all_cases"],
            ptxas_registers=k3["built"]["registers"],
            spill_bytes=k3["built"]["local_bytes"],
            smem_bytes=k3["built"]["static_smem_bytes"],
            threads_per_block=k3["built"]["threads"],
            blocks_per_sm=k3["built"]["blocks_per_sm"],
            tile=[k3["built"]["rows_per_warp"],
                  32 * k3["built"]["columns_per_lane"]]),
        row("pe_stage", "pe_stage.cu", "njw_tpu/ops/pe_stencil.py:55",
            "_pe_stage_kernel", k5, m5["launches"]["pe_stage"], m5,
            main_path="main_path_pe",
            max_abs_err_all_cases=k5["max_abs_err_all_cases"],
            ms_4_bases=k5["ms_4_bases"],
            plain_ms_4_bases=k5["plain_ms_4_bases"],
            bound_ms_4_bases=k5["bound_ms_4_bases"],
            host_us_per_launch_4_bases=k5["host_us_4_bases"],
            also_replaces=[f"{pe}:397 pe_stage_pallas_local",
                           f"{pe}:1271 pe_stage_pallas_local2d"],
            sharded=sharded("pe_stage"),
            ptxas_registers=k5["built"]["registers"],
            spill_bytes=k5["built"]["local_bytes"],
            smem_bytes=k5["built"]["smem_bytes"],
            threads_per_block=k5["built"]["threads"],
            blocks_per_sm=k5["built"]["blocks_per_sm"],
            tile=k5["built"]["tile"],
            padded_built=ks["pe_stage_built"]),
        row("pe_rk4", "pe_rk4.cu", "njw_tpu/ops/pe_stencil.py:617",
            "_pe_rk4_kernel", k4, m4["launches"]["pe_rk4"], m4,
            main_path="main_path_pe_whole_step",
            ptxas_registers=k4["registers"], smem_bytes=k4["smem_bytes"],
            blocks_per_sm=k4["blocks_per_sm"],
            blocks_per_cluster=k4["blocks_per_cluster"], tile=k4["tile"],
            max_abs_err_all_cases=k4["max_abs_err_all_cases"],
            also_replaces=[f"{pe}:847 pe_rk4_pallas_local",
                           f"{pe}:989 pe_rk4_pallas_carry",
                           f"{pe}:1078 pe_rk4_pallas_local2d",
                           f"{pe}:1376 _pe_rk4_carry2d_kernel (K6, launched "
                           "by pe_rk4_pallas_carry2d :1437)"],
            sharded=sharded("pe_rk4")),
        row("fir_band", "fir_band.cu", f"{fir}:192",
            "_fir_lanes_scratch_kernel", k7, m7["launches"]["fir_band"], m7,
            per="call", main_path="main_path_fir_batch",
            also_replaces=[f"{fir}:250 _fir_lanes_kernel",
                           f"{fir}:37 _fir_batch_kernel",
                           f"{fir}:110 _fir_flat_kernel"],
            max_abs_err_all_cases=k7["max_abs_err_all_cases"],
            **fir_built(k7["built"])),
        row("fir_band_bf16", "fir_band_bf16.cu", f"{fir}:418",
            "_fir_lanes_bf16_kernel", k8, m8["launches"]["fir_band_bf16"],
            m8, per="call", main_path="main_path_fir_bf16",
            also_replaces=[f"{fir}:384 _fir_lanes_bf16_nonscratch_kernel"],
            max_abs_err_all_cases=k8["max_abs_err_all_cases"],
            **fir_built(k8["built"])),
        row("swe_rk4_bf16", "swe_rk4.cu", f"{st}:155-174",
            "swe_rk4_kernel variant bf16/bf16s (tendency_bf16)", kv["bf16"],
            mv["swe_bf16"]["launches"]["swe_rk4_bf16"], mv["swe_bf16"],
            main_path="variant_path_swe_bf16",
            max_abs_err_all_cases=kv["bf16"]["max_abs_err_all_cases"],
            k1_ms_same_call=kv["k1_same_call"]["ms"],
            **built(kv["bf16"]["layout"])),
        row("swe_rk4_multi", "swe_rk4.cu", f"{st}:484",
            "_swe_rk4_multi_kernel (n_fused=2)", kv["multi"],
            mv["swe_multistep"]["launches"]["swe_rk4_multi"],
            mv["swe_multistep"], per="call",
            main_path="variant_path_swe_multistep",
            max_abs_err_all_cases=kv["multi"]["max_abs_err_all_cases"],
            ms_per_rk4_step=kv["multi"]["ms_per_step"],
            bound_ms_per_rk4_step=kv["multi"]["bound_ms_per_step"],
            k1_ms_same_call=kv["k1_same_call"]["ms"],
            **built(kv["multi"]["layout"])),
    ]
    emit("semi_implicit_summary", ok=True, **{
        name: {"si_ms_per_step": v["si"]["ms_per_step"],
               "rk4_ms_per_step": v["rk4"]["ms_per_step"],
               "si_sim_seconds_per_wall_second":
                   v["si_dt"] / v["si"]["ms_per_step"] * 1e3,
               "rk4_sim_seconds_per_wall_second":
                   v["rk4_dt"] / v["rk4"]["ms_per_step"] * 1e3}
        for name, v in si.items() if "si" in v})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
