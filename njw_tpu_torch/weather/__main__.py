"""CLI: python -m njw_tpu_torch.weather

Counterpart of ``python -m njw_tpu.weather``: the same argument surface,
plus ``--device {cuda,cpu}`` (default cuda, which fails without a CUDA
device) and backends auto | plain | kernel. Every core the JAX CLI runs
runs here: shallow water, barotropic and primitive equations on the
cartesian grid with every integrator (``--method semi_implicit
--si-order 1|2`` included), the C-grid (``--grid-type staggered``), the
global spectral cores (``--grid-type spherical_harmonic``, width 2 x
height; ``vortex`` maps to rossby_haurwitz or williamson2), the
icosahedral core (``--grid-type icosahedral``, height = cells per rhombus
edge), two-way nesting (``--nest-patch Y0,Y1,X0,X1 --nest-ratio R``) and
the snapshot writers (``--output-format csv|npz|vtk|netcdf --output-dir
DIR``). ``--validate`` checks the shallow-water core against its NumPy
oracle, whatever ``--model`` says, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="njw_tpu_torch.weather",
        description="Weather solver (shallow water, barotropic vorticity, "
        "primitive equations) on an NVIDIA GPU: PyTorch plus hand-written "
        "CUDA kernels",
    )
    p.add_argument("--model", default="shallow_water",
                   choices=["shallow_water", "barotropic", "primitive"])
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--levels", type=int, default=1,
                   help="sigma levels of the primitive-equation core")
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument(
        "--method", default="rk4",
        choices=["euler", "rk2", "rk4", "adams_bashforth", "semi_implicit"],
    )
    p.add_argument("--si-order", type=int, default=1, choices=[1, 2],
                   help="semi_implicit only: 1=CN, 2=predictor-corrector "
                        "(stable explicit advection at several-x-CFL dt)")
    p.add_argument("--initial", default="vortex")
    p.add_argument("--bc", default="periodic",
                   choices=["periodic", "clamped", "outflow", "reflective"])
    p.add_argument("--grid-type", default="cartesian",
                   choices=["cartesian", "staggered", "spherical_harmonic",
                            "icosahedral"],
                   help="cartesian = collocated A-grid; staggered = "
                        "Arakawa C-grid (Sadourny enstrophy-conserving); "
                        "spherical_harmonic = global spectral core on a "
                        "Gaussian grid (width must be 2x height); "
                        "icosahedral = global 10-panel finite-volume core "
                        "(height = cells per rhombus edge, power of 2)")
    p.add_argument("--nest-patch", default=None, metavar="Y0,Y1,X0,X1",
                   help="two-way nested refinement patch in coarse-cell "
                        "indices (half-open; shallow_water model only)")
    p.add_argument("--nest-ratio", type=int, default=2,
                   help="space/time refinement ratio for --nest-patch")
    p.add_argument("--coriolis", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--viscosity", type=float, default=0.0)
    p.add_argument("--mountain-height", type=float, default=0.0,
                   help="primitive only: a Gaussian mountain of this "
                        "surface geopotential at the domain centre")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "plain", "kernel"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu for the plain path")
    p.add_argument("--output-interval", type=int, default=0,
                   help="snapshot interval in steps (0 = no snapshots)")
    p.add_argument("--output", default=None,
                   help="write the final state and diagnostics to this .npz")
    p.add_argument("--output-format", default=None,
                   choices=["csv", "npz", "vtk", "netcdf"],
                   help="write per-interval snapshots via an output "
                        "manager into --output-dir")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--device-info", action="store_true",
                   help="print device info and exit")
    p.add_argument("--validate", action="store_true",
                   help="run the device path against the NumPy oracle "
                        "(allclose check) and exit")
    p.add_argument("--json", action="store_true",
                   help="print metrics as one JSON line")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.device_info:
        from njw_tpu_torch.platform import get_device_info

        print(json.dumps(get_device_info(args.device)))
        return 0

    from njw_tpu_torch.platform import require_device

    require_device(args.device)  # raises when CUDA is absent
    if args.validate:
        return _validate(args)

    from njw_tpu_torch.weather import SimConfig, Simulation

    cfg = SimConfig(
        model=args.model, grid_width=args.width, grid_height=args.height,
        num_levels=args.levels, dx=args.dx, dy=args.dy, dt=args.dt,
        integration_method=args.method, si_order=args.si_order,
        boundary_condition=args.bc, grid_type=args.grid_type,
        coriolis_f=args.coriolis, beta=args.beta, viscosity=args.viscosity,
        backend=args.backend, max_steps=args.steps,
        output_interval=args.output_interval, device=args.device,
    )
    if args.model == "primitive" and args.initial == "vortex":
        args.initial = "baroclinic"  # the PE default (vortex is SWE-only)
    if args.grid_type == "spherical_harmonic" and args.initial == "vortex":
        # cartesian ICs have no spherical meaning: the canonical one
        args.initial = ("rossby_haurwitz" if args.model == "barotropic"
                        else "williamson2")
    sim_kw = {}
    if args.mountain_height > 0.0:
        if args.model != "primitive":
            print("error: --mountain-height requires --model primitive",
                  file=sys.stderr)
            return 2
        import numpy as np

        y, x = np.mgrid[0:args.height, 0:args.width].astype(np.float32)
        cy, cx = (args.height - 1) / 2, (args.width - 1) / 2
        sy, sx = max(args.height / 8, 1), max(args.width / 8, 1)
        sim_kw["orography"] = args.mountain_height * np.exp(
            -(((y - cy) / sy) ** 2 + ((x - cx) / sx) ** 2))
    if args.nest_patch is not None:
        if args.model != "shallow_water" or args.grid_type != "cartesian":
            print("error: --nest-patch requires --model shallow_water on "
                  "the cartesian grid", file=sys.stderr)
            return 2
        from njw_tpu_torch.weather.nested import make_nested_sim

        patch = tuple(int(t) for t in args.nest_patch.split(","))
        sim = make_nested_sim(Simulation, cfg, args.initial, patch=patch,
                              ratio=args.nest_ratio, **sim_kw)
    else:
        sim = Simulation.from_config(cfg, args.initial, **sim_kw)
    callback = None
    if args.output_format:
        from njw_tpu_torch.weather.output import OutputConfig, attach_output

        _, callback = attach_output(
            sim, OutputConfig(path=args.output_dir,
                              format=args.output_format))
    # Warm-up (kernel build and load) outside the timed region.
    sim.step(1)
    sim.metrics.reset()
    sim.run(args.steps - 1, output_interval=args.output_interval,
            callback=callback)

    m = sim.metrics.as_dict()
    if args.json:
        print(json.dumps(m))
    else:
        print(f"model={args.model} grid={args.width}x{args.height} "
              f"method={args.method} steps={args.steps} "
              f"stepper={sim.stepper.name} device={args.device}")
        for k, v in m.items():
            print(f"  {k}: {v:,.3f}" if isinstance(v, float) else f"  {k}: {v}")

    if args.output:
        import numpy as np

        payload = {f"final_{k}": v.detach().cpu().numpy()
                   for k, v in sim.output_fn(sim.state).items()}
        np.savez_compressed(args.output, **payload)
        print(f"wrote {args.output}")
    return 0


def _validate(args) -> int:
    """Device-vs-oracle allclose check at up to 128^2 and 200 steps."""
    import numpy as np

    from njw_tpu_torch.weather import SimConfig, Simulation, make_initial_state
    from njw_tpu_torch.weather.grid import GridSpec
    from njw_tpu_torch.weather.oracle import SWEOracle

    if args.method not in ("euler", "rk2", "rk4", "adams_bashforth"):
        # semi_implicit has no matching oracle integrator: held against an
        # RK4 oracle run it would fail for the wrong reason
        print(json.dumps({"error": f"--validate does not support "
                          f"--method {args.method}: the oracle integrates "
                          "explicitly; use euler/rk2/rk4/adams_bashforth"}))
        return 2

    n = min(args.width, 128)
    steps = min(args.steps, 200)
    ic_kw = {"strength": 2.0} if args.initial == "vortex" else {}
    s0 = make_initial_state(args.initial, GridSpec(nx=n, ny=n, bc=args.bc),
                            device="cpu", **ic_kw)
    cfg = SimConfig(grid_width=n, grid_height=n, dt=args.dt,
                    integration_method=args.method,
                    boundary_condition=args.bc, grid_type=args.grid_type,
                    backend=args.backend, coriolis_f=args.coriolis,
                    device=args.device)
    sim = Simulation.from_config(cfg, args.initial, **ic_kw)
    sim.step(steps)
    u, v, h = SWEOracle(bc=args.bc, coriolis_f=args.coriolis).run(
        (s0.u.numpy(), s0.v.numpy(), s0.h.numpy()), args.dt, steps,
        args.method)
    diff = float(np.max(np.abs(sim.state.h.cpu().numpy() - h)))
    ok = bool(np.isfinite(diff) and diff < 1e-3 * max(np.abs(h).max(), 1.0))
    print(json.dumps({"grid": n, "steps": steps, "method": args.method,
                      "stepper": sim.stepper.name, "device": args.device,
                      "max_abs_diff_h": diff, "allclose": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
