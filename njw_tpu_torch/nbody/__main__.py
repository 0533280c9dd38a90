"""CLI: python -m njw_tpu_torch.nbody

Counterpart of ``python -m njw_tpu.nbody``: the same flags and the same
JSON line, plus ``--device {cuda,cpu}`` (default cuda, which fails
without a CUDA device)."""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="njw_tpu_torch.nbody",
                                description="N-body simulation on an NVIDIA "
                                "GPU (PyTorch)")
    p.add_argument("--system-type", default="random",
                   choices=["random", "solar", "galaxy", "file"])
    p.add_argument("--num-particles", type=int, default=1000)
    p.add_argument("--box-size", type=float, default=10.0)
    p.add_argument("--min-mass", type=float, default=0.1)
    p.add_argument("--max-mass", type=float, default=1.0)
    p.add_argument("--velocity-scale", type=float, default=0.1)
    p.add_argument("--g-constant", type=float, default=1.0)
    p.add_argument("--scale-factor", type=float, default=1.0)
    p.add_argument("--galaxy-radius", type=float, default=10.0)
    p.add_argument("--galaxy-height", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--input-file", default=None)
    p.add_argument("--integrator", default="leapfrog",
                   choices=["euler", "leapfrog", "verlet", "rk4"])
    p.add_argument("--force-method", default="auto",
                   choices=["auto", "direct", "mxu", "pm", "p3m"],
                   help="pm/p3m = (Ewald-split) particle-mesh for N >> 1e5 "
                        "(periodic box --box-size)")
    p.add_argument("--pm-mesh", type=int, default=64)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--duration", type=float, default=1.0)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--save-visualization", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from njw_tpu_torch.nbody import (
        NBodySimulation, create_galaxy_model, create_random_system,
        create_solar_system,
    )

    dev = args.device
    if args.system_type == "random":
        system = create_random_system(
            args.num_particles, box_size=args.box_size,
            min_mass=args.min_mass, max_mass=args.max_mass,
            velocity_scale=args.velocity_scale, G=args.g_constant,
            seed=args.seed, device=dev)
        sim = NBodySimulation(system, integrator=args.integrator,
                              dt=args.dt, force_method=args.force_method,
                              pm_box=args.box_size, pm_mesh=args.pm_mesh)
    elif args.system_type == "solar":
        system = create_solar_system(scale_factor=args.scale_factor,
                                     seed=args.seed, device=dev)
        sim = NBodySimulation(system, integrator=args.integrator, dt=args.dt)
    elif args.system_type == "galaxy":
        system = create_galaxy_model(
            args.num_particles, radius=args.galaxy_radius,
            height=args.galaxy_height, G=args.g_constant, seed=args.seed,
            device=dev)
        sim = NBodySimulation(system, integrator=args.integrator, dt=args.dt)
    else:
        if not args.input_file:
            print("--system-type file requires --input-file", file=sys.stderr)
            return 2
        sim = NBodySimulation.load_state(args.input_file, device=dev)

    e0 = sim.diagnostics()["total_energy"]
    sim.run(args.duration)
    diag = sim.diagnostics()
    metrics = sim.performance_metrics()
    if not args.quiet:
        print(json.dumps({
            "particles": sim.system.n,
            "steps": sim.step_count,
            "energy_initial": e0,
            "energy_final": diag["total_energy"],
            "energy_drift": abs(diag["total_energy"] - e0) / max(abs(e0), 1e-30),
            **{k: metrics[k] for k in
               ("ms_per_step", "interactions_per_second")},
        }))
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        sim.save_state(os.path.join(args.output_dir, "final_state.npz"))
        if args.save_visualization:
            import numpy as np

            np.savez_compressed(
                os.path.join(args.output_dir, "visualization.npz"),
                **sim.visualization_data())
    return 0


if __name__ == "__main__":
    sys.exit(main())
