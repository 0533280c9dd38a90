"""Shallow-water demo: run a vortex, save plots and an animation.
Counterpart of ``examples/shallow_water_example.py``.

    python -m njw_tpu_torch.examples.shallow_water_example --width 256 \\
        --steps 500 --method rk4 --initial vortex --animate --output-dir out/

The run goes through ``Simulation`` with ``--backend auto``: on the card
the RK4 method steps with the fused kernel ``ops/csrc/swe_rk4.cu`` (one
launch a step); on the CPU with its plain version.
"""
import argparse
import json
import os

import numpy as np

from njw_tpu_torch.examples._common import add_device, can_draw
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.weather import SimConfig, Simulation

METHODS = ["euler", "rk2", "rk4", "adams_bashforth", "semi_implicit"]


def compare_methods(args):
    """Integrator study: the same initial condition through every method;
    reports wall time, stability, and the L2 distance of h from the rk4
    solution."""
    results = {}
    ref_h = None
    for m in ["rk4"] + [x for x in METHODS if x != "rk4"]:
        cfg = SimConfig(grid_width=args.width, grid_height=args.height,
                        dt=args.dt, integration_method=m,
                        boundary_condition=args.bc, coriolis_f=1e-4,
                        device=args.device)
        sim = Simulation.from_config(cfg, args.initial, strength=2.0)
        sim.step(args.steps)
        h = sim.state.h.cpu().numpy()
        finite = bool(np.isfinite(h).all())
        if m == "rk4":
            ref_h = h
        results[m] = {
            "stable": finite,
            "ms_per_step": round(sim.metrics.total_time_ms
                                 / max(sim.metrics.num_steps, 1), 4),
            "l2_vs_rk4": (round(float(np.sqrt(((h - ref_h) ** 2).mean())),
                                6) if finite and ref_h is not None
                          else None),
        }
    print(json.dumps(results, indent=2))
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.shallow_water_example")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--method", default="rk4")
    p.add_argument("--initial", default="vortex")
    p.add_argument("--backend", default="auto")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--animate", action="store_true")
    p.add_argument("--bc", default="periodic",
                   choices=["periodic", "clamped", "outflow", "reflective"])
    p.add_argument("--grid-type", default="cartesian",
                   choices=["cartesian", "staggered"])
    p.add_argument("--compare-methods", action="store_true",
                   help="run euler/rk2/rk4/ab2/semi-implicit on the same "
                        "IC and report stability + divergence from rk4")
    add_device(p)
    return p.parse_args(argv)


def simulate(args) -> Simulation:
    """The example's run: ``args.steps`` steps with a snapshot every
    steps // 25 (at least 1)."""
    cfg = SimConfig(grid_width=args.width, grid_height=args.height,
                    dt=args.dt, integration_method=args.method,
                    backend=args.backend, coriolis_f=1e-4,
                    boundary_condition=args.bc, grid_type=args.grid_type,
                    device=args.device)
    sim = Simulation.from_config(cfg, args.initial, strength=2.0)
    sim.run(args.steps, output_interval=max(args.steps // 25, 1))
    return sim


def main(argv=None) -> int:
    args = parse_args(argv)
    require_device(args.device)
    if args.compare_methods:
        return compare_methods(args)

    os.makedirs(args.output_dir, exist_ok=True)
    sim = simulate(args)
    if can_draw("shallow_water_example"):
        from njw_tpu_torch.viz import (
            animate_simulation, visualize_height, visualize_velocity,
            visualize_vorticity,
        )

        s = sim.state
        visualize_height(s.h, path=os.path.join(args.output_dir,
                                                "height.png"))
        visualize_velocity(s.u, s.v, path=os.path.join(args.output_dir,
                                                       "velocity.png"))
        visualize_vorticity(s.u, s.v, path=os.path.join(args.output_dir,
                                                        "vorticity.png"))
        if args.animate:
            animate_simulation(sim.snapshots, "h", path=os.path.join(
                args.output_dir, "height.gif"))
    print(sim.metrics.as_dict())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
