"""CLI: python -m njw_tpu_torch.md

Counterpart of ``python -m njw_tpu.md``: the same flags and the same JSON
line, plus ``--device {cuda,cpu}`` (default cuda, which fails without a
CUDA device)."""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="njw_tpu_torch.md",
                                description="Molecular dynamics on an "
                                "NVIDIA GPU (PyTorch)")
    p.add_argument("--system", default="lj_fluid",
                   choices=["lj_fluid", "water", "pdb"])
    p.add_argument("--num-atoms", type=int, default=512)
    p.add_argument("--num-molecules", type=int, default=64)
    p.add_argument("--pdb-file", default=None)
    p.add_argument("--density", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--integrator", default="velocity_verlet",
                   choices=["velocity_verlet", "leapfrog", "beeman"])
    p.add_argument("--thermostat", default=None,
                   choices=[None, "berendsen", "andersen", "nose_hoover"])
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--cutoff", type=float, default=2.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-state", default=None)
    p.add_argument("--output-trajectory", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from njw_tpu_torch.md import (
        MDSimulation, create_lj_fluid, create_water_box, load_from_pdb,
    )

    dev = args.device
    if args.system == "lj_fluid":
        state, topo, lj = create_lj_fluid(
            args.num_atoms, density=args.density, T0=args.temperature,
            seed=args.seed, device=dev)
    elif args.system == "water":
        state, topo, lj = create_water_box(args.num_molecules,
                                           T0=args.temperature,
                                           seed=args.seed, device=dev)
    else:
        if not args.pdb_file:
            print("--system pdb requires --pdb-file", file=sys.stderr)
            return 2
        state, topo, lj = load_from_pdb(args.pdb_file, T0=args.temperature,
                                        device=dev)

    sim = MDSimulation(state, topo, lj, dt=args.dt,
                       integrator=args.integrator,
                       thermostat=args.thermostat, T0=args.temperature,
                       cutoff=args.cutoff, seed=args.seed)
    e0 = sim.energies()
    sim.run(args.steps, record_trajectory=bool(args.output_trajectory),
            callback_interval=max(args.steps // 20, 1))
    e1 = sim.energies()
    print(json.dumps({
        "atoms": sim.state.n,
        "steps": sim.step_count,
        "temperature": sim.temperature(),
        "energy_initial": e0["total"],
        "energy_final": e1["total"],
        **{k: v for k, v in sim.performance_metrics().items()
           if k in ("ms_per_step", "atom_steps_per_second")},
    }))
    if args.output_state:
        sim.save_state(args.output_state)
    if args.output_trajectory:
        sim.save_trajectory(args.output_trajectory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
