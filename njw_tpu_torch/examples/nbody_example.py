"""N-body study: evolve a galaxy model, track energy conservation, and, at
large N, compare the O(N^2) direct force path against the particle-mesh
(PM) and P3M solvers for accuracy and speed. Counterpart of
``examples/nbody_example.py``.

    python -m njw_tpu_torch.examples.nbody_example --num-particles 20000 \\
        --steps 200
    python -m njw_tpu_torch.examples.nbody_example --num-particles 200000 \\
        --force-method pm --pm-mesh 128 --steps 50
    python -m njw_tpu_torch.examples.nbody_example --compare-forces \\
        --num-particles 20000
"""
import argparse
import json
import os
import time

import torch

from njw_tpu_torch.examples._common import (
    add_device, can_draw, synchronize,
)
from njw_tpu_torch.nbody import (
    NBodySimulation, create_galaxy_model, create_random_system,
    create_solar_system,
)
from njw_tpu_torch.nbody.forces import accelerations
from njw_tpu_torch.nbody.pm import p3m_accelerations, pm_accelerations
from njw_tpu_torch.platform.device import require_device


def compare_forces(args):
    """Speed of pm/p3m against the direct O(N^2) path at the same N, and
    a two-particle Newton accuracy sweep across separations. (Direct
    computes free-space gravity; PM/P3M compute periodic gravity, so bulk
    force vectors are not comparable; the pairwise sweep at r << box is
    the meaningful accuracy check.)"""
    dev = require_device(args.device)
    sys_ = create_random_system(args.num_particles, box_size=1.0,
                                seed=args.seed, device=dev)
    pos, mass = sys_.pos, sys_.mass

    def timed(fn):
        fn()                      # warm
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        return time.perf_counter() - t0

    t_direct = timed(lambda: accelerations(sys_, method="direct"))
    t_pm = timed(lambda: pm_accelerations(pos, mass, mesh=args.pm_mesh,
                                          box=1.0, G=1.0))
    t_p3m = timed(lambda: p3m_accelerations(pos, mass, mesh=args.pm_mesh,
                                            box=1.0, G=1.0))

    # accuracy: two particles at separation r, against Newton's 1/r^2
    sweep = []
    cell = 1.0 / args.pm_mesh
    for r_cells in (1.0, 1.3, 2.0, 4.0, 8.0):
        r = r_cells * cell
        pp = torch.tensor([[0.5 - r / 2, 0.5, 0.5],
                           [0.5 + r / 2, 0.5, 0.5]], dtype=torch.float32,
                          device=dev)
        mm = torch.ones(2, dtype=torch.float32, device=dev)
        newton = 1.0 / r ** 2
        a_pm = abs(float(pm_accelerations(pp, mm,
                                          mesh=args.pm_mesh)[0, 0]))
        a_p3m = abs(float(p3m_accelerations(pp, mm,
                                            mesh=args.pm_mesh)[0, 0]))
        sweep.append({"separation_cells": r_cells,
                      "pm_over_newton": round(a_pm / newton, 3),
                      "p3m_over_newton": round(a_p3m / newton, 3)})

    print(json.dumps({
        "n": args.num_particles, "mesh": args.pm_mesh,
        "seconds": {"direct": round(t_direct, 4), "pm": round(t_pm, 4),
                    "p3m": round(t_p3m, 4)},
        "speedup_vs_direct": {"pm": round(t_direct / max(t_pm, 1e-9), 2),
                              "p3m": round(t_direct / max(t_p3m, 1e-9),
                                           2)},
        "pairwise_accuracy_sweep": sweep,
        "note": "P3M ~1.0 x Newton from ~1.3 cells; plain PM is soft "
                "below ~2 cells (the Ewald-split short-range fix)",
    }, indent=2))
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.nbody_example",
        description=__doc__)
    p.add_argument("--num-particles", type=int, default=10_000)
    p.add_argument("--system", default="galaxy",
                   choices=["galaxy", "random", "solar"])
    p.add_argument("--integrator", default="leapfrog",
                   choices=["euler", "leapfrog", "verlet", "rk4"])
    p.add_argument("--force-method", default="auto",
                   choices=["auto", "direct", "mxu", "pm", "p3m"])
    p.add_argument("--pm-mesh", type=int, default=128)
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--softening", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare-forces", action="store_true")
    p.add_argument("--output-dir", default="./output")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.compare_forces:
        return compare_forces(args)

    dev = require_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.system == "galaxy":
        system = create_galaxy_model(args.num_particles, seed=args.seed,
                                     device=dev)
    elif args.system == "random":
        system = create_random_system(args.num_particles, seed=args.seed,
                                      device=dev)
    else:
        system = create_solar_system(device=dev)

    kw = {}
    if args.force_method in ("pm", "p3m"):
        kw = {"pm_mesh": args.pm_mesh, "pm_box": 1.0}
    sim = NBodySimulation(system, integrator=args.integrator, dt=args.dt,
                          force_method=args.force_method, **kw)
    e0 = float(sim.diagnostics()["total_energy"])
    energies = []
    n_rec = max(args.steps // 20, 1)
    for _ in range(0, args.steps, n_rec):
        sim.step(n_rec)
        energies.append(float(sim.diagnostics()["total_energy"]))
    e1 = energies[-1]

    if can_draw("nbody_example"):
        from njw_tpu_torch.viz import plot_particles_3d

        plot_particles_3d(sim.system.pos,
                          path=os.path.join(args.output_dir, "final.png"))
    report = {"system": args.system, "n": int(sim.system.pos.shape[0]),
              "integrator": args.integrator,
              "force_method": args.force_method,
              "steps": args.steps,
              "energy_initial": e0, "energy_final": e1,
              "energy_drift": abs(e1 - e0) / max(abs(e0), 1e-12),
              **{k: float(v) for k, v in
                 sim.performance_metrics().items()
                 if isinstance(v, (int, float))}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
