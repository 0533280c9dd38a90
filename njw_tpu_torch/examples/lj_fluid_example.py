"""LJ-fluid MD study: equilibrate with a thermostat, switch to NVE
production, and report energy conservation, temperature statistics, and
the radial distribution function g(r), the standard structure check for
a Lennard-Jones liquid (first peak near r = 2^(1/6) sigma ~ 1.12).
Counterpart of ``examples/lj_fluid_example.py``.

    python -m njw_tpu_torch.examples.lj_fluid_example --num-atoms 2048 \\
        --density 0.8 --temperature 1.0 --steps 2000 \\
        --thermostat nose_hoover --rdf
"""
import argparse
import json
import os

import numpy as np

from njw_tpu_torch.examples._common import add_device, can_draw
from njw_tpu_torch.md import MDSimulation, create_lj_fluid
from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.viz._common import to_numpy


def radial_distribution(pos, box, n_bins=80, r_max=None):
    """g(r) from minimum-image pair distances (NumPy post-processing of
    the final configuration, on the host)."""
    pos = to_numpy(pos)
    box = to_numpy(box)
    n = pos.shape[0]
    r_max = r_max or float(box.min()) / 2.0
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)                 # minimum image
    r = np.sqrt((d ** 2).sum(-1))[np.triu_indices(n, 1)]
    hist, edges = np.histogram(r, bins=n_bins, range=(0, r_max))
    rho = n / float(np.prod(box))
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    ideal = rho * shell * n / 2.0
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, hist / np.maximum(ideal, 1e-12)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m njw_tpu_torch.examples.lj_fluid_example",
        description=__doc__)
    p.add_argument("--num-atoms", type=int, default=512)
    p.add_argument("--density", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=2000,
                   help="production (NVE) steps")
    p.add_argument("--equil-steps", type=int, default=None,
                   help="thermostatted equilibration steps "
                        "(default: steps // 2)")
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--thermostat", default="berendsen",
                   choices=["berendsen", "andersen", "nose_hoover"])
    p.add_argument("--force-method", default="auto",
                   choices=["auto", "all_pairs", "cell_list"])
    p.add_argument("--rdf", action="store_true",
                   help="compute and plot g(r) of the final configuration")
    p.add_argument("--save-trajectory", action="store_true")
    p.add_argument("--output-dir", default="./output")
    add_device(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = require_device(args.device)
    equil = args.equil_steps if args.equil_steps is not None \
        else args.steps // 2

    os.makedirs(args.output_dir, exist_ok=True)
    state, topo, lj = create_lj_fluid(args.num_atoms, density=args.density,
                                      T0=args.temperature, device=dev)

    # ---- phase 1: thermostatted equilibration --------------------------
    sim = MDSimulation(state, topo, lj, dt=args.dt,
                       thermostat=args.thermostat, T0=args.temperature,
                       force_method=args.force_method)
    temps = []
    sim.run(equil, callback=lambda s: temps.append(s.temperature()),
            callback_interval=max(equil // 25, 1))
    t_equil = sim.temperature()
    print(f"equilibration: {equil} steps, T -> {t_equil:.3f} "
          f"(target {args.temperature})")

    # ---- phase 2: NVE production (energy must be conserved) ------------
    prod = MDSimulation(sim.state, topo, lj, dt=args.dt,
                        force_method=args.force_method)
    times, ke, pe, tot = [], [], [], []

    def record(s):
        e = s.energies()
        times.append(s.time)
        ke.append(e["kinetic"])
        pe.append(e["potential"])
        tot.append(e["total"])

    prod.run(args.steps, callback=record,
             callback_interval=max(args.steps // 50, 1),
             record_trajectory=args.save_trajectory)
    drift = abs(tot[-1] - tot[0]) / max(abs(tot[0]), 1e-12)

    draw = can_draw("lj_fluid_example")
    if draw:
        from njw_tpu_torch.viz import plot_energy_history, plot_particles_3d

        plot_energy_history(times, {"kinetic": ke, "potential": pe,
                                    "total": tot},
                            path=os.path.join(args.output_dir, "energy.png"))
        plot_particles_3d(prod.state.pos,
                          path=os.path.join(args.output_dir, "final.png"))

    report = {
        "atoms": args.num_atoms,
        "density": args.density,
        "thermostat": args.thermostat,
        "T_after_equil": round(t_equil, 4),
        "T_production_mean": round(float(np.mean(ke))
                                   / (1.5 * args.num_atoms), 4),
        "nve_energy_drift": drift,
        **prod.performance_metrics(),
    }

    if args.rdf:
        r, g = radial_distribution(prod.state.pos, prod.state.box)
        if draw:
            from njw_tpu_torch.viz._common import pyplot

            plt = pyplot()
            fig, ax = plt.subplots(figsize=(6, 3.5))
            ax.plot(r, g)
            ax.axvline(2 ** (1 / 6), color="#999", linestyle="--",
                       label=r"$2^{1/6}\sigma$")
            ax.set_xlabel("r / sigma")
            ax.set_ylabel("g(r)")
            ax.set_title(f"LJ fluid g(r), rho={args.density}, "
                         f"T={args.temperature}")
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(args.output_dir, "rdf.png"), dpi=110)
            plt.close(fig)
        report["g_r_first_peak_at"] = round(float(r[np.argmax(g)]), 3)

    if args.save_trajectory:
        prod.save_trajectory(os.path.join(args.output_dir, "traj.npz"))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
