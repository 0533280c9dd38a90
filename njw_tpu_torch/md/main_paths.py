"""The MD paths at full width, defined once.

``chip_smoke.py`` phase 18 drives these on the card and
``scripts/profile_torch.py --model particles`` profiles one step of each;
both take them from here. Each is a configuration the JAX package times
or tests:

  md_suite_1000   create_lj_fluid(1000, T0=1.0), velocity Verlet, dt
                  0.002, force_method "auto", 1000 steps
                  (njw_tpu/bench/suite.py:202-227)
  md_lj_4096      create_lj_fluid(4096), dt 0.002, "auto", 500 steps
                  (scripts/probe_donation_nbody_md.py:65)
  md_forces_5k,   create_lj_fluid(5000) and (20000): one force evaluation
  md_forces_20k   by "all_pairs" and one by "cell_list" (steps 0;
                  BENCH_NOTES.md:554-560)
  md_water_1000   create_water_box(1000, T0=0.5) (3000 atoms), dt 0.0005,
                  cutoff 6.0, Berendsen at 0.5, the cell list with the
                  bonded exclusions subtracted, 200 steps (the settings of
                  tests/test_md.py:129-138 at the port's own size)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from njw_tpu_torch.md.forces import make_force_fn
from njw_tpu_torch.md.simulation import MDSimulation
from njw_tpu_torch.md.system import create_lj_fluid, create_water_box

FORCE_METHODS = ("all_pairs", "cell_list")


@dataclasses.dataclass(frozen=True)
class MDPath:
    system: str                 # "lj_fluid" (n atoms) or "water" (n molecules)
    n: int
    source: str
    steps: int = 0              # timed steps; 0: a force-evaluation path
    dt: float = 0.002
    T0: float = 1.0
    cutoff: float = 2.5
    thermostat: Optional[str] = None
    force_method: str = "auto"
    warm: int = 2               # steps before a timed run

    def make_system(self, device="cuda"):
        """(state, topology, lj) on ``device``."""
        if self.system == "water":
            return create_water_box(self.n, T0=self.T0, seed=0,
                                    device=device)
        return create_lj_fluid(self.n, T0=self.T0, seed=0, device=device)

    def simulation(self, device="cuda") -> MDSimulation:
        state, topo, lj = self.make_system(device)
        return MDSimulation(state, topo, lj, dt=self.dt,
                            cutoff=self.cutoff, thermostat=self.thermostat,
                            T0=self.T0, force_method=self.force_method)

    def force_fns(self, state, topo, lj) -> dict:
        """{method: force_fn} for each of FORCE_METHODS on the state's
        device (a force-evaluation path's two evaluations)."""
        box = state.box.cpu().numpy()
        return {m: make_force_fn(topo, lj, self.cutoff, state.n, method=m,
                                 box_static=box, device=state.pos.device)
                for m in FORCE_METHODS}


MD_PATHS = {
    "md_suite_1000": MDPath("lj_fluid", 1000,
                            "njw_tpu/bench/suite.py:202-227", steps=1000),
    "md_lj_4096": MDPath("lj_fluid", 4096,
                         "scripts/probe_donation_nbody_md.py:65", steps=500),
    "md_forces_5k": MDPath("lj_fluid", 5000, "BENCH_NOTES.md:554-560"),
    "md_forces_20k": MDPath("lj_fluid", 20_000, "BENCH_NOTES.md:554-560"),
    "md_water_1000": MDPath("water", 1000, "tests/test_md.py:129-138",
                            steps=200, dt=0.0005, T0=0.5, cutoff=6.0,
                            thermostat="berendsen", force_method="cell_list"),
}
