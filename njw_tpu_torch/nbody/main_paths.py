"""The N-body paths at full width, defined once.

``chip_smoke.py`` phase 18 drives these on the card and
``scripts/profile_torch.py --model particles`` profiles one step of each;
both take them from here. Each is a configuration the JAX package times:

  nbody_suite_4096   create_random_system(4096, seed=0), leapfrog, dt
                     0.001, force_method "auto" (the Gram form from N =
                     4096), 1000 steps (njw_tpu/bench/suite.py:172-199)
  nbody_direct_8192  create_random_system(8192), leapfrog, dt 1e-7,
                     force_method "direct", 200 steps
                     (scripts/probe_donation_nbody_md.py:56)
  nbody_galaxy_10k   the CLI's default galaxy: create_galaxy_model(10000),
                     leapfrog, dt 0.01, duration 1.0 = 100 steps
                     (README.md:49)
  nbody_pm_1m        create_random_system(2^20, box_size=10), leapfrog, dt
                     0.001, force_method "pm", pm_box 10, pm_mesh 128, 20
                     steps (BENCH_NOTES.md:547-549)
  nbody_p3m_20k      create_random_system(20000, box_size=10), leapfrog,
                     dt 0.001, force_method "p3m", pm_box 10, pm_mesh 64,
                     20 steps (BENCH_NOTES.md:550-553)
"""
from __future__ import annotations

import dataclasses

from njw_tpu_torch.nbody.simulation import NBodySimulation
from njw_tpu_torch.nbody.system import (
    NBodySystem, create_galaxy_model, create_random_system,
)


@dataclasses.dataclass(frozen=True)
class NBodyPath:
    n: int
    system: str                 # "random" or "galaxy"
    dt: float
    steps: int                  # timed steps
    source: str
    force_method: str = "auto"
    box_size: float = 10.0      # the random system's box, and PM's
    pm_mesh: int = 64
    warm: int = 2               # steps before a timed run

    @property
    def pm(self) -> bool:
        return self.force_method in ("pm", "p3m")

    def make_system(self, device="cuda") -> NBodySystem:
        if self.system == "galaxy":
            return create_galaxy_model(self.n, seed=0, device=device)
        return create_random_system(self.n, box_size=self.box_size, seed=0,
                                    device=device)

    def simulation(self, device="cuda", system=None) -> NBodySimulation:
        """The path's ``NBodySimulation`` (on ``system`` where given)."""
        return NBodySimulation(
            self.make_system(device) if system is None else system,
            integrator="leapfrog", dt=self.dt,
            force_method=self.force_method,
            pm_box=self.box_size if self.pm else 0.0, pm_mesh=self.pm_mesh)


NBODY_PATHS = {
    "nbody_suite_4096": NBodyPath(4096, "random", 0.001, 1000,
                                  "njw_tpu/bench/suite.py:172-199"),
    "nbody_direct_8192": NBodyPath(8192, "random", 1e-7, 200,
                                   "scripts/probe_donation_nbody_md.py:56",
                                   force_method="direct"),
    "nbody_galaxy_10k": NBodyPath(10_000, "galaxy", 0.01, 100,
                                  "README.md:49"),
    "nbody_pm_1m": NBodyPath(1 << 20, "random", 0.001, 20,
                             "BENCH_NOTES.md:547-549", force_method="pm",
                             pm_mesh=128),
    "nbody_p3m_20k": NBodyPath(20_000, "random", 0.001, 20,
                               "BENCH_NOTES.md:550-553", force_method="p3m",
                               pm_mesh=64),
}
