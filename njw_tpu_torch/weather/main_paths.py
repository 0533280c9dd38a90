"""The main path of each dynamical core: one run per core at full width.

``chip_smoke.py`` drives these on the card and ``scripts/profile_torch.py``
profiles them; both take them from here. Each is the JAX package's own
timed run of that core:

  swe         2048^2 RK4, vortex strength 1.0, dt 0.001, f 1e-4
              (bench.py:48-53)
  barotropic  1024^2 RK4, vortex strength 3.0 with zeta diagnosed from it,
              dt 0.01, beta 1e-3, nu 1e-4 (BASELINE config 3,
              scripts/measure_swe.py:80-89)
  primitive   512^2 x 20 sigma levels RK4, dx = dy = 1e5 m, dt 240 s,
              f 1e-4, baroclinic u_jet 5.0, perturb 0.5 (BASELINE config 4,
              scripts/measure_capability_cores.py:232-245); 100 steps stay
              inside the 150-step horizon validated there
"""
from __future__ import annotations

import dataclasses
from typing import Any

from njw_tpu_torch.weather.model import SimConfig, Simulation


@dataclasses.dataclass(frozen=True)
class MainPath:
    config: dict[str, Any]       # SimConfig fields
    ic: str                      # initial condition
    ic_params: dict[str, Any]
    warm: int                    # warm-up steps before a timed run
    steps: int                   # timed steps

    def sim_config(self, **overrides) -> SimConfig:
        return SimConfig(**{**self.config, **overrides})

    def simulation(self, **overrides) -> Simulation:
        """``Simulation.from_config`` of this path (backend auto unless
        overridden), on CUDA unless ``device`` is given."""
        overrides.setdefault("device", "cuda")
        return Simulation.from_config(self.sim_config(**overrides), self.ic,
                                      **self.ic_params)


MAIN_PATHS = {
    "swe": MainPath(
        dict(grid_width=2048, grid_height=2048, dt=0.001,
             integration_method="rk4", coriolis_f=1e-4),
        "vortex", {"strength": 1.0}, warm=10, steps=1000),
    "barotropic": MainPath(
        dict(model="barotropic", grid_width=1024, grid_height=1024, dt=0.01,
             beta=1e-3, viscosity=1e-4),
        "vortex", {"strength": 3.0}, warm=5, steps=1000),
    "primitive": MainPath(
        dict(model="primitive", grid_width=512, grid_height=512,
             num_levels=20, dx=1e5, dy=1e5, dt=240.0, coriolis_f=1e-4),
        "baroclinic", {"u_jet": 5.0, "perturb": 0.5}, warm=2, steps=100),
}
