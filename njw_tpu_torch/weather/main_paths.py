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

``SHARDED_PATHS`` are the sharded runs of ``njw_tpu_torch.parallel`` at
full width, each a main path's configuration on a mesh:

  swe_*       the swe main path on (4, 1) (K1's carry form) and on (2, 2)
              (K1's local2d form), 100 steps
  pe5_*       BASELINE config 5 (BASELINE.json: primitive equations
              2048^2 x 40, 2-D domain decomposition): the primitive main
              path at 2048^2 x 40 levels, on K4 (fused) on (2, 2) (the
              default: local2d), on (2, 2) with carry=True (K6) and on
              (4, 1) (carry), and on the K5 stage path on (4, 1) and
              (2, 2); 10 steps (config 5 names no step count; the JAX
              package's mesh sweep, njw_tpu/bench/scaling.py:136, checks
              one step per mesh)
"""
from __future__ import annotations

import dataclasses
from typing import Any

from njw_tpu_torch.weather.model import SimConfig, Simulation
from njw_tpu_torch.weather.primitive import pe_initial_state


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


@dataclasses.dataclass(frozen=True)
class ShardedPath:
    """A main path's configuration (``MAIN_PATHS[model]``, with
    ``overrides``) run by a sharded stepper of ``njw_tpu_torch.parallel``
    on a ``mesh`` of shape (py, px)."""

    model: str                   # key of MAIN_PATHS
    overrides: dict[str, Any]    # SimConfig fields changed
    mesh: tuple[int, int]
    stepper: str                 # constructor in njw_tpu_torch.parallel
    options: dict[str, Any]      # its keyword options (carry)
    kernel: str                  # the launch counter the path must move
    launches_per_step: int       # launches per shard per step
    steps: int

    @property
    def main(self) -> MainPath:
        return MAIN_PATHS[self.model]

    def sim_config(self, **overrides) -> SimConfig:
        return self.main.sim_config(**{**self.overrides, **overrides})

    def make_stepper(self, mesh):
        """The sharded stepper of this path on ``mesh``."""
        from njw_tpu_torch import parallel

        cfg = self.sim_config()
        return getattr(parallel, self.stepper)(
            cfg.grid_spec(), cfg.physics(), mesh, dt=cfg.dt,
            n_steps=self.steps, **self.options)

    def initial_state(self, device="cuda"):
        """The whole-domain initial state (the main path's IC)."""
        cfg = self.sim_config(device=device)
        if cfg.model == "primitive":
            return pe_initial_state(cfg.grid_spec(), device=device,
                                    **self.main.ic_params)
        return Simulation.from_config(cfg, self.main.ic,
                                      **self.main.ic_params).state

    def simulation(self, **overrides) -> Simulation:
        """The whole-domain run of the same configuration (backend auto
        unless overridden), on CUDA unless ``device`` is given."""
        overrides.setdefault("device", "cuda")
        return Simulation.from_config(self.sim_config(**overrides),
                                      self.main.ic, **self.main.ic_params)


_CONFIG5 = dict(grid_width=2048, grid_height=2048, num_levels=40)
SHARDED_PATHS = {
    "swe_4x1": ShardedPath("swe", {}, (4, 1), "sharded_swe_step_kernel", {},
                           "swe_rk4", 1, 100),
    "swe_2x2": ShardedPath("swe", {}, (2, 2), "sharded_swe_step_kernel", {},
                           "swe_rk4", 1, 100),
    "pe5_fused_2x2": ShardedPath(
        "primitive", _CONFIG5, (2, 2), "sharded_pe_step_kernel_fused", {},
        "pe_rk4", 1, 10),
    "pe5_fused_carry_2x2": ShardedPath(
        "primitive", _CONFIG5, (2, 2), "sharded_pe_step_kernel_fused_2d",
        {"carry": True}, "pe_rk4", 1, 10),
    "pe5_fused_4x1": ShardedPath(
        "primitive", _CONFIG5, (4, 1), "sharded_pe_step_kernel_fused", {},
        "pe_rk4", 1, 10),
    "pe5_stage_4x1": ShardedPath(
        "primitive", _CONFIG5, (4, 1), "sharded_pe_step_kernel", {},
        "pe_stage", 4, 10),
    "pe5_stage_2x2": ShardedPath(
        "primitive", _CONFIG5, (2, 2), "sharded_pe_step_kernel", {},
        "pe_stage", 4, 10),
}
