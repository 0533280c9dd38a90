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

``VARIANT_PATHS`` are the cores' other steppers at full width:

  swe_bf16       the swe main path through ``Simulation`` with the stepper
                 ``make_kernel_rk4_stepper(..., variant="bf16")`` (the
                 counterpart of handing ``make_pallas_rk4_stepper(variant=)``
                 to the JAX Simulation): 1000 bf16 launches
  swe_multistep  the same state and configuration, 1000 steps as 500 calls
                 of ``swe_rk4_multistep(n_fused=2)`` (BENCH_NOTES.md:637-643;
                 the stepper ``make_kernel_multistep_stepper``, whose step
                 is two RK4 steps)
  swe_si         planar SWE 512^2, semi-implicit order 2, dt 0.25, jet_stream
                 strength 2.0, viscosity 1e-3, f 1e-4, 100 steps
                 (scripts/measure_capability_cores.py:199-223)
  pe_si          the primitive main path's configuration, semi-implicit order
                 2, dt 450 s, 100 steps (:232-245; inside the 150 steps
                 validated there)

``SHARDED_PATHS`` are the sharded runs of ``njw_tpu_torch.parallel`` at
full width, each a main path's configuration on a mesh:

  swe_*       the swe main path on (4, 1) (K1's carry form) and on (2, 2)
              (K1's local2d form), 100 steps
  pe5_*       BASELINE config 5 (BASELINE.json: primitive equations
              2048^2 x 40, 2-D domain decomposition): the primitive main
              path at 2048^2 x 40 levels, on K4 (fused) on (2, 2) (the
              fused constructor's default form, local2d), on (2, 2) with
              carry=True (K6) and on (4, 1) (carry), and on the K5 stage
              path on (4, 1) and (2, 2); 10 steps (config 5 names no step
              count; the JAX package's mesh sweep,
              njw_tpu/bench/scaling.py:136, checks one step per mesh).
              Config 5 also runs through ``Simulation.from_config(...,
              mesh=)``: backends auto and kernel take the K5 stage path
              there (local2d on (2, 2), local on (py, 1)); K4's fused
              forms are the sharded fused constructors'

``PLAIN_SHARDED_PATHS`` are the plain sharded steppers (no kernel of the
port launches: the launch count is 0) at full width:

  swe_plain_*        the swe main path on (4, 1) and (2, 2), and on (2, 2)
                     with reflective walls and beta 1e-3 (what the kernel
                     path refuses); sharded_swe_step, overlap, 100 steps
  pe4_plain_*        the primitive main path (BASELINE config 4) on (2, 2)
                     and (4, 1); sharded_pe_step, overlap, 20 steps
  baro_*             the barotropic main path (BASELINE config 3) on (4, 1)
                     (the transpose FFT) and (2, 2) (the 2-D branch, pencil
                     FFT); sharded_barotropic_step, 100 steps

Config 5 stays on the kernel paths: its plain whole-domain run, the
comparison a plain path is held to, keeps tens of state-sized
temporaries of 2048^2 x 40 alive.

``GLOBAL_PATHS`` are the C-grid, nested, spectral and icosahedral cores
and their sharded forms at full width (no kernel of the port: launch
count 0), each the JAX package's own measured configuration:

  staggered_2048    C-grid SWE 2048^2, vortex 1.0, f 1e-4, dt 0.01, RK4,
                    25 steps (scripts/measure_capability_cores.py:68-80)
  nested_512        coarse 512^2, patch (128, 384, 128, 384), ratio 2,
                    f 1e-4, vortex 1.0, dt 0.02, RK4, 50 steps (:85-123)
  sph_swe_T341      spectral SWE, nlat 512 x 1024 (T341, the fold on),
                    rossby_haurwitz, nu4 1e15, dt 112.5 s, RK4, 50 steps
                    (scripts/measure_spherical.py:81, 90-95)
  sph_bve_T341      BVE on the same grid, rossby_haurwitz, dt 112.5 s,
                    RK4, 50 steps (the same)
  sph_si_T170       spectral SWE, nlat 256 x 512, rossby_haurwitz, nu4
                    1e15: semi-implicit order 2 at dt 480 beside its
                    partner, RK4 at dt 240, 80 steps each
                    (measure_capability_cores.py:246-264)
  icosa_256         icosahedral SWE, n = 256 (655,360 cells), williamson2,
                    dt 56.25 s, RK4, 100 steps (scripts/measure_icosa.py:41)
  sph_swe_T341_4x1  sph_swe_T341 unfolded on LocalMesh(4, 1), 20 steps
  icosa_256_5x1     icosa_256 on LocalMesh(5, 1), 20 steps
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    options: dict[str, Any]      # its keyword options (carry, overlap)
    kernel: Optional[str]        # the launch counter the path must move
    launches_per_step: int       # launches per shard per step (0: plain)
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


_OVERLAP = {"overlap": True}
PLAIN_SHARDED_PATHS = {
    "swe_plain_4x1": ShardedPath("swe", {}, (4, 1), "sharded_swe_step",
                                 _OVERLAP, None, 0, 100),
    "swe_plain_2x2": ShardedPath("swe", {}, (2, 2), "sharded_swe_step",
                                 _OVERLAP, None, 0, 100),
    "swe_plain_refl_beta_2x2": ShardedPath(
        "swe", {"boundary_condition": "reflective", "beta": 1e-3}, (2, 2),
        "sharded_swe_step", _OVERLAP, None, 0, 100),
    "pe4_plain_2x2": ShardedPath("primitive", {}, (2, 2), "sharded_pe_step",
                                 _OVERLAP, None, 0, 20),
    "pe4_plain_4x1": ShardedPath("primitive", {}, (4, 1), "sharded_pe_step",
                                 _OVERLAP, None, 0, 20),
    "baro_4x1": ShardedPath("barotropic", {}, (4, 1),
                            "sharded_barotropic_step", {}, None, 0, 100),
    "baro_2x2": ShardedPath("barotropic", {}, (2, 2),
                            "sharded_barotropic_step", {}, None, 0, 100),
}


@dataclasses.dataclass(frozen=True)
class VariantPath:
    """A core's other stepper at full width: ``main`` gives the
    configuration, initial condition, warm-up and timed steps (of this
    path's ``Simulation``, whose step is ``steps_per_call`` RK4 steps for
    the multistep kernel), ``stepper`` the stepper (``"auto"``: what
    ``Simulation.from_config`` picks), ``kernel`` the launch counter the
    path moves (None: no kernel of the port) and ``launches_per_step`` its
    launches per ``Simulation`` step."""

    main: MainPath
    stepper: str                 # auto | bf16 | multistep
    kernel: Optional[str]
    launches_per_step: int
    steps_per_call: int = 1

    def simulation(self, **overrides) -> Simulation:
        """The path's ``Simulation`` (backend auto), on CUDA unless
        ``device`` is given."""
        if self.stepper == "auto":
            return self.main.simulation(**overrides)
        from njw_tpu_torch.ops.stencil import (
            make_kernel_multistep_stepper, make_kernel_rk4_stepper,
        )
        from njw_tpu_torch.weather.dynamics import make_tendency_fn

        overrides.setdefault("device", "cuda")
        cfg = self.main.sim_config(**overrides)
        grid, params = cfg.grid_spec(), cfg.physics()
        state0 = Simulation.from_config(cfg, self.main.ic,
                                        **self.main.ic_params).state
        if self.stepper == "bf16":
            def factory(_tendency):
                return make_kernel_rk4_stepper(grid, params, cfg.dt,
                                               variant="bf16")
        else:
            def factory(_tendency):
                return make_kernel_multistep_stepper(
                    grid, params, cfg.dt, n_fused=self.steps_per_call)
        sim = Simulation(state0, make_tendency_fn(cfg.model, grid, params),
                         dt=cfg.dt * self.steps_per_call, grid=grid,
                         stepper_factory=factory)
        sim.config = cfg
        return sim


_SWE = MAIN_PATHS["swe"]
VARIANT_PATHS = {
    "swe_bf16": VariantPath(_SWE, "bf16", "swe_rk4_bf16", 1),
    "swe_multistep": VariantPath(
        MainPath(_SWE.config, _SWE.ic, _SWE.ic_params, warm=5, steps=500),
        "multistep", "swe_rk4_multi", 1, steps_per_call=2),
    "swe_si": VariantPath(MainPath(
        dict(grid_width=512, grid_height=512, dt=0.25,
             integration_method="semi_implicit", si_order=2,
             coriolis_f=1e-4, viscosity=1e-3),
        "jet_stream", {"strength": 2.0}, warm=2, steps=100),
        "auto", None, 0),
    "pe_si": VariantPath(MainPath(
        {**MAIN_PATHS["primitive"].config, "dt": 450.0,
         "integration_method": "semi_implicit", "si_order": 2},
        "baroclinic", {"u_jet": 5.0, "perturb": 0.5}, warm=2, steps=100),
        "auto", None, 0),
}


@dataclasses.dataclass(frozen=True)
class GlobalPath(MainPath):
    """A global or refined core at full width: a MainPath (through
    ``Simulation.from_config``, or ``make_nested_sim`` when ``nest`` =
    (patch, ratio) is set); ``partner``: SimConfig fields of the run it is
    set beside (the RK4 partner of a semi-implicit path); ``mesh``: the
    (D, 1) LocalMesh of a sharded path, whose stepper runs ``steps``
    steps a call."""

    nest: Optional[tuple] = None
    partner: Optional[dict[str, Any]] = None
    mesh: Optional[tuple[int, int]] = None

    def simulation(self, **overrides) -> Simulation:
        if self.nest is None:
            return super().simulation(**overrides)
        from njw_tpu_torch.weather.nested import make_nested_sim

        overrides.setdefault("device", "cuda")
        patch, ratio = self.nest
        return make_nested_sim(Simulation, self.sim_config(**overrides),
                               self.ic, patch=patch, ratio=ratio,
                               **self.ic_params)

    @property
    def points(self) -> int:
        """Grid points a step updates: nlat x nlon, 10 n^2 cells, or the
        coarse grid's points plus the fine patch's."""
        c = self.config
        if c.get("grid_type") == "icosahedral":
            return 10 * c["grid_height"] ** 2
        n = c["grid_width"] * c["grid_height"]
        if self.nest is not None:
            (y0, y1, x0, x1), r = self.nest
            n += (y1 - y0) * (x1 - x0) * r * r
        return n

    def sharded(self, sim, mesh):
        """(stepper, local states) of this path on ``mesh``, from the
        whole-domain ``sim``'s transform or operators and state."""
        cfg = self.sim_config()
        if cfg.grid_type == "icosahedral":
            from njw_tpu_torch.parallel.icosa import (
                shard_icosa, sharded_icosa_swe_step)

            ops, states = shard_icosa(sim.icosa_ops, sim.state, mesh)
            return sharded_icosa_swe_step(
                ops, mesh, g=cfg.gravity or 9.80616,
                omega=self.ic_params.get("omega", 7.292e-5),
                nu=cfg.viscosity, n_steps=self.steps), states
        from njw_tpu_torch.parallel.sphere import (
            replicate, sharded_spherical_step)

        core = "bve" if cfg.model == "barotropic" else "swe"
        return sharded_spherical_step(
            sim.sht, mesh, core=core, omega=sim.omega,
            nu4=self.ic_params.get("nu4", 0.0),
            n_steps=self.steps), replicate(sim.state, mesh)


_T341 = dict(grid_type="spherical_harmonic", grid_width=1024,
             grid_height=512, dt=112.5)
_ICOSA = dict(grid_type="icosahedral", grid_width=256, grid_height=256,
              dt=56.25)
GLOBAL_PATHS = {
    "staggered_2048": GlobalPath(
        dict(grid_width=2048, grid_height=2048, grid_type="staggered",
             coriolis_f=1e-4, dt=0.01),
        "vortex", {"strength": 1.0}, warm=2, steps=25),
    "nested_512": GlobalPath(
        dict(grid_width=512, grid_height=512, coriolis_f=1e-4, dt=0.02),
        "vortex", {"strength": 1.0}, warm=2, steps=50,
        nest=((128, 384, 128, 384), 2)),
    "sph_swe_T341": GlobalPath(
        dict(model="shallow_water", **_T341), "rossby_haurwitz",
        {"nu4": 1e15}, warm=2, steps=50),
    "sph_bve_T341": GlobalPath(
        dict(model="barotropic", **_T341), "rossby_haurwitz", {}, warm=2,
        steps=50),
    "sph_si_T170": GlobalPath(
        dict(model="shallow_water", grid_type="spherical_harmonic",
             grid_width=512, grid_height=256, dt=480.0,
             integration_method="semi_implicit", si_order=2),
        "rossby_haurwitz", {"nu4": 1e15}, warm=2, steps=80,
        partner=dict(dt=240.0, integration_method="rk4")),
    "icosa_256": GlobalPath(dict(model="shallow_water", **_ICOSA),
                            "williamson2", {}, warm=2, steps=100),
    "sph_swe_T341_4x1": GlobalPath(
        dict(model="shallow_water", **_T341), "rossby_haurwitz",
        {"nu4": 1e15, "fold_parity": False}, warm=1, steps=20, mesh=(4, 1)),
    "icosa_256_5x1": GlobalPath(dict(model="shallow_water", **_ICOSA),
                                "williamson2", {}, warm=1, steps=20,
                                mesh=(5, 1)),
}
