"""Simulation: a device-resident step loop with metrics.

Counterpart of ``njw_tpu/weather/model.py``. ``Simulation.step(n)`` runs
n steps as a Python loop over the stepper (the JAX package's chunked
``lax.scan``), then synchronises the device before it reads the clock, so
the metrics time finished work. CUDA graphs of the chunk are later work.

Models: shallow_water (and its alias general), barotropic
(``weather/barotropic.py``) and primitive (``weather/primitive.py``) on
the cartesian grid; shallow water on the C-grid (grid_type staggered,
``weather/staggered.py``); the spectral BVE and SWE on the sphere
(spherical_harmonic or spectral, ``weather/spherical.py``) and the
icosahedral SWE (icosahedral, ``weather/icosa.py``). Nested grids:
``weather/nested.py`` ``make_nested_sim``.

Backend selection (``SimConfig.backend``), the same for every model:
  auto    the model's kernel stepper (SWE: the fused RK4 kernel; the
          barotropic and PE cores: four stage kernels per RK4 step) when
          the configuration is eligible and the device is CUDA; the plain
          integrators otherwise
  kernel  the kernel stepper (its plain versions for CPU tensors); raises
          for an ineligible configuration
  plain   the plain integrators over the model's tendencies
``integration_method='semi_implicit'`` (SWE and PE, ``si_order`` 1 or 2)
takes the spectral semi-implicit steppers of ``semi_implicit.py``, which
run no kernel of this package; backend kernel refuses it.

While a ``torch.profiler`` session records, the forecast path keeps spans
(``utils/profiling.py``): ``sim.build`` (``from_config``) holding
``sim.build.state`` (the initial state on the device), ``sim.run``
(counters ``steps``, ``snapshots``), ``sim.step`` (``steps``; its self
time is the wait at the synchronise) holding ``sim.step.enqueue``, and
``sim.output`` holding ``sim.output.copy`` (``bytes``; ``pinned_bytes``,
those copied through pinned host memory; on CUDA ``host_allocs``, the
pinned blocks the copy had to make anew), each with its simulation's
``span_id``.

On a mesh (``from_config(..., mesh=)``, the cartesian primitive core) a
simulation holds this process's part of the domain, and each snapshot
also holds ``block`` = (y0, y1, x0, x1), where that part lies
(``weather/convert.py`` ``shards_to_numpy`` assembles the parts); while a
profiler records, each halo refresh of a step is a ``sim.step.exchange``
span in ``sim.step.enqueue`` and ``sim.build`` counts the ``rank``.

Snapshots: ``_store_output`` copies the output function's CUDA fields
into pinned host tensors, asynchronously with one wait, and host fields
as ``.cpu()`` does; each snapshot's arrays are its own. A simulation's
first kept snapshot keeps its pinned tensors; a snapshot stored while the
simulation holds others is staged through them into pageable memory, so
a run that keeps many snapshots pins no more than two snapshots' worth.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from njw_tpu_torch.platform.device import require_device
from njw_tpu_torch.utils import profiling
from njw_tpu_torch.weather.dynamics import diagnostics, make_tendency_fn
from njw_tpu_torch.weather.grid import (
    FieldState, GridSpec, PhysicsParams, WeatherState,
)
from njw_tpu_torch.weather.ics import make_initial_state
from njw_tpu_torch.weather.integrators import make_stepper

BACKENDS = ("auto", "plain", "kernel")
# the global cores (weather/spherical.py, weather/icosa.py)
GLOBAL_GRIDS = ("spherical_harmonic", "spectral", "icosahedral")


@dataclass(frozen=True)
class SimConfig:
    """Run configuration (the JAX package's ``SimConfig`` with ``device``
    added and backends auto | plain | kernel)."""

    model: str = "shallow_water"     # shallow_water | general | barotropic | primitive
    integration_method: str = "rk4"  # euler|rk2|rk4|adams_bashforth|semi_implicit
    si_order: int = 1                # semi_implicit: 1 (CN) | 2 (predictor-corrector)
    boundary_condition: str = "periodic"  # periodic | clamped | outflow | reflective
    grid_type: str = "cartesian"     # cartesian | staggered | spherical_harmonic | icosahedral

    grid_width: int = 256
    grid_height: int = 256
    num_levels: int = 1              # primitive: sigma levels L
    dx: float = 1.0
    dy: float = 1.0
    dt: float = 0.01

    gravity: float = 9.81
    coriolis_f: float = 0.0
    beta: float = 0.0
    viscosity: float = 0.0
    diffusivity: float = 0.0

    backend: str = "auto"
    max_steps: int = 1000
    output_interval: int = 10
    random_seed: int = 0
    device: str = "cuda"

    def grid_spec(self) -> GridSpec:
        return GridSpec(
            nx=self.grid_width, ny=self.grid_height, levels=self.num_levels,
            dx=self.dx, dy=self.dy, bc=self.boundary_condition,
            grid_type=self.grid_type,
        )

    def physics(self) -> PhysicsParams:
        return PhysicsParams(
            gravity=self.gravity, coriolis_f=self.coriolis_f, beta=self.beta,
            viscosity=self.viscosity, diffusivity=self.diffusivity,
        )


@dataclass
class PerformanceMetrics:
    """Wall-clock metrics plus throughput (grid-points/s, MCUPS)."""

    total_time_ms: float = 0.0
    compute_time_ms: float = 0.0
    io_time_ms: float = 0.0
    num_steps: int = 0
    grid_points: int = 0

    @property
    def steps_per_second(self) -> float:
        t = self.compute_time_ms or self.total_time_ms
        return self.num_steps / (t / 1e3) if t else 0.0

    @property
    def grid_points_per_second(self) -> float:
        return self.grid_points * self.steps_per_second

    @property
    def mcups(self) -> float:
        """Million cell updates per second."""
        return self.grid_points_per_second / 1e6

    def reset(self) -> None:
        self.total_time_ms = self.compute_time_ms = self.io_time_ms = 0.0
        self.num_steps = 0

    def as_dict(self) -> dict[str, float]:
        return {
            "total_time_ms": self.total_time_ms,
            "compute_time_ms": self.compute_time_ms,
            "io_time_ms": self.io_time_ms,
            "num_steps": self.num_steps,
            "steps_per_second": self.steps_per_second,
            "grid_points_per_second": self.grid_points_per_second,
            "mcups": self.mcups,
        }


def _prognostic_only(state: WeatherState, model: str) -> WeatherState:
    """Strip a full state down to the model's prognostic variables."""
    if model in ("shallow_water", "general"):
        return WeatherState(u=state.u, v=state.v, h=state.h)
    return state


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array of its own. ``.cpu()`` copies a device
    tensor but returns a host tensor as it is, which may be a stepper's
    buffer that later steps overwrite: that one is copied here."""
    host = t.detach().cpu()
    if host.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        host = host.clone()
    return host.numpy()


def _fields_to_host(fields: dict, keep_pinned: bool) -> tuple[dict, int]:
    """The fields as host arrays of their own, and the bytes that went
    through pinned memory. Each CUDA field is copied asynchronously, on
    its device's current stream, into a pinned host tensor of PyTorch's
    caching host allocator (a block that a released snapshot or staging
    copy gave back, else a new one), with one wait for the last copy.
    With ``keep_pinned`` its array is a view that keeps the tensor, so a
    block returns to the cache only once every holder has let go of it;
    else the tensor is copied into pageable memory and returns to the
    cache at once. A field whose pinned allocation fails, and every host
    tensor, goes through ``_to_host``."""
    out: dict[str, Any] = {}
    pinned, streams = 0, {}
    for k, v in fields.items():
        if v.device.type == "cuda":
            try:
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            except RuntimeError:   # no pinned memory left: the pageable copy
                pass
            else:
                out[k] = host.copy_(v.detach(), non_blocking=True)
                pinned += host.nbytes
                streams[v.device] = torch.cuda.current_stream(v.device)
                continue
        out[k] = _to_host(v)
    for stream in streams.values():
        stream.synchronize()
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            if not keep_pinned:
                v = torch.empty(v.shape, dtype=v.dtype).copy_(v)
            out[k] = v.numpy()
    return out, pinned


def _host_allocs() -> int:
    """The pinned blocks the caching host allocator has made so far."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """Generic step loop over a state with the ``FieldState`` protocol
    (``WeatherState``, ``BarotropicState``, ``PEState``).

    Weather-specific construction goes through :meth:`from_config`; the
    loop itself needs only ``(state0, tendency_fn, method, dt)``.
    """

    def __init__(
        self,
        state0: FieldState,
        tendency_fn: Callable,
        *,
        dt: float,
        method: str = "rk4",
        grid: Optional[GridSpec] = None,
        stepper_factory: Optional[Callable] = None,
        output_fn: Optional[Callable[[FieldState], dict]] = None,
    ):
        self.grid = grid
        self.dt = float(dt)
        self.state = state0
        self.device = state0.device
        self.time = 0.0
        self.step_count = 0
        # grid points: the horizontal grid (every field shares it)
        if grid is not None:
            points = grid.nx * grid.ny
        else:
            shape = next(state0.items())[1].shape
            points = int(shape[-1] * shape[-2])
        self.metrics = PerformanceMetrics(grid_points=points)
        self.span_id = profiling.new_sim_id()
        self.output_fn = output_fn
        self.snapshots: list[dict[str, Any]] = []
        # (y0, y1, x0, x1): the part of the domain this simulation holds,
        # stored with each snapshot; None: the whole domain on one device
        self.block: Optional[tuple] = None

        if stepper_factory is not None:
            self.stepper = stepper_factory(tendency_fn)
        else:
            self.stepper = make_stepper(method, tendency_fn)
        self._carry = self.stepper.init(state0)
        # dt enters the steppers as a float32 value, as in the JAX package
        self._dt_f32 = float(np.float32(self.dt))

    @classmethod
    def from_config(cls, config: SimConfig, initial_condition: str = "uniform",
                    mesh=None, **ic_params) -> "Simulation":
        """The simulation of ``config`` from ``initial_condition``. With a
        ``mesh`` of ``njw_tpu_torch.parallel`` (the cartesian primitive
        core only), this process's part of the domain: its state is the
        shard the mesh gives it (on a ``LocalMesh``, the list of its
        shards), built alone, and the sharded stepper the backend rule
        picks advances it (``weather/primitive.py``)."""
        sim_id = profiling.new_sim_id()
        with profiling.span("sim.build", sim_id) as span:
            sim = cls._build(config, initial_condition, mesh, **ic_params)
            if span is not None and mesh is not None:
                span.counters["rank"] = getattr(mesh, "rank", 0)
        sim.span_id = sim_id
        return sim

    @classmethod
    def _build(cls, config: SimConfig, initial_condition: str, mesh,
               **ic_params) -> "Simulation":
        device = require_device(config.device)
        if config.backend not in BACKENDS:
            raise ValueError(f"unknown backend {config.backend!r}; "
                             f"available: {list(BACKENDS)}")
        model = config.model
        if mesh is not None and (model != "primitive"
                                 or config.grid_type != "cartesian"):
            raise ValueError("a mesh runs the cartesian primitive-equation "
                             f"core only, not {model!r} on "
                             f"{config.grid_type!r}")
        if config.grid_type in GLOBAL_GRIDS:
            if config.backend == "kernel":
                raise ValueError("backend='kernel' requires the cartesian "
                                 "grid: the global cores run no kernel")
            if config.grid_type == "icosahedral":
                from njw_tpu_torch.weather.icosa import make_icosa_sim

                return make_icosa_sim(cls, config, initial_condition,
                                      device=device, **ic_params)
            from njw_tpu_torch.weather.spherical import make_spherical_sim

            return make_spherical_sim(cls, config, initial_condition,
                                      device=device, **ic_params)
        if model == "barotropic":
            from njw_tpu_torch.weather.barotropic import make_barotropic_sim

            config.grid_spec().validate()
            return make_barotropic_sim(cls, config, initial_condition,
                                       device=device, **ic_params)
        if model == "primitive":
            from njw_tpu_torch.weather.primitive import make_primitive_sim

            return make_primitive_sim(cls, config, initial_condition,
                                      device=device, mesh=mesh, **ic_params)

        grid = config.grid_spec()
        params = config.physics()
        # raises NotImplementedError for the grids not yet ported
        tendency = make_tendency_fn(model, grid, params)
        with profiling.span("sim.build.state"):
            gen = torch.Generator().manual_seed(config.random_seed)
            full0 = make_initial_state(initial_condition, grid, device=device,
                                       generator=gen, **ic_params)
            state0 = _prognostic_only(full0, model)

        def output_fn(s):
            out = {"u": s.u, "v": s.v, "h": s.h}
            out.update(diagnostics(s, grid))
            return out

        # built first for every method: it refuses backend='kernel' for a
        # configuration the kernel does not take, semi-implicit included
        factory = _swe_kernel_factory(config, grid, params, device)
        if config.integration_method == "semi_implicit":
            def factory(t):
                return make_stepper("semi_implicit", t, grid=grid,
                                    params=params, order=config.si_order)

        sim = cls(
            state0, tendency, dt=config.dt, method=config.integration_method,
            grid=grid, stepper_factory=factory, output_fn=output_fn,
        )
        sim.config = config
        return sim

    def step(self, n: int = 1, synchronize: bool = True) -> FieldState:
        """Advance n steps on the device, then synchronise. With
        ``synchronize=False`` it returns once the steps are enqueued, and
        the metrics time the host's part alone."""
        t0 = time.perf_counter()
        with profiling.begin("sim.step", t0, self.span_id, steps=n) as \
                whole, profiling.begin("sim.step.enqueue", t0,
                                       steps=n) as enqueue:
            carry, state, step, dt = self._carry, self.state, \
                self.stepper.step, self._dt_f32
            for _ in range(n):
                carry, state = step(carry, state, dt)
            self._carry, self.state = carry, state
            enqueue.close(time.perf_counter())
            if synchronize:
                _sync(self.device)
            t1 = time.perf_counter()
            whole.close(t1)
        elapsed = (t1 - t0) * 1e3
        self.metrics.compute_time_ms += elapsed
        self.metrics.total_time_ms += elapsed
        self.metrics.num_steps += n
        self.step_count += n
        self.time += n * self.dt
        return self.state

    def run(self, n_steps: Optional[int] = None, output_interval: int = 0,
            callback: Optional[Callable] = None) -> FieldState:
        """Run n_steps, snapshotting every output_interval steps."""
        if n_steps is None:
            n_steps = getattr(self, "config", SimConfig()).max_steps
        with profiling.span("sim.run", self.span_id) as span:
            remaining, stored = n_steps, 0
            chunk = output_interval if output_interval > 0 else n_steps
            while remaining > 0:
                n = min(chunk, remaining)
                self.step(n)
                remaining -= n
                if output_interval > 0:
                    self._store_output()
                    stored += 1
                if callback is not None:
                    callback(self)
            if span is not None:
                span.counters.update(steps=n_steps, snapshots=stored)
        return self.state

    def run_until(self, t_end: float, output_interval: int = 0,
                  callback=None) -> FieldState:
        """Advance until the simulated time reaches t_end."""
        n = max(int(round((t_end - self.time) / self.dt)), 0)
        return self.run(n, output_interval=output_interval, callback=callback)

    def _store_output(self) -> None:
        traced = profiling.recording()
        t0 = time.perf_counter()
        fields = (self.output_fn(self.state) if self.output_fn is not None
                  else dict(self.state.items()))
        fields = {k: v for k, v in fields.items() if v is not None}
        cuda = traced and any(v.device.type == "cuda"
                              for v in fields.values())
        allocs0 = _host_allocs() if cuda else 0
        copy0 = time.perf_counter() if traced else 0.0
        snap, pinned = _fields_to_host(fields, keep_pinned=not self.snapshots)
        t1 = time.perf_counter()
        if traced:
            counters = dict(bytes=sum(a.nbytes for a in snap.values()),
                            pinned_bytes=pinned)
            if cuda:
                counters["host_allocs"] = _host_allocs() - allocs0
            i = profiling.record("sim.output", t0, t1, self.span_id)
            profiling.record("sim.output.copy", copy0, t1, parent=i,
                             **counters)
        snap["step"] = self.step_count
        snap["time"] = self.time
        if self.block is not None:
            snap["block"] = self.block
        self.snapshots.append(snap)
        elapsed = (t1 - t0) * 1e3
        self.metrics.io_time_ms += elapsed
        self.metrics.total_time_ms += elapsed


def kernel_stepper_factory(config: SimConfig, device: torch.device,
                           supported: bool, make: Callable[[], Any],
                           requirement: str) -> Optional[Callable]:
    """The backend rule of every core (see the module docstring): a
    stepper factory around ``make`` for the kernel stepper, or None for
    the plain integrators. ``supported``: the configuration is eligible;
    ``requirement``: what eligibility needs, for the error message."""
    if config.backend == "plain":
        return None
    if not supported:
        if config.backend == "kernel":
            raise ValueError(f"backend='kernel' requires {requirement}")
        return None
    if config.backend == "auto" and device.type != "cuda":
        return None
    return lambda _tendency: make()


def _swe_kernel_factory(config: SimConfig, grid: GridSpec,
                        params: PhysicsParams, device: torch.device):
    from njw_tpu_torch.ops.stencil import kernel_supported, \
        make_kernel_rk4_stepper

    return kernel_stepper_factory(
        config, device,
        kernel_supported(grid, params, config.model,
                         config.integration_method),
        lambda: make_kernel_rk4_stepper(grid, params, config.dt),
        "shallow_water + rk4 + periodic BC + cartesian grid + constant f "
        "(beta=0)")
