"""Benchmark suite: per-workload benchmarks and their runner.

Counterpart of ``njw_tpu/bench/suite.py``. ``BenchmarkResult`` has the
JAX package's fields, so the two packages' result files read alike. Each
``WorkloadBenchmark`` runs on the port's entry points on ``device`` (CUDA
unless the caller passes ``device="cpu"``) and times itself by the JAX
suite's work-doubling differential: ``execute(repeats=1)`` and
``execute(repeats=2)``, both warmed first, and the marginal t2 - t1.
``execute`` repeats the work in a host loop closed by ``sync``, which
waits for the device (``torch.cuda.synchronize`` on CUDA).

Each workload keeps the JAX package's default parameters. ``INNER``, the
work a repeat holds, is the port's own: sized so that each marginal is at
least ~20 ms on an H100 (the JAX figures were sized for a TPU's dispatch
noise). Every result records its repeat size in ``additional_metrics``
(``steps_per_repeat``, ``applications_per_repeat``, ...) and the
launches of the port's hand-written kernels over the whole run
(``kernel_launches``: weather runs K1, signal K7; the other workloads
none).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree

from njw_tpu_torch.ops import launch_counts
from njw_tpu_torch.platform.device import detect, require_device


@dataclass
class BenchmarkResult:
    """One workload's timing, throughput, memory and cost."""

    workload: str
    device: str
    execution_time_s: float
    throughput: float
    throughput_unit: str
    memory_bytes: int = 0
    additional_metrics: dict = field(default_factory=dict)
    cost_metrics: dict = field(default_factory=dict)
    timestamp: str = field(
        default_factory=lambda: datetime.datetime.now(
            datetime.timezone.utc).isoformat())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BenchmarkResult":
        return cls(**d)

    def calculate_cost_metrics(self, cost_model) -> dict:
        self.cost_metrics = cost_model.cost_of(self.execution_time_s)
        return self.cost_metrics


def _state_bytes(state) -> int:
    """Bytes of the tensors and arrays among the state's pytree leaves."""
    total = 0
    for a in _pytree.tree_leaves(state):
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        elif isinstance(a, np.ndarray):
            total += a.nbytes
    return total


class WorkloadBenchmark:
    """Base benchmark. Subclasses implement ``setup() -> state`` and
    ``execute(state, repeats) -> (work of ONE repeat, unit, extras)``."""

    name = "base"
    INNER = 1  # work units a repeat

    def __init__(self, device="cuda", **params):
        self.device = require_device(device)
        self.params = params

    def setup(self) -> Any:
        raise NotImplementedError

    def execute(self, state, repeats: int = 1) -> tuple[float, str, dict]:
        """Run ``repeats`` x the workload (a host loop of ``INNER *
        repeats`` units) and return (work of one repeat, unit, extras)."""
        raise NotImplementedError

    def sync(self, state=None) -> None:
        """Wait for the work queued on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> BenchmarkResult:
        """Work-doubling differential: warm execute(1) and execute(2),
        time each once, report the marginal t2 - t1, which cancels the
        per-call overhead that the two share."""
        caps = detect(self.device)
        state = self.setup()
        before = launch_counts()
        for r in (1, 2):
            self.execute(state, r)
            self.sync(state)

        def timed(r):
            t0 = time.perf_counter()
            out = self.execute(state, r)
            self.sync(state)
            return time.perf_counter() - t0, out

        t1, (work, unit, extra) = timed(1)
        t2, _ = timed(2)
        after = launch_counts()
        elapsed = max(t2 - t1, 1e-9)
        return BenchmarkResult(
            workload=self.name,
            device=f"{caps.platform}:{caps.name}",
            execution_time_s=elapsed,
            throughput=work / elapsed,
            throughput_unit=unit,
            memory_bytes=_state_bytes(state),
            additional_metrics={
                **extra, **self.params,
                "timing_method": "work-doubling differential "
                                 "(dispatch overhead cancelled)",
                "dispatch_overhead_s": round(max(2 * t1 - t2, 0.0), 6),
                "kernel_launches": {k: after[k] - before[k] for k in after},
            },
        )


class WeatherBenchmark(WorkloadBenchmark):
    """Shallow-water RK4 steps/s through ``Simulation.from_config``
    (backend auto: the fused kernel K1 on CUDA);
    grid_points_per_second = grid^2 x steps/s."""

    name = "weather"
    INNER = 5  # x num_steps steps a repeat: ~29 ms at 512^2 on an H100

    def __init__(self, grid_size: int = 512, num_steps: int = 100,
                 model: str = "shallow_water", dt: float = 0.005,
                 device="cuda", **kw):
        super().__init__(device, grid_size=grid_size, num_steps=num_steps,
                         model=model, **kw)
        self.grid_size = grid_size
        self.num_steps = num_steps
        self.model = model
        self.dt = dt

    def setup(self):
        from njw_tpu_torch.weather import SimConfig, Simulation

        cfg = SimConfig(model=self.model, grid_width=self.grid_size,
                        grid_height=self.grid_size, dt=self.dt,
                        coriolis_f=1e-4, device=str(self.device))
        ic = "vortex" if self.model != "primitive" else "baroclinic"
        kw = {"strength": 2.0} if self.model != "primitive" else {}
        return Simulation.from_config(cfg, ic, **kw)

    def execute(self, sim, repeats: int = 1):
        sim.step(self.num_steps * self.INNER * repeats)
        return self.num_steps * self.INNER, "steps/s", {
            "grid_points_per_second_factor": self.grid_size ** 2,
            "backend": sim.stepper.name,
            "steps_per_repeat": self.num_steps * self.INNER,
        }


class NBodyBenchmark(WorkloadBenchmark):
    """Leapfrog N-body interactions/s."""

    name = "nbody"
    INNER = 3  # x num_steps steps a repeat: ~27 ms at 4096 bodies

    def __init__(self, num_particles: int = 4096, num_steps: int = 10,
                 device="cuda", **kw):
        super().__init__(device, num_particles=num_particles,
                         num_steps=num_steps, **kw)
        self.n = num_particles
        self.num_steps = num_steps

    def setup(self):
        from njw_tpu_torch.nbody import NBodySimulation, create_random_system

        return NBodySimulation(create_random_system(self.n,
                                                    device=self.device),
                               integrator="leapfrog", dt=0.001)

    def execute(self, sim, repeats: int = 1):
        sim.step(self.num_steps * self.INNER * repeats)
        return self.n * self.n * self.num_steps * self.INNER, \
            "interactions/s", {"steps_per_repeat":
                               self.num_steps * self.INNER}


class MDBenchmark(WorkloadBenchmark):
    """Velocity-Verlet LJ fluid atom-steps/s."""

    name = "molecular_dynamics"
    INNER = 1  # x num_steps steps a repeat: ~80 ms at 1000 atoms

    def __init__(self, num_atoms: int = 1000, num_steps: int = 50,
                 device="cuda", **kw):
        super().__init__(device, num_atoms=num_atoms, num_steps=num_steps,
                         **kw)
        self.n = num_atoms
        self.num_steps = num_steps

    def setup(self):
        from njw_tpu_torch.md import MDSimulation, create_lj_fluid

        state, topo, lj = create_lj_fluid(self.n, T0=1.0, device=self.device)
        return MDSimulation(state, topo, lj, dt=0.002)

    def execute(self, sim, repeats: int = 1):
        sim.step(self.num_steps * self.INNER * repeats)
        return self.n * self.num_steps * self.INNER, "atom-steps/s", {
            "steps_per_repeat": self.num_steps * self.INNER}


class SignalBenchmark(WorkloadBenchmark):
    """FIR batch throughput: ``FIRFilter(num_taps)`` applied in a chain
    (y -> x) to a (batch, num_samples) signal; at the defaults each
    application is one launch of the banded-product kernel K7. The last
    application's output is kept in ``self.output``."""

    name = "signal"
    INNER = 400  # applications a repeat: ~25 ms at 16 x 10^6 samples

    def __init__(self, num_samples: int = 1_000_000, num_taps: int = 101,
                 batch: int = 16, device="cuda", **kw):
        super().__init__(device, num_samples=num_samples, num_taps=num_taps,
                         batch=batch, **kw)
        self.n = num_samples
        self.taps = num_taps
        self.batch = batch
        self.output = None

    def setup(self):
        from njw_tpu_torch.signal import FIRFilter

        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((self.batch, self.n))
                             .astype(np.float32)).to(self.device)
        return (x, FIRFilter(num_taps=self.taps, cutoff=0.25,
                             device=self.device))

    def execute(self, state, repeats: int = 1):
        x, filt = state
        y = x
        for _ in range(self.INNER * repeats):
            y = filt.apply(y)
        self.sync()
        self.output = y
        return self.INNER * self.batch * self.n, "samples/s", {
            "taps": self.taps, "applications_per_repeat": self.INNER}


class MedicalBenchmark(WorkloadBenchmark):
    """Filtered back-projection throughput on the suite's disk phantom.
    The last reconstruction is kept in ``self.output``."""

    name = "medical"
    INNER = 24  # reconstructions a repeat: ~26 ms at 256^2 x 180 angles

    def __init__(self, image_size: int = 256, num_angles: int = 180,
                 device="cuda", **kw):
        super().__init__(device, image_size=image_size,
                         num_angles=num_angles, **kw)
        self.size = image_size
        self.num_angles = num_angles
        self.output = None

    def setup(self):
        from njw_tpu_torch.medical import radon
        from njw_tpu_torch.medical.main_paths import disk_phantom

        angles = np.linspace(0, np.pi, self.num_angles, endpoint=False)
        return (radon(disk_phantom(self.size), angles, device=self.device),
                angles)

    def execute(self, state, repeats: int = 1):
        from njw_tpu_torch.medical import filtered_backprojection

        sino, angles = state
        for _ in range(self.INNER * repeats):
            rec = filtered_backprojection(sino, angles)
        self.sync()
        self.output = rec
        return self.INNER * self.size * self.size * self.num_angles, \
            "px-angles/s", {"reconstructions_per_repeat": self.INNER}


class GeospatialBenchmark(WorkloadBenchmark):
    """Terrain derivatives + a viewshed from the centre on the suite's
    DEM (a gaussian hill plus noise). The last pipeline's outputs are kept
    in ``self.output``."""

    name = "geospatial"
    INNER = 20  # pipelines a repeat: ~26 ms at 512^2 on an H100

    def __init__(self, dem_size: int = 512, device="cuda", **kw):
        super().__init__(device, dem_size=dem_size, **kw)
        self.size = dem_size
        self.output = None

    def setup(self):
        from njw_tpu_torch.geospatial.main_paths import suite_dem

        return torch.from_numpy(suite_dem(self.size)).to(self.device)

    def execute(self, dem, repeats: int = 1):
        from njw_tpu_torch.geospatial import terrain_derivatives, viewshed

        src = (self.size // 2, self.size // 2)
        for _ in range(self.INNER * repeats):
            out = (terrain_derivatives(dem), viewshed(dem, src, n_samples=64))
        self.sync()
        self.output = out
        return self.INNER * self.size * self.size, "cells/s", {
            "pipelines_per_repeat": self.INNER}


class BenchmarkSuite:
    """Registry and runner; every benchmark runs on ``device``."""

    DEFAULT = {
        "weather": WeatherBenchmark,
        "nbody": NBodyBenchmark,
        "molecular_dynamics": MDBenchmark,
        "signal": SignalBenchmark,
        "medical": MedicalBenchmark,
        "geospatial": GeospatialBenchmark,
    }

    def __init__(self, output_dir: str = "./benchmark_results",
                 device="cuda"):
        self.output_dir = output_dir
        self.device = require_device(device)
        self.registry: dict[str, Callable] = dict(self.DEFAULT)
        self.results: list[BenchmarkResult] = []

    def register(self, name: str, factory: Callable):
        self.registry[name] = factory
        return self

    def run_benchmark(self, name: str, cost_model=None,
                      **params) -> BenchmarkResult:
        try:
            factory = self.registry[name]
        except KeyError:
            raise ValueError(
                f"unknown benchmark {name!r}; available: "
                f"{sorted(self.registry)}") from None
        result = factory(device=self.device, **params).run()
        if cost_model is not None:
            result.calculate_cost_metrics(cost_model)
        self.results.append(result)
        return result

    def run_all(self, names: Optional[list[str]] = None, cost_model=None,
                params: Optional[dict] = None) -> list[BenchmarkResult]:
        params = params or {}
        for name in names or list(self.registry):
            self.run_benchmark(name, cost_model, **params.get(name, {}))
        return self.results

    def save_results(self, path: Optional[str] = None) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        path = path or os.path.join(self.output_dir, "results.json")
        with open(path, "w") as fh:
            json.dump([r.to_dict() for r in self.results], fh, indent=2)
        return path

    @classmethod
    def load_results(cls, path: str) -> list[BenchmarkResult]:
        with open(path) as fh:
            return [BenchmarkResult.from_dict(d) for d in json.load(fh)]

    def generate_reports(self, **kw) -> str:
        from njw_tpu_torch.bench.report import generate_report

        os.makedirs(self.output_dir, exist_ok=True)
        return generate_report(self.results, self.output_dir, **kw)
