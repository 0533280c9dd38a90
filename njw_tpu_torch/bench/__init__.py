"""Benchmark suite, cost models, reports (counterpart of
``njw_tpu.bench``).

  suite.py    BenchmarkResult (the JAX fields), the six workloads
              (weather, nbody, molecular_dynamics, signal, medical,
              geospatial) on the port's entry points, BenchmarkSuite
  cost.py     cost models and ``load_cost_model`` on configs/*.yaml
  report.py   PNG charts and an HTML page
  scaling.py  the sharded-SWE throughput sweep over shard counts, the
              halo-overlap efficiency and the config-5 mesh-shape sweep,
              on a ``LocalMesh`` of the caller's device

CLI: ``python -m njw_tpu_torch.bench --all [--device cpu]``.
"""
from njw_tpu_torch.bench.suite import (
    BenchmarkResult, WorkloadBenchmark, BenchmarkSuite,
    WeatherBenchmark, NBodyBenchmark, MDBenchmark, SignalBenchmark,
    MedicalBenchmark, GeospatialBenchmark,
)
from njw_tpu_torch.bench.cost import (
    ComputeEnvironment, CostModel, OnPremTPUCostModel, CloudTPUCostModel,
    CloudGPUCostModel, SlurmClusterCostModel, CostModelFactory,
    compare_costs, load_cost_model,
)
from njw_tpu_torch.bench.report import generate_report
from njw_tpu_torch.bench.scaling import (
    halo_overlap_efficiency, pe_mesh_shape_sweep, swe_scaling_sweep,
)
