"""Benchmark harnesses (counterpart of ``njw_tpu.bench``).

  scaling.py  the sharded-SWE throughput sweep over shard counts, the
              halo-overlap efficiency and the config-5 mesh-shape sweep,
              on a ``LocalMesh`` of the caller's device

The suite, cost models and reports of ``njw_tpu.bench`` are not yet
ported (ROADMAP).
"""
from njw_tpu_torch.bench.scaling import (
    halo_overlap_efficiency, pe_mesh_shape_sweep, swe_scaling_sweep,
)
