"""Utilities (counterpart of ``njw_tpu.utils``).

  pytree.py      ``pytree_dataclass`` / ``static_field``: frozen
                 dataclasses registered with ``torch.utils._pytree``
  config.py      dataclass configs to and from JSON / YAML, CLI overrides
  profiling.py   ``trace`` (torch.profiler), ``time_jitted``, ``Timer``,
                 ``OpStats``
  netcdf3.py     a pure-Python classic NetCDF-3 writer and reader
  checkpoint.py  save and load a state (or a Simulation) as one npz, in
                 the JAX package's file format; sharded states through
                 ``torch.distributed.checkpoint``, each rank its shards
"""
from njw_tpu_torch.utils.pytree import pytree_dataclass, static_field
